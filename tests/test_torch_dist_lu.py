"""repro_torch.linalg.dist (block-cyclic grid, LU, triangular solves, HPL)
against repro.linalg.dist on the same numpy inputs, on the CPU.

The reference runs with ``collectives="host"``: its mesh collectives do not
run under this JAX (tests/linalg/test_dist_lu.py's subprocess and 1 x 1
cases fail), and its host fallbacks have the same semantics as the port's
mesh collectives, which run on every grid (the CPU's one device repeated
over the ranks). Each reference run is computed once for the module, at
block 16 and sizes whose rank blocks share a few shapes (each shape is a
JAX compile).

Tolerances: ``lu_factor_dist`` under ozaki2-fp8/fast bitwise equal to the
reference's (pivots, factors and the communication stats: the port's lower
diagonal solve sums in the reference's order on blocks of up to 32 rows)
and to the port's single-device ``lu_factor``; ``lu_solve_dist`` rtol
1e-12 normwise against the reference (its upper solves sum in another
order, tests/test_torch_linalg.py) and bitwise against the single-device
``lu_solve``; ``run_hpl_dist`` the HPL gate (scaled residual <= 16) and the
reference's result under native.
"""
import numpy as np
import pytest
import torch

from repro.core.distributed import argmax_allreduce_host as ref_argmax_host
from repro.linalg.dist import BlockCyclicMatrix as RefBCM
from repro.linalg.dist import ProcessGrid as RefGrid
from repro.linalg.dist import lu_factor_dist as ref_lu_factor_dist
from repro.linalg.dist import lu_solve_dist as ref_lu_solve_dist
from repro.linalg.dist import run_hpl_dist as ref_run_hpl_dist
from repro_torch import linalg
from repro_torch.linalg import dist

from _torch_models_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
#: 4 moduli, as the reference's own dist tests: the bits do not depend on
#: the count, and each modulus costs the reference's compiles time.
FAST = "ozaki2-fp8/fast@4"
#: (n, grid, wires): two full-block grids and a ragged n (40 = 16 + 16 + 8).
CASES = [(48, (2, 2), ("plans", "f64")), (48, (4, 1), ("plans",)), (40, (2, 2), ("plans",))]
STAT_KEYS = ("policy", "grid", "n", "block", "panel_wire", "wire_bytes", "f64_bytes",
             "swap_bytes", "panel_bcast_bytes", "pivot_collectives")


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _problem(n: int):
    rng = np.random.default_rng(n)
    return rng.random((n, n)) - 0.5, rng.random((n, 2)) - 0.5


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's host-collective factorization (both wires) and its
    solve, per case, under ozaki2-fp8/fast at block 16."""
    out = {}
    for n, grid, wires in CASES:
        a, b = _problem(n)
        for wire in wires:
            lu, perm, stats = ref_lu_factor_dist(a, FAST, grid=RefGrid(*grid, collectives="host"),
                                                 block=16, panel_wire=wire)
            x, sstats = ref_lu_solve_dist(lu, perm, b, FAST, panel_wire=wire)
            out[n, grid, wire] = (lu.to_global(), perm, stats, x, sstats)
    return out


def test_parse_grid_and_owner_maps():
    assert dist.parse_grid("2x2") == (2, 2) and dist.parse_grid("1x4") == (1, 4)
    for bad in ("2by2", "0x2"):
        with pytest.raises(ValueError):
            dist.parse_grid(bad)
    g, ref = dist.ProcessGrid(2, 3, device=CPU), RefGrid(2, 3)
    for i in range(7):
        assert (g.row_owner(i), g.col_owner(i)) == (ref.row_owner(i), ref.col_owner(i))
        for p in range(3):
            assert g.local_row_blocks(i, p % 2) == ref.local_row_blocks(i, p % 2)
            assert g.local_col_blocks(i, p) == ref.local_col_blocks(i, p)


@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 1), (2, 3)])
def test_layout_matches_reference(rng, grid):
    """Packing, index maps, ragged tails and row swaps (bytes included) as
    the reference's, at n = 250, block 64 (the last block 58 wide)."""
    n, b = 250, 64
    a = rng.standard_normal((n, n))
    d = dist.BlockCyclicMatrix.from_global(a, dist.ProcessGrid(*grid, device=CPU), b)
    r = RefBCM.from_global(a, RefGrid(*grid), b)
    np.testing.assert_array_equal(d.to_global(), a)
    for key, loc in r.locals_.items():
        np.testing.assert_array_equal(d.local(*key), loc)
    for p in range(grid[0]):
        np.testing.assert_array_equal(d.global_rows(p), r.global_rows(p))
        for blk in range(5):
            assert d.local_row_tail(p, blk) == r.local_row_tail(p, blk)
    for q in range(grid[1]):
        np.testing.assert_array_equal(d.global_cols(q), r.global_cols(q))
        for blk in range(5):
            assert d.local_col_tail(q, blk) == r.local_col_tail(q, blk)
    for i, j in ((3, 97), (5, 69), (0, 249), (200, 201)):
        assert d.swap_rows(i, j) == r.swap_rows(i, j)
    np.testing.assert_array_equal(d.to_global(), r.to_global())


def test_grid_collectives_modes():
    """Every grid has a mesh: on the CPU, one distinct device, the entry
    device repeated over the ranks; broadcasts reach every other rank of a
    row or column, and the mesh collective picks the reference's host
    collective's pivot, ties included."""
    cpu = torch.device(CPU)
    two = dist.ProcessGrid(2, 2, device=CPU)
    assert two.mesh.shape == {"row": 2, "col": 2}
    assert set(two.mesh.devices.flat) == {cpu} and two.device(1, 1) == cpu
    assert two.row_devices(0, skip=1) == [cpu] and two.col_devices(1) == [cpu, cpu]
    assert dist.ProcessGrid(4, 1, device=CPU).row_devices(2, skip=0) == []
    one = dist.ProcessGrid(1, 1, device=CPU)
    assert one.mesh.shape == {"row": 1, "col": 1}
    assert one.argmax_allreduce([2.5], [7]) == ref_argmax_host([2.5], [7]) == (2.5, 7)
    assert two.argmax_allreduce([2.0, 2.0], [30, 7]) == ref_argmax_host([2.0, 2.0], [30, 7])
    with pytest.raises(ValueError, match="runs on cpu"):
        dist.lu_factor_dist(np.eye(4), FAST, grid=two, device="meta")


@pytest.mark.parametrize("n,grid,wire", [(n, g, w) for n, g, ws in CASES for w in ws])
def test_lu_factor_dist_fast_bitwise(ref_runs, n, grid, wire):
    """ozaki2-fp8/fast: pivots, factors and the wire/swap/pivot accounting
    bitwise the reference's; and the factors the port's single-device
    lu_factor's, bit for bit."""
    a, _ = _problem(n)
    lu_want, perm_want, stats_want, _, _ = ref_runs[n, grid, wire]
    lu, perm, stats = dist.lu_factor_dist(a, FAST, grid=grid, block=16, panel_wire=wire,
                                          device=CPU)
    np.testing.assert_array_equal(perm, perm_want)
    np.testing.assert_array_equal(lu.to_global(), lu_want)
    assert {k: stats[k] for k in STAT_KEYS} == {k: stats_want[k] for k in STAT_KEYS}
    assert stats["mesh_collectives"] is True
    lu_s, perm_s = linalg.lu_factor(a, FAST, block=16, device=CPU)
    np.testing.assert_array_equal(perm, perm_s)
    np.testing.assert_array_equal(lu.to_global(), lu_s)


@pytest.mark.parametrize("n,grid,wires", CASES)
def test_lu_solve_dist_matches_reference(ref_runs, n, grid, wires):
    """Each wire: within rtol 1e-12 of the reference's distributed solve,
    with its bytes on the wire; bitwise the port's single-device lu_solve
    (fast mode: same block pairings, same fold order)."""
    a, b = _problem(n)
    lu, perm, _ = dist.lu_factor_dist(a, FAST, grid=grid, block=16, device=CPU)
    lu_s, perm_s = linalg.lu_factor(a, FAST, block=16, device=CPU)
    x_s = linalg.lu_solve(lu_s, perm_s, b, FAST, block=16, device=CPU)
    for wire in wires:
        _, _, _, x_want, sstats_want = ref_runs[n, grid, wire]
        x, sstats = dist.lu_solve_dist(lu, perm, b, FAST, panel_wire=wire)
        assert rel(x, x_want) <= 1e-12
        np.testing.assert_array_equal(x, x_s)
        for key in ("panel_wire", "wire_bytes", "f64_bytes", "solve_bcasts"):
            assert sstats[key] == sstats_want[key], key
    with pytest.raises(ValueError, match="rhs rows"):
        dist.lu_solve_dist(lu, perm, b[:-1], FAST)


def test_run_hpl_dist_native_matches_reference():
    """n = 32, block 16, 2 x 2 (one block a rank) under native (raw f64 on
    the wire): the reference's result dict, keys and bytes (its
    ``mesh_collectives`` is False: the reference ran its host fallback,
    the port its mesh), and its residual within a factor of 4."""
    want = ref_run_hpl_dist(32, "native", grid=RefGrid(2, 2, collectives="host"), block=16)
    got = dist.run_hpl_dist(32, "native", grid=(2, 2), block=16, device=CPU)
    assert set(got) == set(want)
    assert got["passed"] and got["scaled_residual"] <= linalg.HPL_THRESHOLD
    assert got["mesh_collectives"] and not want["mesh_collectives"]
    for key in ("n", "block", "grid", "scheme", "mode", "policy", "panel_wire", "refine_steps",
                "wire_bytes", "f64_bytes", "swap_bytes", "epilogue_wire_bytes",
                "epilogue_f64_bytes"):
        assert got[key] == want[key], key
    assert want["scaled_residual"] / 4 <= got["scaled_residual"] <= 4 * want["scaled_residual"]


def test_run_hpl_dist_accurate():
    """ozaki2-fp8/accurate (plans on the wire, K1's plain version a rank
    GEMM), n = 32, 2 x 2: the HPL gate, the residual within a factor of 4
    of the port's single-device run_hpl (which tests/test_torch_hpl.py
    holds against the reference's), the solve within rtol 1e-12 of
    numpy's, and the distributed norms (the reference's accurate run costs
    ~20 s of jit compiles at this size)."""
    spec = "ozaki2-fp8/accurate"
    got = dist.run_hpl_dist(32, spec, grid=(2, 2), block=16, device=CPU)
    single = linalg.run_hpl(32, spec, block=16, device=CPU)
    assert got["passed"] and got["panel_wire"] == "plans" and got["wire_bytes"] > 0
    assert single["scaled_residual"] / 4 <= got["scaled_residual"] <= 4 * single["scaled_residual"]
    a, b = linalg.hpl_matrix(32)
    lu, perm, _ = dist.lu_factor_dist(a, spec, grid=(2, 2), block=16, device=CPU)
    x, _ = dist.lu_solve_dist(lu, perm, b, spec)
    assert rel(x, np.linalg.solve(a, b)) <= 1e-12
    a_dist = dist.BlockCyclicMatrix.from_global(a, dist.ProcessGrid(2, 2, device=CPU), 16)
    assert dist.dist_inf_norm(a_dist) == pytest.approx(np.linalg.norm(a, np.inf), rel=1e-14)
    y = np.random.default_rng(3).random(32) - 0.5
    assert rel(dist.dist_residual(a_dist, y, b), a @ y - b) <= 1e-14
