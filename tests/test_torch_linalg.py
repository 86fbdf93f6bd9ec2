"""repro_torch.linalg's block operations and BLAS-3 against repro.linalg on
the same numpy inputs, on the CPU.

Tolerances, and why they are not all bitwise:

* ``pivot_argmax``: exact, ties included (both return the first maximal
  index).
* ``gemm`` and ``syrk``: bitwise. Each is one emulated GEMM per block pair,
  and the port's GEMMs are bitwise equal to the reference's.
* ``solve_triangular``: rtol 1e-13 normwise. The reference's diagonal-block
  solve (``repro.linalg.blocks._solve_tri_jit``) is a ``lax.scan`` whose
  body reduces ``jnp.sum(strict[i][:, None] * x, axis=0)``; XLA lowers that
  reduction inside the scan in an order that neither ``torch.sum`` nor a
  sequential sum reproduces (a standalone ``jnp.sum`` of the same expression
  does match a sequential sum). So each solved row may differ in its last
  bits, and the blocked solves built on it (``trsm``, ``cholesky`` and
  ``cholesky_solve``) are held to rtol 1e-12 normwise: the measured
  differences are ~5e-16.
* Within the port, the kernel route ('+pallas', whose plain versions run on
  CPU tensors) and the core route give the same factorization bit for bit.
"""
import math

import numpy as np
import pytest

from repro.linalg import blas3 as jax_blas3
from repro.linalg import blocks as jax_blocks
from repro.linalg import cholesky as jax_cholesky
from repro.linalg import cholesky_solve as jax_cholesky_solve
from repro.precision import parse_policy as jax_parse_policy
from repro.testing import graded_matrix, lognormal_matrix
from repro_torch import linalg
from repro_torch.kernels import fused
from repro_torch.linalg import blocks
from repro_torch.precision import parse_policy

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
#: The parity tests' policy: 7 moduli (6 square, 1 Karatsuba: both
#: residue-product schedules). Port and reference run the same policy, so
#: what they are held to does not depend on the count, and each GEMM shape
#: costs the reference a jit compile that grows with it. The HPL path at
#: the default moduli (LU, its TRSM folds and trailing GEMMs, the solve) is
#: held against the reference by tests/test_torch_linalg_factor.py and
#: tests/test_torch_hpl.py. The trsm, syrk and Cholesky tests share their
#: block pairings' shapes ((32 x 32) @ (32 x 32) and (32 x 32) @ (32 x 1)),
#: so the reference compiles each once a mode.
SPEC = "ozaki2-fp8/{mode}@7"


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("col", [
    [0.5, -3.0, 3.0, 2.0],          # a tie of magnitudes: the first wins
    [1.0, 2.0, -2.0, 2.0, 0.0],     # a three-way tie past the middle
    [0.0, 0.0, 0.0],                # all zero: offset 0, magnitude 0
    [-7.0],
    [1e-300, -1e-300, 2e-300],
])
def test_pivot_argmax_exact_with_ties(col):
    assert blocks.pivot_argmax(np.array(col), device=CPU) == jax_blocks.pivot_argmax(col)


def test_pivot_argmax_random_segments(rng):
    col = rng.random(37) - 0.5
    col[[5, 30]] = 0.75  # a tie at the maximum
    for j in (0, 6, 20, 36):
        assert blocks.pivot_argmax(col[j:], device=CPU) == jax_blocks.pivot_argmax(col[j:])


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit_diag", [True, False])
def test_solve_triangular_matches_reference(rng, lower, unit_diag):
    """rtol 1e-13 normwise: the reference's scan body sums each row in XLA's
    order, which torch does not reproduce (module docstring)."""
    n = 64
    t = rng.random((n, n)) - 0.5 + n * np.eye(n)
    rhs = rng.random((n, 5)) - 0.5
    for r in (rhs, rhs[:, 0]):
        want = jax_blocks.solve_triangular(t, r, lower=lower, unit_diag=unit_diag)
        got = blocks.solve_triangular(t, r, lower=lower, unit_diag=unit_diag, device=CPU)
        assert got.shape == want.shape
        assert rel(got, want) <= 1e-13


def test_solve_triangular_rejects_zero_diagonal():
    t = np.eye(4)
    t[2, 2] = 0.0
    with pytest.raises(np.linalg.LinAlgError):
        blocks.solve_triangular(t, np.ones(4), lower=True, device=CPU)
    np.testing.assert_array_equal(  # a unit diagonal never reads it
        blocks.solve_triangular(t, np.ones(4), lower=True, unit_diag=True, device=CPU),
        np.ones(4))


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_gemm_bitwise(rng, mode):
    a, b, c = rng.random((60, 50)) - 0.5, rng.random((50, 40)) - 0.5, rng.random((60, 40))
    spec = SPEC.format(mode=mode)
    want = jax_blas3.gemm(a, b, spec, alpha=-1.0, beta=1.0, c=c)
    np.testing.assert_array_equal(
        linalg.gemm(a, b, spec, alpha=-1.0, beta=1.0, c=c, device=CPU), want)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_trsm_matches_reference(rng, mode):
    """The LU-style unit-lower solve at n = 96, block 32 (three block rows,
    folded through cached rhs plans), rtol 1e-12 normwise. The ragged and
    right/transposed solves run inside tests/test_torch_linalg_factor.py's
    LU and Cholesky."""
    spec = SPEC.format(mode=mode)
    unit_lower = np.tril(rng.random((96, 96)) - 0.5, -1) + np.eye(96)
    b = rng.random((96, 1)) - 0.5
    want = jax_blas3.trsm(unit_lower, b, spec, unit_diag=True, block=32)
    got = linalg.trsm(unit_lower, b, spec, unit_diag=True, block=32, device=CPU)
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_syrk_bitwise(rng, mode):
    """Every tile is one plan x plan pairing (64 rows, block 32)."""
    a, c = rng.random((64, 32)) - 0.5, rng.random((64, 64))
    spec = SPEC.format(mode=mode)
    want = jax_blas3.syrk(a, spec, alpha=-1.0, beta=1.0, c=c, block=32)
    np.testing.assert_array_equal(
        linalg.syrk(a, spec, alpha=-1.0, beta=1.0, c=c, block=32, device=CPU), want)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_cholesky_and_solve_match_reference(rng, mode):
    spec = SPEC.format(mode=mode)
    g = rng.random((96, 96)) - 0.5
    spd = g @ g.T + 96 * np.eye(96)
    want = jax_cholesky(spd, spec, block=32)
    got = linalg.cholesky(spd, spec, block=32, device=CPU)
    assert rel(got, want) <= 1e-12
    b = rng.random(96) - 0.5
    x = linalg.cholesky_solve(got, b, spec, block=32, device=CPU)
    assert rel(x, jax_cholesky_solve(want, b, spec, block=32)) <= 1e-12


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_kernel_route_factorization_bitwise_equals_core(rng, mode):
    """lu_factor + lu_solve on '+pallas' (the plain versions of K2 in fast
    mode, of K1 in accurate mode) equal '+core' bit for bit; each trailing
    update and each TRSM fold is one prepared pairing, one kernel call."""
    n, blk = 96, 32
    a, b = rng.random((n, n)) - 0.5, rng.random(n) - 0.5
    k1, k2 = fused.ozmm_fused_raw_ref.calls, fused.ozmm_fused_parts_ref.calls
    lu, perm = linalg.lu_factor(a, f"ozaki2-fp8/{mode}+pallas", block=blk, device=CPU)
    x = linalg.lu_solve(lu, perm, b, f"ozaki2-fp8/{mode}+pallas", block=blk, device=CPU)
    nb = n // blk
    pairings = (nb - 1) + nb * (nb - 1)  # trailing updates + the solve's folds
    want = (0, pairings) if mode == "fast" else (pairings, 0)
    assert (fused.ozmm_fused_raw_ref.calls - k1, fused.ozmm_fused_parts_ref.calls - k2) == want
    lu_c, perm_c = linalg.lu_factor(a, f"ozaki2-fp8/{mode}+core", block=blk, device=CPU)
    np.testing.assert_array_equal(perm, perm_c)
    np.testing.assert_array_equal(lu, lu_c)
    np.testing.assert_array_equal(
        x, linalg.lu_solve(lu_c, perm_c, b, f"ozaki2-fp8/{mode}+core", block=blk, device=CPU))


@pytest.mark.parametrize("case,mode,target_log2", [
    ("lognormal", "fast", -22), ("lognormal", "accurate", -44),
    ("graded", "fast", -40), ("graded", "accurate", -36)])
def test_resolve_for_picks_the_reference_num_moduli(rng, case, mode, target_log2):
    """The cases of tests/precision/test_resolver.py: the port's resolve_for
    picks the reference's modulus count, and refine_solve(target_rel_err=)
    factors under it."""
    if case == "lognormal":
        a = lognormal_matrix(rng, (48, 384), 2.0)
        b = lognormal_matrix(rng, (384, 40), 2.0)
    else:
        a, b = graded_matrix(rng, 192, 8.0), graded_matrix(rng, 192, 4.0)
    t = 2.0 ** target_log2
    spec = f"ozaki2-fp8/{mode}"
    want = jax_parse_policy(spec).resolve_for(a, b, target_rel_err=t)
    assert parse_policy(spec).resolve_for(a, b, target_rel_err=t).spec == want.spec
    sq = a[:, :48] if case == "lognormal" else a[:64, :64] + 64 * np.eye(64)
    _, info = linalg.refine_solve(sq, np.ones(sq.shape[0]), spec, target_rel_err=t,
                                  refine_steps=1, block=32, device=CPU)
    assert info["policy"] == jax_parse_policy(spec).resolve_for(sq, sq, target_rel_err=t).spec
    assert math.isfinite(info["residuals"][-1])
