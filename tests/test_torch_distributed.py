"""repro_torch's plan wire format, sharded emulated GEMMs, pivot collectives,
panel broadcasts and gradient compression against the JAX reference on the
same numpy inputs, on the CPU.

* Wire: a reference plan's ``plan_to_wire`` leaves, received by the port's
  ``plan_from_wire``, execute bitwise equal to the reference's
  ``ozmm_prepared`` (fp8-hybrid with a Karatsuba modulus, Karatsuba, int8;
  fast and accurate); headers and ``wire_bytes`` equal the reference's.
* Sharded GEMMs on a 2 x 4 mesh of repeated CPU devices at the reference's
  script shapes (64 x 512 @ 512 x 64; tests/core/test_distributed.py, which
  no longer runs under this JAX): k-sharded fast bitwise equal to the
  reference's single-device ``ozmm``, mn-sharded accurate bitwise equal to
  the reference's ``ozmm_prepared`` on each block, k-sharded accurate within
  the reference's two gates; shard by shard, the kernel route's plain
  versions (K1/K2, K6 + K3/K4) bitwise equal to the core route.
* Collectives and compression: bitwise (the reference's psum over replicas
  evaluated under ``jax.vmap`` with an axis name).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.distributed import argmax_allreduce_host as ref_argmax_host
from repro.core.gemm import ozmm as ref_ozmm
from repro.core.moduli import make_moduli_set as ref_moduli_set
from repro.core.plan import ozmm_prepared as ref_ozmm_prepared
from repro.core.plan import plan_to_wire as ref_plan_to_wire
from repro.core.plan import quantize_matrix as ref_quantize_matrix
from repro.core.plan import wire_bytes as ref_wire_bytes
from repro.optim import compress as ref_compress
from repro_torch import kernels as kn
from repro_torch import ozmm
from repro_torch.core import distributed as dist
from repro_torch.core import plan as tplan
from repro_torch.core.moduli import make_moduli_set
from repro_torch.launch import make_grid_mesh, make_mesh
from repro_torch.optim import compress

from _torch_models_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
#: (family, moduli): the hybrid at its default 12 (6 square, 6 Karatsuba).
WIRE_CASES = [("fp8-hybrid", 12), ("fp8-karatsuba", 3), ("int8", 4)]


def as_tensor(x) -> torch.Tensor:
    """A reference leaf as a tensor (e4m3 through its bytes)."""
    x = np.array(x)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(x)


def leaf_bytes(t: torch.Tensor) -> np.ndarray:
    """A port leaf as comparable values (e4m3 as its bytes)."""
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


@pytest.fixture(scope="module")
def wire_refs():
    """Per (family, moduli, mode): the reference's wire of an lhs and an rhs
    plan and its ozmm_prepared of the pair, at the mn-sharded test's block
    shapes (each shape and policy is one JAX compile, which the hybrid's
    accurate case shares with that test)."""
    rng = np.random.default_rng(11)
    a = (rng.random((32, 512)) - 0.5) * np.exp(rng.standard_normal((32, 512)))
    b = (rng.random((512, 16)) - 0.5) * np.exp(rng.standard_normal((512, 16)))
    out = {}
    for family, n in WIRE_CASES:
        ms = ref_moduli_set(family, n)
        for mode in ("fast", "accurate"):
            qa = ref_quantize_matrix(jnp.asarray(a), "lhs", ms, mode=mode)
            qb = ref_quantize_matrix(jnp.asarray(b), "rhs", ms, mode=mode)
            wires = [ref_plan_to_wire(q) for q in (qa, qb)]
            out[family, mode] = (a, b, [(h, [np.asarray(x) for x in lv]) for h, lv in wires],
                                 [ref_wire_bytes(lv) for _, lv in wires],
                                 np.asarray(ref_ozmm_prepared(qa, qb)))
    return out


@pytest.mark.parametrize("family,n", WIRE_CASES)
@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_reference_wire_executes_bitwise(wire_refs, family, n, mode):
    """The reference's wire leaves rebuild, in the port, plans whose pairing
    is the reference's ozmm_prepared bit for bit (on the core route and on
    the kernel route's plain versions); the port's own wire of the same
    operands has the reference's header and byte count, and its round trip
    keeps the bits."""
    a, b, wires, nbytes, want = wire_refs[family, mode]
    got = [tplan.plan_from_wire(h, [as_tensor(x) for x in lv]) for h, lv in wires]
    np.testing.assert_array_equal(tplan.ozmm_prepared(*got).numpy(), want)
    np.testing.assert_array_equal(kn.ozmm_pallas_fused_prepared(*got).numpy(), want)
    ms = make_moduli_set(family, n)
    own = [tplan.quantize_matrix(torch.from_numpy(x), role, ms, mode=mode)
           for x, role in ((a, "lhs"), (b, "rhs"))]
    for q, (ref_header, ref_leaves), ref_n in zip(own, wires, nbytes):
        header, leaves = tplan.plan_to_wire(q)
        assert header == ref_header
        assert tplan.wire_bytes(leaves) == ref_n
        for t, x in zip(leaves, ref_leaves):
            np.testing.assert_array_equal(leaf_bytes(t), leaf_bytes(as_tensor(x)))
    round_trip = [tplan.plan_from_wire(*tplan.plan_to_wire(q)) for q in own]
    np.testing.assert_array_equal(tplan.ozmm_prepared(*round_trip).numpy(), want)


def test_wire_version_guard_and_e4m3_bytes():
    q = tplan.quantize_matrix(torch.ones((4, 8), dtype=torch.float64), "lhs",
                              make_moduli_set("fp8-hybrid", 7), mode="fast")
    header, leaves = tplan.plan_to_wire(q)
    assert header["parts_per_modulus"] == (2,) * 7  # the Karatsuba hs stays home
    assert all(t.dtype == torch.float8_e4m3fn for t in leaves[1:])
    assert tplan.wire_bytes(leaves) == 4 * 4 + 14 * 4 * 8
    with pytest.raises(ValueError, match="version mismatch"):
        tplan.plan_from_wire(dict(header, version=tplan.PLAN_WIRE_VERSION + 1), leaves)


def test_broadcasts_place_and_count(rng):
    """broadcast_plan: one payload, a plan per receiver device, each pairing
    bitwise equal to the owner's; broadcast_f64: the f64 block's bytes."""
    ms = make_moduli_set("fp8-hybrid", 7)
    x = torch.from_numpy(rng.random((16, 24)) - 0.5)
    y = tplan.quantize_matrix(torch.from_numpy(rng.random((24, 8)) - 0.5), "rhs", ms, mode="fast")
    owner = tplan.quantize_matrix(x, "lhs", ms, mode="fast")
    want = tplan.ozmm_prepared(owner, y)
    for devices in ((), (CPU, CPU)):
        recv, payload = dist.broadcast_plan(owner, devices)
        assert len(recv) == len(devices)
        assert payload == tplan.wire_bytes(tplan.plan_to_wire(owner)[1])
        for q in recv:
            assert q.x is None
            assert torch.equal(tplan.ozmm_prepared(q, y), want)
    recv, payload = dist.broadcast_f64(x.numpy(), (CPU, CPU, CPU))
    assert payload == x.numel() * 8 and len(recv) == 3
    assert all(torch.equal(r, x) for r in recv)


@pytest.fixture(scope="module")
def sharded_case():
    """The reference script's operands and the reference's single-device
    ozmm in fast mode."""
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((64, 512)), rng.standard_normal((512, 64))
    return a, b, np.asarray(ref_ozmm(jnp.asarray(a), jnp.asarray(b), "ozaki2-fp8/fast"))


def _plain_calls():
    return (kn.quant_residues_plain.calls, kn.fp8_gemm_plain.calls, kn.int8_gemm_plain.calls,
            kn.ozmm_fused_raw_ref.calls, kn.ozmm_fused_parts_ref.calls)


def k_shards_agree(a, b, ranks: int, family: str, num_moduli: int, mode: str) -> None:
    """Every k shard's centred residue products under the global exponents:
    the kernel route (its plain versions here) bitwise the core route."""
    ms = make_moduli_set(family, num_moduli)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    step = a.shape[1] // ranks
    a_sh = [a[:, r * step:(r + 1) * step] for r in range(ranks)]
    b_sh = [b[r * step:(r + 1) * step] for r in range(ranks)]
    lmu, lnu = dist.k_sharded_exponents(a_sh, b_sh, a.shape[1], ms, mode, CPU)
    for xa, xb in zip(a_sh, b_sh):
        for kern, core in zip(dist.k_shard_residues(xa, xb, lmu, lnu, ms, "pallas"),
                              dist.k_shard_residues(xa, xb, lmu, lnu, ms, "core")):
            assert torch.equal(kern, core)


def test_k_sharded_fast_bitwise_equals_reference_ozmm(sharded_case):
    """2 x 4 mesh, k over "model" (4 slices of 128): bitwise the reference's
    unsharded ozmm; each shard's kernel route (K6 twice and 3N K3 products,
    their plain versions here) bitwise its core route."""
    a, b, want = sharded_case
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU)
    np.testing.assert_array_equal(dist.ozmm_k_sharded(a, b, mesh, mode="fast").numpy(), want)
    before = _plain_calls()
    k_shards_agree(a, b, 4, "fp8-hybrid", 12, "fast")
    moved = tuple(y - x for x, y in zip(before, _plain_calls()))
    assert moved == (2 * 4, 3 * 12 * 4, 0, 0, 0)
    assert dist.collective_bytes_per_output_elem("fp8-hybrid", 12, "mn") == 0
    assert dist.collective_bytes_per_output_elem("fp8-hybrid", 12, "k") == 48


def test_k_sharded_accurate_meets_the_reference_gates(sharded_case):
    """The f32 bound partials are summed across shards, which may move a
    scale exponent by one against the unsharded run, so accurate mode is held
    to the reference script's gates: componentwise error < 2^-49 and <= 4x
    the unsharded error (the port's single-device ozmm, which
    tests/test_torch_ozaki2_fp8.py holds bitwise to the reference's); each
    shard's kernel route equals its core route."""
    a, b, _ = sharded_case
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU)
    got = dist.ozmm_k_sharded(a, b, mesh, mode="accurate").numpy()
    ref, denom = a @ b, np.abs(a) @ np.abs(b)
    err = np.max(np.abs(got - ref) / denom)
    unsharded = ozmm(a, b, "ozaki2-fp8/accurate", device=CPU).numpy()
    err_local = np.max(np.abs(unsharded - ref) / denom)
    assert err < 2.0 ** -49, err
    assert err <= 4.0 * max(err_local, 2.0 ** -53), (err, err_local)
    k_shards_agree(a, b, 4, "fp8-hybrid", 12, "accurate")


def test_k_sharded_int8_kernel_route_equals_core(sharded_case):
    """int8, k over 4 ranks: the port's unsharded fast ozmm bit for bit; on
    K4 (its plain version) N products a shard, bitwise the core route."""
    a, b, _ = sharded_case
    mesh = make_mesh((4,), ("model",), devices=CPU)
    got = dist.ozmm_k_sharded(a, b, mesh, family="int8", num_moduli=6)
    assert torch.equal(got, ozmm(a, b, "ozaki2-int8/fast@6", device=CPU))
    before = _plain_calls()
    k_shards_agree(a, b, 4, "int8", 6, "fast")
    assert tuple(y - x for x, y in zip(before, _plain_calls())) == (8, 0, 6 * 4, 0, 0)


def test_mn_sharded_accurate_bitwise_per_block(sharded_case):
    """2 x 4 mesh: each (32 x 512) @ (512 x 16) block is the reference's
    ozmm_prepared of that block's plans, bit for bit; each shard's kernel
    route (pair_exponents + K1's plain version, and fast mode's K2) equals
    its core route."""
    a, b, _ = sharded_case
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU)
    got = dist.ozmm_mn_sharded(a, b, mesh, mode="accurate").numpy()
    ref_ms, ms = ref_moduli_set("fp8-hybrid", 12), make_moduli_set("fp8-hybrid", 12)
    before = _plain_calls()
    for i in range(2):
        for j in range(4):
            rs, cs = slice(32 * i, 32 * (i + 1)), slice(16 * j, 16 * (j + 1))
            qa = ref_quantize_matrix(jnp.asarray(a[rs]), "lhs", ref_ms, mode="accurate")
            qb = ref_quantize_matrix(jnp.asarray(b[:, cs]), "rhs", ref_ms, mode="accurate")
            np.testing.assert_array_equal(got[rs, cs], np.asarray(ref_ozmm_prepared(qa, qb)))
            xa, xb = torch.from_numpy(a[rs]), torch.from_numpy(b[:, cs])
            for mode in ("accurate", "fast"):
                assert torch.equal(dist.mn_shard(xa, xb, ms, mode, "pallas"),
                                   dist.mn_shard(xa, xb, ms, mode, "core"))
    assert tuple(y - x for x, y in zip(before, _plain_calls())) == (0, 0, 0, 8, 8)
    with pytest.raises(ValueError, match="not divisible"):
        dist.ozmm_mn_sharded(a[:63], b, mesh)


@pytest.mark.parametrize("vals,idxs", [
    ([1.0, 3.0], [10, 20]),
    ([2.0, 2.0], [30, 7]),            # a tie: the smaller index wins
    ([0.5, 4.0, 4.0, -1.0], [3, 9, 2, 64]),
    ([-1.0, -1.0, 0.0], [64, 64, 5]),  # empty ranks contribute (-1, n)
])
def test_argmax_allreduce_mesh_and_host(vals, idxs):
    want = ref_argmax_host(vals, idxs)
    mesh = make_grid_mesh(len(vals), 1, devices=CPU)
    assert dist.argmax_allreduce(vals, idxs, mesh, "row") == want
    assert dist.argmax_allreduce_host(vals, idxs) == want
    with pytest.raises(ValueError, match="one candidate per rank"):
        dist.argmax_allreduce(vals[:-1], idxs[:-1], mesh, "row")


def _ref_psum(fn, *stacked):
    """The reference's reduction over replicas: its psum/pmax under
    jax.vmap with the axis name the reference's function names, op by op
    (under jit XLA rewrites the int8 dequantization's arithmetic: an ulp
    away on some elements)."""
    return jax.vmap(fn, axis_name="dp")(*stacked)


@pytest.mark.parametrize("replicas", [2, 3, 4])
def test_compressed_psum_two_steps_equals_reference(replicas):
    """int8 + error feedback over 2-4 replicas, two steps: every replica's
    reduced gradient and carried residual bitwise the reference's."""
    rng = np.random.default_rng(replicas)
    shapes = {"b": (5, 7), "w": (300,)}
    ref_res = {k: jnp.zeros((replicas, *s), jnp.float32) for k, s in shapes.items()}
    efs = [compress.ef_init({k: torch.zeros(s) for k, s in shapes.items()})
           for _ in range(replicas)]
    for _ in range(2):
        g = {k: rng.standard_normal((replicas, *s)).astype(np.float32) for k, s in shapes.items()}
        ref_w, ref_ef = _ref_psum(lambda gg, rr: ref_compress.compressed_psum(
            gg, ref_compress.EFState(rr), "dp"), {k: jnp.asarray(v) for k, v in g.items()},
            ref_res)
        ref_res = ref_ef.residual
        wires, efs = compress.compressed_psum(
            [{k: torch.from_numpy(v[i].copy()) for k, v in g.items()} for i in range(replicas)],
            efs)
        for i in range(replicas):
            for k in shapes:
                np.testing.assert_array_equal(wires[i][k].numpy(), np.asarray(ref_w[k][i]))
                np.testing.assert_array_equal(efs[i].residual[k].numpy(),
                                              np.asarray(ref_res[k][i]))


@pytest.mark.parametrize("replicas", [2, 4])
def test_exact_residue_psum_equals_reference(replicas):
    """The fixed-point mean, bitwise the reference's on every replica, and
    the same whatever the replicas' order."""
    x = (np.random.default_rng(7).standard_normal((replicas, 1000)) * 3).astype(np.float32)
    want = np.asarray(_ref_psum(lambda v: ref_compress.exact_residue_psum(v, "dp"),
                                jnp.asarray(x)))
    got = compress.exact_residue_psum([torch.from_numpy(v.copy()) for v in x])
    for i in range(replicas):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    flipped = compress.exact_residue_psum([torch.from_numpy(v.copy()) for v in x[::-1]])
    assert torch.equal(flipped[0], got[0])
    # the reference's compress_decompress, summed in numpy, is the int8 wire
    g, r = x[0], np.zeros_like(x[0])
    w, nr = ref_compress.compress_decompress(jnp.asarray(g), jnp.asarray(r))
    tw, tnr = compress.compress_decompress(torch.from_numpy(g.copy()), torch.from_numpy(r))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tnr.numpy(), np.asarray(nr))
