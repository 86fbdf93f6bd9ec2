"""K5's f64 mode and K6's f64 entry (repro_torch.kernels) against the JAX
reference on the CPU, through the port's plain versions (what a wrapper
runs on CPU tensors), on the same numpy inputs; and two fixes of
``repro_torch.core``: ``backend_matmul``'s native ``preferred_dtype`` and
the bound GEMM's own f32 precision.

Tolerances: bitwise for the kernels' modules (e4m3 compared as bytes, f64
as values); ``backend_matmul``'s native f32 product to 1e-5 relative to
max |C|: the port and XLA accumulate the same f32 products in different
orders (measured 1.8e-7 for bf16 inputs and 5.5e-7 for f32 on the CPU;
the bf16-rounded product it replaced was 2.0e-3 off)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.gemm import backend_matmul as jax_backend_matmul
from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.kernels import quant_residues_op as jax_quant_residues_op
from repro.kernels import requant_garner_op as jax_requant_garner_op
from repro.kernels.crt_reconstruct.ops import reconstruct_f64 as jax_reconstruct_f64
from repro.testing import lognormal_matrix
from repro_torch import backend_matmul
from repro_torch import kernels as kn
from repro_torch.core import numerics, scaling
from repro_torch.core.moduli import make_moduli_set
from repro_torch.core.plan import pow2_tables

from _torch_threads import one_torch_thread  # noqa: F401

FAMILIES = [("fp8-hybrid", 12), ("fp8-karatsuba", 13), ("int8", 14)]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _as_list(stacks):
    return list(stacks) if isinstance(stacks, tuple) else [stacks]


def _edge_operand(rng, shape):
    """Lognormal values with a zero row, a tiny (1e-300) and a huge (1e300)
    row, a row of normal values near 1e-305 scaled by 2^1050 (past
    ldexp_wide's single-factor range) and signed integers near 2^53. No
    subnormal: XLA on the CPU flushes them (ROADMAP Queue C), so the card's
    tests hold them against the plain version instead."""
    a = lognormal_matrix(rng, shape, 2.0)
    a[0] *= 1e-300
    a[1] *= 1e300
    a[2] = 0.0
    a[3] = np.sign(a[3]) * (1.0 + rng.random(shape[1])) * 1e-305
    a[4] = rng.integers(-2 ** 53, 2 ** 53, shape[1]).astype(np.float64)
    lscale = rng.integers(-20, 60, shape[0]).astype(np.int32)
    lscale[0], lscale[1], lscale[3], lscale[4] = 1000, -900, 1050, 0
    return a, lscale


@pytest.mark.parametrize("family,n", FAMILIES)
def test_quant_residues_f64_entry_bitwise(family, n):
    """K6's f64 entry at the ragged (37, 301) shape (odd k) with the edge
    rows, against the reference's ``quant_residues_op`` (Pallas, interpret
    mode); its plain version runs, no kernel launches."""
    rng = np.random.default_rng(21)
    a, lscale = _edge_operand(rng, (37, 301))
    want = jax_quant_residues_op(jnp.asarray(a), jnp.asarray(lscale),
                                 ms=jax_moduli_set(family, n), axis=0, interpret=True)
    ms = make_moduli_set(family, n)
    before = (kn.quant_residues_f64_plain.calls, kn.quant_residues_f64.launches,
              kn.quant_residues.launches)
    got = kn.quant_residues_f64(torch.from_numpy(a), torch.from_numpy(lscale),
                                pow2_tables(ms, "cpu"), ms=ms)
    assert (kn.quant_residues_f64_plain.calls, kn.quant_residues_f64.launches,
            kn.quant_residues.launches) == (before[0] + 1, before[1], before[2])
    assert len(_as_list(got)) == len(_as_list(want))
    for g, w in zip(_as_list(got), _as_list(want)):
        assert tuple(g.shape) == (n, 37, 301)
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_quant_residues_f64_entry_columnwise_is_the_frame_entry():
    """Per-column scales (axis=1) through the f64 entry equal the frame
    entry on ``decompose_int(scaled_int(a, lscale, 1))``."""
    rng = np.random.default_rng(22)
    a, lscale = _edge_operand(rng, (61, 45))
    a, lscale = torch.from_numpy(a.T.copy()), torch.from_numpy(lscale)
    ms = make_moduli_set("fp8-hybrid", 9)
    tables = pow2_tables(ms, "cpu")
    got = kn.quant_residues_f64(a, lscale, tables, ms=ms, axis=1)
    from repro_torch.core.quantize import scaled_int

    want = kn.quant_residues(*kn.decompose_int(scaled_int(a, lscale, 1)), tables, ms=ms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


@pytest.mark.parametrize("family,n", FAMILIES)
def test_requant_garner_f64_mode_bitwise(family, n):
    """K5's f64 mode on random product stacks of the schedule's largest
    magnitudes and scale exponents whose sums pass +-1023 (ldexp_wide's
    split; results stay normal, as XLA on the CPU flushes subnormals),
    against the reference's ``reconstruct_f64(requant_garner_op(...))``;
    the digits mode is the reference's ``requant_garner_op`` itself."""
    rng = np.random.default_rng(23)
    m, nn = 41, 29
    shape = (n, m, nn)
    if family == "int8":
        parts = (rng.integers(-2 ** 30, 2 ** 30, shape).astype(np.int32),)
    else:
        parts = tuple(rng.integers(-2 ** 24, 2 ** 24, shape).astype(np.float32)
                      for _ in range(3))
    lmu = rng.integers(-300, 530, m).astype(np.int32)
    lnu = rng.integers(-300, 530, nn).astype(np.int32)
    lmu[:2], lnu[:2] = (530, -450), (530, -450)  # -(lmu + lnu) = -1060, +900
    jms = jax_moduli_set(family, n)
    digits = jax_requant_garner_op(tuple(jnp.asarray(p) for p in parts), ms=jms, interpret=True)
    want = jax_reconstruct_f64(digits, jms, jnp.asarray(lmu), jnp.asarray(lnu))
    ms = make_moduli_set(family, n)
    cparts = tuple(torch.from_numpy(p) for p in parts)
    calls, launches = kn.requant_garner_plain.calls, kn.requant_garner.launches
    got = kn.requant_garner(cparts, ms=ms, lmu=torch.from_numpy(lmu), lnu=torch.from_numpy(lnu))
    assert (kn.requant_garner_plain.calls, kn.requant_garner.launches) == (calls + 1, launches)
    assert got.dtype == torch.float64 and tuple(got.shape) == (m, nn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(kn.requant_garner(cparts, ms=ms).numpy(), np.asarray(digits))


def test_new_entries_refuse_cuda_tensors_without_a_kernel(monkeypatch):
    """K6's f64 entry and K5's f64 mode on a CUDA tensor go to the kernel or
    raise: with no library to load, neither the plain version nor a launch
    runs."""
    from repro_torch.kernels.crt_reconstruct import kernel as k5_module
    from repro_torch.kernels.quant_residues import kernel as k6_module

    from _torch_parity import FakeCudaTensor

    def no_library(*_):
        raise RuntimeError("kernel library unavailable")

    fake = lambda t: t.as_subclass(FakeCudaTensor)  # noqa: E731
    ms = make_moduli_set("fp8-hybrid", 4)
    cases = [(k6_module, kn.quant_residues_f64, kn.quant_residues_f64_plain,
              (fake(torch.zeros((8, 16), dtype=torch.float64)),
               fake(torch.zeros(8, dtype=torch.int32)), fake(pow2_tables(ms, "cpu")))),
             (k5_module, kn.requant_garner, kn.requant_garner_plain,
              (tuple(fake(torch.zeros((4, 8, 4))) for _ in range(3)),))]
    for module, kernel, plain, args in cases:
        monkeypatch.setattr(module, "_load", no_library)
        kw = {"ms": ms}
        if kernel is kn.requant_garner:
            kw.update(lmu=fake(torch.zeros(8, dtype=torch.int32)),
                      lnu=fake(torch.zeros(4, dtype=torch.int32)))
        before = (plain.calls, kernel.launches)
        with pytest.raises(RuntimeError, match="kernel library unavailable"):
            kernel(*args, **kw)
        assert (plain.calls, kernel.launches) == before


def test_requant_garner_rejects_half_the_exponents():
    ms = make_moduli_set("int8", 4)
    c = (torch.zeros((4, 8, 4), dtype=torch.int32),)
    with pytest.raises(ValueError, match="both lmu and lnu"):
        kn.requant_garner(c, ms=ms, lmu=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="lnu must be a contiguous int32"):
        kn.requant_garner(c, ms=ms, lmu=torch.zeros(8, dtype=torch.int32),
                          lnu=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="axis must be 0 or 1"):
        kn.quant_residues_f64(torch.zeros((8, 4), dtype=torch.float64),
                              torch.zeros(8, dtype=torch.int32),
                              pow2_tables(ms, "cpu"), ms=ms, axis=2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backend_matmul_native_preferred_dtype_matches_reference(dtype):
    """Under a native policy with ``preferred_dtype=float32`` the product is
    accumulated and returned in f32, as the reference's
    ``jnp.matmul(..., preferred_element_type=)``, not rounded to the inputs'
    bf16 first (ROADMAP Queue C1: 0.134 off at max |C| 67.1 before)."""
    rng = np.random.default_rng(24)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 32)).astype(np.float32)
    want = np.asarray(jax_backend_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype), "native",
                                         preferred_dtype=jnp.float32))
    tdt = getattr(torch, dtype)
    got = backend_matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), "native",
                         preferred_dtype=torch.float32, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_bound_gemm_pins_f32_and_restores_the_switch():
    """``matmul_exact_fp8`` (accurate mode's bound GEMM) runs with the global
    TF32 switch off and leaves the caller's setting as it found it; the
    accurate exponents do not depend on it."""
    rng = np.random.default_rng(25)
    a = torch.from_numpy(lognormal_matrix(rng, (48, 64), 1.0))
    b = torch.from_numpy(lognormal_matrix(rng, (64, 40), 1.0))
    ms = make_moduli_set("fp8-hybrid", 12)
    switch = torch.backends.cuda.matmul
    seen, orig = [], torch.matmul

    def spy(x, y):
        seen.append(switch.allow_tf32)
        return orig(x, y)

    prev = switch.allow_tf32
    try:
        for on in (True, False):
            switch.allow_tf32 = on
            torch.matmul = spy
            try:
                scal = scaling.scaling_accurate(a, b, ms)
            finally:
                torch.matmul = orig
            assert switch.allow_tf32 == on
            if on:
                lmu, lnu = scal.lmu, scal.lnu
        assert torch.equal(scal.lmu, lmu) and torch.equal(scal.lnu, lnu)
        assert seen == [False, False]
    finally:
        switch.allow_tf32 = prev
    e = torch.tensor([[16.0, -3.0]], dtype=torch.float32).to(numerics.E4M3)
    assert torch.equal(numerics.matmul_exact_fp8(e, e.t()), torch.tensor([[265.0]]))
