"""repro_torch.core.ozaki1 vs repro.core.ozaki1: the slices and the
emulated GEMM bitwise for both modes at S = 11 (the paper's default) and
S = 7, through ozmm and its gradient too; the reference's tiny-row case
(a row near the bottom of the f64 range) held to the reference's own gates,
not bitwise, since XLA on the CPU flushes subnormals and torch does not."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ozaki1 as jozaki1
from repro_torch import ozmm
from repro_torch.core import ozaki1

from _torch_parity import operands, port_grads, reference_grads
from _torch_threads import one_torch_thread  # noqa: F401


def _norm_err(c, a, b) -> float:
    """The reference's condition-free metric max |C - AB| / (|A||B|)."""
    return float(np.max(np.abs(c - a @ b) / (np.abs(a) @ np.abs(b))))


@pytest.mark.parametrize("num_slices", [11, 7])
def test_slices_and_gemm_bitwise(num_slices):
    a, b = operands(21, (20, 48, 12), 2.0)
    for axis, x in ((0, a), (1, b)):
        got = ozaki1.slice_operand(torch.from_numpy(x), num_slices, axis)
        want = jozaki1.slice_operand(jnp.asarray(x), num_slices, axis)
        np.testing.assert_array_equal(got.lz.numpy(), np.asarray(want.lz))
        for g, w in zip(got.slices, want.slices):
            np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                          np.asarray(w).view(np.uint8))
    for mode in ("accurate", "fast"):
        want = np.asarray(jozaki1.ozmm_ozaki1_fp8(jnp.asarray(a), jnp.asarray(b),
                                                  num_slices=num_slices, mode=mode))
        spec = f"ozaki1-fp8/{mode}@{num_slices}"
        np.testing.assert_array_equal(ozmm(a, b, spec, device="cpu").numpy(), want)
        assert ozaki1.num_matmuls(num_slices, mode) == jozaki1.num_matmuls(num_slices, mode)
    assert ozaki1.effective_bits(num_slices) == jozaki1.effective_bits(num_slices)


def test_gradient_bitwise_vs_jax_grad():
    """Ozaki-I differentiates as the reference's _ozmm_bwd's raw branch: the
    two cotangent products as unprepared Ozaki-I GEMMs."""
    a, b = operands(22, (10, 32, 6), 0.5)
    g = np.random.default_rng(23).standard_normal((10, 6))
    for w, x in zip(reference_grads(a, b, "ozaki1-fp8/fast@4", g),
                    port_grads(a, b, "ozaki1-fp8/fast@4", g)):
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_tiny_row_huge_exponent_within_reference_gates(mode):
    """tests/core/test_ozmm_accuracy.py::test_ozaki1_tiny_row_huge_exponent:
    a row at ~1e-294 pushes the deep slice scales past |lz| ~ 1028, where a
    single 2.0**e factor is inf; slice_operand must go through ldexp_wide."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 32))
    b = rng.standard_normal((32, 8))
    a[3] = np.abs(a[3]) * 1e-294 + 1e-294
    c = ozmm(a, b, f"ozaki1-fp8/{mode}@11", device="cpu").numpy()
    ref = a @ b
    assert np.all(np.isfinite(c))
    assert np.max(np.abs(c[3] - ref[3])) / np.max(np.abs(ref[3])) <= 2.0 ** -45
    assert _norm_err(np.delete(c, 3, 0), np.delete(a, 3, 0), b) <= 2.0 ** -45


def test_accuracy_gates_of_the_reference():
    """tests/core/test_ozmm_accuracy.py::test_ozaki1_fp8: 2^-49 (FP64 grade)
    accurate, 2^-40 fast, at S = 11."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((48, 512)), rng.standard_normal((512, 48))
    for mode, tol in (("accurate", 2.0 ** -49), ("fast", 2.0 ** -40)):
        assert _norm_err(ozmm(a, b, f"ozaki1-fp8/{mode}@11", device="cpu").numpy(),
                         a, b) <= tol, mode
