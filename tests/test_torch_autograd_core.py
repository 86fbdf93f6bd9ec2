"""Gradients through repro_torch's ozmm on the core route (the plan-reusing
VJP) vs jax.grad of the reference's ozmm on the same numpy inputs, bitwise,
for the loss sum(sin(ozmm(a, b))) and for a seeded non-constant cotangent:
ozaki2-fp8 fast and accurate, Karatsuba fast and int8 fast."""
import numpy as np
import pytest

from _torch_parity import operands, port_grads, reference_grads
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast@6", "ozaki2-fp8/accurate@6",
                                  "ozaki2-karatsuba/fast@5", "ozaki2-int8/fast@8"])
def test_core_vjp_bitwise_vs_jax_grad(spec):
    a, b = operands(3, (12, 40, 8), 0.5)
    g = np.random.default_rng(4).standard_normal((12, 8)) * np.exp(
        np.random.default_rng(5).standard_normal((12, 8)))
    for cot in (None, g):
        want = reference_grads(a, b, spec, cot)
        got = port_grads(a, b, spec + "+core", cot)
        for w, x in zip(want, got):
            assert x.dtype == w.dtype == np.float64
            np.testing.assert_array_equal(x, w)
