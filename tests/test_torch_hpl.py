"""repro_torch.linalg's QR and HPL harness against repro.linalg on the same
numpy inputs, on the CPU.

``qr`` runs no triangular solve, only host numpy and emulated GEMMs that are
bitwise equal to the reference's, so it is held bitwise, in fast and
accurate mode. It runs at 6 moduli: the property does not depend on the
count, and each of its GEMM shapes costs the reference a jit compile that
grows with it. ``run_hpl`` is held to the HPL gate and to the reference's
scaled residual within a stated factor.
"""
import numpy as np
import pytest

import repro.linalg as jax_linalg
from repro_torch import linalg

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_qr_bitwise(rng, mode):
    """48 x 32, block 16: one blocked trailing update, then Q."""
    a = rng.random((48, 32)) - 0.5
    q_want, r_want = jax_linalg.qr(a, f"ozaki2-fp8/{mode}@6", block=16)
    q_got, r_got = linalg.qr(a, f"ozaki2-fp8/{mode}@6", block=16, device=CPU)
    np.testing.assert_array_equal(q_got, q_want)
    np.testing.assert_array_equal(r_got, r_want)


def test_run_hpl_passes_near_the_reference():
    """The HPL gate (<= 16) at n = 128, block 64; the scaled residual lies
    within a factor of 4 of the reference's (both are rounding noise of the
    same problem: measured 7.2e-4 against 8.6e-4)."""
    want = jax_linalg.run_hpl(128, "ozaki2-fp8/fast", block=64)
    got = linalg.run_hpl(128, "ozaki2-fp8/fast", block=64, device=CPU)
    assert got["passed"] and got["scaled_residual"] <= linalg.HPL_THRESHOLD
    assert want["scaled_residual"] / 4 <= got["scaled_residual"] <= 4 * want["scaled_residual"]
    assert {k: got[k] for k in ("n", "block", "scheme", "mode", "policy")} == \
        {k: want[k] for k in ("n", "block", "scheme", "mode", "policy")}
    assert linalg.hpl_flop_count(128) == 2.0 * 128 ** 3 / 3.0 + 1.5 * 128 ** 2
