"""repro_torch.linalg's LU factorization and solve against repro.linalg on
the same numpy inputs, on the CPU, in fast and accurate mode.

Tolerances: ``lu_factor`` and ``lu_solve`` rtol 1e-12 normwise with equal
pivots. Their emulated GEMMs are bitwise equal to the
reference's, but their diagonal-block solves sum each row in torch's order,
not in the order XLA gives the reference's scan (tests/test_torch_linalg.py
names the probe); the measured differences are ~2e-15.
tests/test_torch_linalg.py holds Cholesky, tests/test_torch_hpl.py QR and
the HPL harness.
"""
import numpy as np
import pytest

import repro.linalg as jax_linalg
from repro_torch import linalg

CPU = "cpu"


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mode,n", [("fast", 100), ("accurate", 96)])
def test_lu_factor_and_solve_match_reference(rng, mode, n):
    """Ragged n = 100 (block 32) in fast mode, n = 96 in accurate mode."""
    spec = f"ozaki2-fp8/{mode}"
    a, b = rng.random((n, n)) - 0.5, rng.random((n, 2)) - 0.5
    lu_want, perm_want = jax_linalg.lu_factor(a, spec, block=32)
    lu_got, perm_got = linalg.lu_factor(a, spec, block=32, device=CPU)
    np.testing.assert_array_equal(perm_got, perm_want)
    assert rel(lu_got, lu_want) <= 1e-12
    l_fac, u_fac = linalg.lu_unpack(lu_got)
    assert rel(l_fac @ u_fac, a[perm_got]) <= 1e-12
    want = jax_linalg.lu_solve(lu_want, perm_want, b, spec, block=32)
    assert rel(linalg.lu_solve(lu_want, perm_want, b, spec, block=32, device=CPU), want) <= 1e-12
