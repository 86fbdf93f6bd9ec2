"""repro_torch's ozmm vs repro.core.ozaki2.ozmm_ozaki2, bitwise, for the
fp8-karatsuba family (ozaki2-karatsuba) at its default moduli, on both
routes (core, and '+pallas' -> the fused kernel's plain version)."""
import pytest

from _torch_parity import PRIME_ISH, assert_both_routes_match_reference, operands
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_fp8_karatsuba_default_moduli_bitwise(mode):
    for seed, phi in ((2, 0.5), (3, 2.0)):  # same shape: one JAX compile
        a, b = operands(seed, PRIME_ISH, phi)
        assert_both_routes_match_reference(a, b, "fp8-karatsuba", mode)
