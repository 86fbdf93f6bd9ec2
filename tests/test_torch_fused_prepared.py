"""Prepared operands on the kernel route against the reference:
``ozmm(qa, qb, '+pallas')`` against ``ozmm_pallas_fused_prepared`` in
interpret mode on the same numpy inputs, fast mode (the plain version of
K2) and accurate mode (the plain version of K1 under the bound GEMM's
exponents), for the three Ozaki-II families at 250x94x61, at 7 moduli
each (the hybrid's 6 square and 1 Karatsuba: both product schedules; the
interpreter's compile and run grow with the count). At each family's
default count, tests/test_torch_fused_parts.py holds K2's plain version
and these fast prepared pairings ('+pallas', plan x plan and plan x raw)
against the reference's kernel, and tests/test_torch_ozaki2_{fp8,
karatsuba,int8}.py hold K1's plain version ('+pallas', both modes).
Tolerance: bitwise."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.core.plan import quantize_matrix as jax_quantize_matrix
from repro.kernels.fused.ops import ozmm_pallas_fused_prepared as jax_fused_prepared
from repro_torch import ozmm, prepare_operand
from repro_torch.kernels import fused

from _torch_parity import PRIME_ISH, SCHEME, operands
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", ["fp8-hybrid", "fp8-karatsuba", "int8"])
def test_prepared_pairings_match_jax_fused_prepared(family):
    """ozmm(qa, qb, '+pallas') against the reference's
    ozmm_pallas_fused_prepared in interpret mode: fast mode through K2's
    plain version, accurate mode through K1's under the bound GEMM's
    exponents; a raw rhs quantized on the fly gives the same bits."""
    a, b = operands(4, PRIME_ISH, 2.0)
    n = 7
    for mode, plain in (("fast", fused.ozmm_fused_parts_ref),
                        ("accurate", fused.ozmm_fused_raw_ref)):
        ms = jax_moduli_set(family, n)
        ja = jax_quantize_matrix(jnp.asarray(a), "lhs", ms, mode=mode)
        jb = jax_quantize_matrix(jnp.asarray(b), "rhs", ms, mode=mode)
        spec = f"{SCHEME[family]}/{mode}@{n}"
        ta = prepare_operand(a, "lhs", spec, device="cpu")
        tb = prepare_operand(b, "rhs", spec, device="cpu")
        want = np.asarray(jax_fused_prepared(ja, jb, interpret=True, blocks=fused.KERNEL_TILE))
        calls = plain.calls
        np.testing.assert_array_equal(ozmm(ta, tb, spec + "+pallas").numpy(), want)
        np.testing.assert_array_equal(ozmm(ta, b, spec + "+pallas").numpy(), want)
        assert plain.calls == calls + 2
