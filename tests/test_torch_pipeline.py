"""The phase-split emulated GEMM on the kernel route ('+pallas+unfused':
repro_torch.kernels.pipeline) against the JAX reference on the same numpy
inputs: ``ozmm_pallas`` and ``ozmm_pallas_prepared`` under the Pallas
interpreter for the hybrid family (square and Karatsuba moduli), the core
executor ``ozmm_ozaki2`` for the Karatsuba and int8 families (the
reference pins its pipeline to its core route), fast and accurate, 2-D,
batched and prepared. On CPU tensors every kernel runs its plain version.
Tolerance: bitwise throughout."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.core.ozaki2 import ozmm_ozaki2 as jax_ozmm_ozaki2
from repro.core.plan import quantize_matrix as jax_quantize_matrix
from repro.kernels import ozmm_pallas as jax_ozmm_pallas
from repro.kernels import ozmm_pallas_prepared as jax_ozmm_pallas_prepared
from repro_torch import backend_matmul, ozmm, prepare_operand
from repro_torch import kernels as kn
from repro_torch.core.moduli import DEFAULT_NUM_MODULI

from _torch_parity import PRIME_ISH, SCHEME, operands
from _torch_threads import one_torch_thread  # noqa: F401

#: 7 hybrid moduli: 6 square (eq. (12)) and 1 Karatsuba (eq. (8)).
HYBRID = "ozaki2-fp8/{mode}@7"


def _plain_calls():
    return (kn.quant_residues_plain.calls, kn.fp8_gemm_plain.calls, kn.int8_gemm_plain.calls,
            kn.requant_garner_plain.calls)


def _moved(before, after):
    return tuple(y - x for x, y in zip(before, after))


@pytest.fixture(scope="module")
def hybrid_inputs():
    return operands(5, PRIME_ISH, 2.0)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_unfused_route_matches_jax_ozmm_pallas(hybrid_inputs, mode):
    """ozmm(a, b, '+pallas+unfused') runs K6 twice, K3 3N times and K5 once
    (their plain versions) and equals the reference's ozmm_pallas in
    interpret mode and the port's '+core' and fused '+pallas' routes."""
    a, b = hybrid_inputs
    want = np.asarray(jax_ozmm_pallas(jnp.asarray(a), jnp.asarray(b), family="fp8-hybrid",
                                      num_moduli=7, mode=mode, interpret=True))
    spec = HYBRID.format(mode=mode)
    before = _plain_calls()
    got = ozmm(a, b, spec + "+pallas+unfused", device="cpu")
    assert _moved(before, _plain_calls()) == (2, 21, 0, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ozmm(a, b, spec + "+core", device="cpu").numpy(), want)
    np.testing.assert_array_equal(ozmm(a, b, spec + "+pallas", device="cpu").numpy(), want)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_prepared_unfused_matches_jax_ozmm_pallas_prepared(hybrid_inputs, mode):
    """ozmm(qa, qb, '+pallas+unfused') is ozmm_pallas_prepared: fast mode
    streams the plans' parts (no K6), accurate mode runs K6 under the bound
    GEMM's exponents; a raw rhs quantized on the fly gives the same bits."""
    a, b = hybrid_inputs
    ms = jax_moduli_set("fp8-hybrid", 7)
    ja = jax_quantize_matrix(jnp.asarray(a), "lhs", ms, mode=mode)
    jb = jax_quantize_matrix(jnp.asarray(b), "rhs", ms, mode=mode)
    want = np.asarray(jax_ozmm_pallas_prepared(ja, jb, interpret=True))
    spec = HYBRID.format(mode=mode)
    qa = prepare_operand(a, "lhs", spec, device="cpu")
    qb = prepare_operand(b, "rhs", spec, device="cpu")
    before = _plain_calls()
    np.testing.assert_array_equal(kn.ozmm_pallas_prepared(qa, qb).numpy(), want)
    np.testing.assert_array_equal(ozmm(qa, qb, spec + "+pallas+unfused").numpy(), want)
    np.testing.assert_array_equal(backend_matmul(qa, b, spec + "+pallas+unfused").numpy(), want)
    quant = 0 if mode == "fast" else 2
    assert _moved(before, _plain_calls()) == (3 * quant, 63, 0, 3)


@pytest.mark.parametrize("family,n,mode", [("fp8-karatsuba", 7, "fast"),
                                          ("int8", DEFAULT_NUM_MODULI["int8"], "accurate")])
def test_unfused_route_other_families_match_reference(family, n, mode):
    """Karatsuba (all eq. (8); 7 moduli, as each modulus costs the reference
    ~0.7 s of jit compile) and int8 (K4's N products) on '+pallas+unfused'
    against the reference's core executor."""
    a, b = operands(6, PRIME_ISH, 1.0)
    want = np.asarray(jax_ozmm_ozaki2(jnp.asarray(a), jnp.asarray(b), family=family,
                                      num_moduli=n, mode=mode))
    before = _plain_calls()
    got = ozmm(a, b, f"{SCHEME[family]}/{mode}@{n}+pallas+unfused", device="cpu")
    gemms = (0, n) if family == "int8" else (3 * n, 0)
    assert _moved(before, _plain_calls()) == (2, *gemms, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_unfused_route_matches_jax_ozmm_pallas():
    """(3, 48, 40) @ (3, 40, 36): one 2-D pipeline per batch entry, against
    the reference's vmapped ozmm_pallas in interpret mode."""
    rng = np.random.default_rng(7)
    a = (rng.random((3, 48, 40)) - 0.5) * np.exp(rng.standard_normal((3, 48, 40)))
    b = (rng.random((3, 40, 36)) - 0.5) * np.exp(rng.standard_normal((3, 40, 36)))
    want = np.asarray(jax_ozmm_pallas(jnp.asarray(a), jnp.asarray(b), family="fp8-hybrid",
                                      num_moduli=4, mode="fast", interpret=True))
    before = _plain_calls()
    got = ozmm(a, b, "ozaki2-fp8/fast@4+pallas+unfused", device="cpu")
    assert got.shape == (3, 48, 36)
    assert _moved(before, _plain_calls()) == (6, 36, 0, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transposed_operand_and_gradient_request():
    """A transposed view as an operand runs (its frames are made contiguous)
    and equals '+core'; asking for a gradient names ozmm_pallas."""
    a = torch.from_numpy(np.random.default_rng(8).random((4, 8)) - 0.5).requires_grad_()
    spec = "ozaki2-fp8/fast@4"
    got = ozmm(a, a.detach().T, spec + "+pallas+unfused", device="cpu")
    assert torch.equal(got.detach(), ozmm(a.detach(), a.detach().T, spec + "+core", device="cpu"))
    with pytest.raises(NotImplementedError, match=r"forward-only.*ozmm_pallas has no VJP"):
        got.sum().backward()
