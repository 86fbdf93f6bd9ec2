"""Shared by tests/test_torch_*.py: the same numpy inputs through the JAX
reference and through the PyTorch port, compared bitwise.

The grid of (family, mode) cases is split over several files because each
JAX case costs a jit compile of ~5-10 s on a CPU; one file per family keeps
every file short for the parallel test run.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.core.gemm import ozmm as jax_ozmm
from repro.core.ozaki2 import ozmm_ozaki2 as jax_ozmm_ozaki2
from repro.testing import lognormal_matrix
from repro_torch import ozmm
from repro_torch.kernels.fused import ozmm_fused_raw_ref

SCHEME = {"fp8-hybrid": "ozaki2-fp8", "fp8-karatsuba": "ozaki2-karatsuba",
          "int8": "ozaki2-int8"}

#: The prime-ish shape pinned by tests/kernels/test_fused.py.
PRIME_ISH = (250, 94, 61)


def operands(seed: int, shape, phi: float):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return lognormal_matrix(rng, (m, k), phi), lognormal_matrix(rng, (k, n), phi)


def assert_both_routes_match_reference(a, b, family: str, mode: str,
                                       num_moduli: int | None = None) -> None:
    """The port's ozmm on the core route and on the kernel route ('+pallas',
    which runs the kernel's plain version on CPU tensors) is bitwise equal to
    repro.core.ozaki2.ozmm_ozaki2 on the same numpy inputs."""
    want = np.asarray(jax_ozmm_ozaki2(jnp.asarray(a), jnp.asarray(b), family=family,
                                      num_moduli=num_moduli, mode=mode))
    spec = f"{SCHEME[family]}/{mode}" + (f"@{num_moduli}" if num_moduli else "")
    core = ozmm(a, b, spec + "+core", device="cpu")
    np.testing.assert_array_equal(core.numpy(), want)
    calls = ozmm_fused_raw_ref.calls
    fused = ozmm(a, b, spec + "+pallas", device="cpu")
    assert ozmm_fused_raw_ref.calls == calls + 1, "the kernel route skipped the plain version"
    np.testing.assert_array_equal(fused.numpy(), want)


def reference_grads(a, b, spec, cotangent=None):
    """jax.grad of sum(sin(ozmm(a, b))), or the VJP with ``cotangent``."""
    if cotangent is None:
        loss = lambda x, y: jnp.sum(jnp.sin(jax_ozmm(x, y, spec)))  # noqa: E731
        return tuple(np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b)))
    _, vjp = jax.vjp(lambda x, y: jax_ozmm(x, y, spec), jnp.asarray(a), jnp.asarray(b))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(cotangent)))


def port_grads(a, b, spec, cotangent=None):
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    c = ozmm(ta, tb, spec, device="cpu")
    if cotangent is None:
        torch.sin(c).sum().backward()
    else:
        c.backward(torch.from_numpy(cotangent))
    return ta.grad.numpy(), tb.grad.numpy()


class FakeCudaTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to reach a kernel
    wrapper's kernel branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)
