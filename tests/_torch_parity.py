"""Shared by tests/test_torch_*.py: the same numpy inputs through the JAX
reference and through the PyTorch port, compared bitwise.

The grid of (family, mode) cases is split over several files because each
JAX case costs a jit compile of ~5-10 s on a CPU; one file per family keeps
every file short for the parallel test run.
"""
import numpy as np
import torch

import jax.numpy as jnp

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


class FakeCudaTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to reach a kernel
    wrapper's kernel branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)
