"""The Hopper kernel of repro_torch against its plain version on the card,
bitwise. Every test here is marked ``cuda`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-importing conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import ozmm
from repro_torch.core.scaling import compute_scaling
from repro_torch.kernels import fused
from repro_torch.precision import parse_policy


def _lognormal(rng, shape, phi):
    return (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-fp8/accurate",
                                  "ozaki2-karatsuba/fast", "ozaki2-int8/accurate"])
def test_kernel_bitwise_vs_plain_on_card(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(7)
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a = torch.from_numpy(_lognormal(rng, (200, 300), 2.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (300, 130), 2.0)).cuda()
    scal = compute_scaling(a, b, ms, pol.mode)
    args = fused.fused_raw_args(a, scal.lmu, b, scal.lnu, ms, fused.KERNEL_TILE)
    launches = fused.ozmm_fused_raw.launches
    got = fused.ozmm_fused_raw(*args, ms=ms)
    assert fused.ozmm_fused_raw.launches == launches + 1
    assert torch.equal(got, fused.ozmm_fused_raw_ref(*args, ms=ms))
    assert torch.equal(got[:200, :130], ozmm(a, b, spec + "+core"))
    assert torch.equal(got[:200, :130], ozmm(a, b, spec))  # backend auto: the kernel


@pytest.mark.cuda
def test_mma_probe_step_is_exact():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(3)
    a = rng.integers(-16, 17, (16, 256))
    b = rng.integers(-16, 17, (256, 8))
    f8 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda").to(torch.float8_e4m3fn)
    exact, _ = fused.mma_probe(f8(a), f8(b))
    assert torch.equal(exact.cpu().long(), torch.tensor(a) @ torch.tensor(b))
