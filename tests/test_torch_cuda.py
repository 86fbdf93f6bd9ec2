"""The Hopper kernels of repro_torch (K1 ozmm_fused_raw, K2
ozmm_fused_parts) against their plain versions on the card, bitwise. Every test here is marked ``cuda`` and skips without a CUDA device.

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


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast",
                                  "ozaki2-int8/fast", "ozaki2-fp8/fast@2"])
def test_parts_kernel_bitwise_vs_plain_on_card(spec):
    """K2 (ozmm_fused_parts) against its plain version and the core route,
    on plans prepared on the card, at a shape that needs padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import prepare_operand
    from repro_torch.kernels import stack_parts

    rng = np.random.default_rng(8)
    ms = parse_policy(spec).moduli_set()
    qa = prepare_operand(_lognormal(rng, (200, 300), 2.0), "lhs", spec)
    qb = prepare_operand(_lognormal(rng, (300, 130), 2.0), "rhs", spec)
    args = fused.fused_parts_args(stack_parts(qa.parts, ms), qa.lscale,
                                  stack_parts(qb.parts, ms), qb.lscale, ms, fused.KERNEL_TILE)
    launches = fused.ozmm_fused_parts.launches
    got = fused.ozmm_fused_parts(*args, ms=ms)
    assert fused.ozmm_fused_parts.launches == launches + 1
    assert torch.equal(got, fused.ozmm_fused_parts_ref(*args, ms=ms))
    assert torch.equal(got[:200, :130], ozmm(qa, qb, spec + "+core"))
    assert torch.equal(got[:200, :130], ozmm(qa, qb, spec))  # backend auto: K2


@pytest.mark.cuda
def test_prepared_accurate_pairing_on_card():
    """An accurate prepared pairing on the kernel route is K1 under the bound
    GEMM's exponents, bitwise equal to the core route."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import prepare_operand

    rng = np.random.default_rng(9)
    spec = "ozaki2-fp8/accurate"
    qa = prepare_operand(_lognormal(rng, (150, 200), 1.0), "lhs", spec)
    qb = prepare_operand(_lognormal(rng, (200, 70), 1.0), "rhs", spec)
    launches = fused.ozmm_fused_raw.launches
    got = ozmm(qa, qb, spec + "+pallas")
    assert fused.ozmm_fused_raw.launches == launches + 1
    assert torch.equal(got, ozmm(qa, qb, spec + "+core"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_kernel_route_lu_and_solve_on_card(mode):
    """lu_factor + lu_solve on '+pallas' on the card (K2 in fast mode, K1 in
    accurate mode, every trailing update and every TRSM fold of a one-column
    right-hand side) equal '+core' bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import linalg

    n, blk = 256, 64
    a, b = linalg.hpl_matrix(n, seed=5)
    spec = f"ozaki2-fp8/{mode}"
    k1, k2 = fused.ozmm_fused_raw.launches, fused.ozmm_fused_parts.launches
    lu, perm = linalg.lu_factor(a, spec + "+pallas", block=blk)
    x = linalg.lu_solve(lu, perm, b, spec + "+pallas", block=blk)
    nb = n // blk
    pairings = (nb - 1) + nb * (nb - 1)  # trailing updates + the solve's folds
    want = (0, pairings) if mode == "fast" else (pairings, 0)
    assert (fused.ozmm_fused_raw.launches - k1, fused.ozmm_fused_parts.launches - k2) == want
    lu_c, perm_c = linalg.lu_factor(a, spec + "+core", block=blk)
    np.testing.assert_array_equal(perm, perm_c)
    np.testing.assert_array_equal(lu, lu_c)
    np.testing.assert_array_equal(x, linalg.lu_solve(lu_c, perm_c, b, spec + "+core", block=blk))
