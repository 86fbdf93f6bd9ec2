"""Scaling-vector construction (paper §II eq. (3) and §III-E); the torch
counterpart of ``repro/core/scaling.py``.

Both modes return integer base-2 exponents ``log2(mu)`` (per row of A) and
``log2(nu)`` (per column of B) such that the truncated integer matrices
A' = trunc(2^lmu * A), B' = trunc(B * 2^lnu) satisfy

    2 * sum_h |a'_ih| |b'_hj|  <  P          (eq. (3))

*Fast mode* bounds the sum by Cauchy-Schwarz on row/column norms.
*Accurate mode* bounds it with one extra GEMM of round-up-cast inputs,
inflated by the rigorous FP32 accumulation bound (1 + k*2^-24). That GEMM is
a plain f32 ``torch.matmul`` of the e4m3->f32 casts, not the FP8 tensor-core
path, so the inflation's assumption of true f32 accumulation holds.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import numerics
from .moduli import ModuliSet

#: Hard cap on |log2 scale| so scaled values stay finite in float64 and the
#: pow2 residue tables stay in range (moduli.POW2_TABLE_LEN).
MAX_LOG2_SCALE = 900


class ScalingResult(NamedTuple):
    lmu: torch.Tensor  # int32 (m,)  log2 of row scales of A
    lnu: torch.Tensor  # int32 (n,)  log2 of column scales of B
    extra_matmuls: int  # 1 for accurate mode (the bound GEMM), else 0


def _log2_sqrt_half_p(ms: ModuliSet) -> float:
    """(log2(P-1) - 1) / 2 rounded down a hair (paper's P')."""
    return (math.log2(ms.P - 1) - 1.0) / 2.0 - 2.0 ** -40


def _clip_scale(e: torch.Tensor, abs_max: torch.Tensor) -> torch.Tensor:
    """Clamp exponents so 2^e * abs_max <= 2^MAX_LOG2_SCALE; zero rows get
    e = 0. The cap constrains the PRODUCT exponent: denormal-range inputs
    legitimately need e ~ +1900."""
    _, emax = torch.frexp(abs_max)
    e = torch.minimum(e, MAX_LOG2_SCALE - emax)
    return torch.where(abs_max > 0, e, torch.zeros_like(e)).to(torch.int32)


def fast_exponents(sq_norm: torch.Tensor, abs_max: torch.Tensor, k: int,
                   ms: ModuliSet) -> torch.Tensor:
    """Per-operand Cauchy-Schwarz exponents: mu * ||v|| <= sqrt((P-1)/2).
    Depends on ONE operand only, which is what lets fast-mode plans be built
    per operand and reused across partners (core.plan)."""
    pprime = _log2_sqrt_half_p(ms)
    infl = 1.0 + (k + 2) * 2.0 ** -52
    l2 = 0.5 * numerics.log2_up(
        torch.where(sq_norm > 0, sq_norm * infl, torch.ones_like(sq_norm)))
    e = torch.floor(pprime - l2).to(torch.int32)
    return _clip_scale(e, abs_max)


def scaling_fast(a: torch.Tensor, b: torch.Tensor, ms: ModuliSet) -> ScalingResult:
    k = a.shape[-1]
    lmu = fast_exponents((a * a).sum(dim=1), a.abs().amax(dim=1), k, ms)
    lnu = fast_exponents((b * b).sum(dim=0), b.abs().amax(dim=0), k, ms)
    return ScalingResult(lmu, lnu, 0)


def accurate_prescale(x: torch.Tensor, axis: int, abs_max: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-operand half of accurate mode (paper §III-E step (14)):
    lpre = 7 - floor(log2 max|x|) along the contraction ``axis``, and the
    round-up e4m3 cast of 2^lpre * |x|. ``abs_max`` injects globally reduced
    maxima (k-sharding). Returns (lpre, Xbar)."""
    amax = x.abs().amax(dim=axis) if abs_max is None else abs_max
    _, e = torch.frexp(amax)
    lpre = torch.where(amax > 0, 7 - (e - 1), torch.zeros_like(e)).to(torch.int32)
    scaled = numerics.ldexp_wide(x.abs(), lpre.unsqueeze(axis))
    # f64 -> f32 must round up too: inflate by 2^-22 before the nearest-cast.
    scaled32 = (scaled * (1.0 + 2.0 ** -22)).to(torch.float32)
    return lpre, numerics.cast_e4m3_roundup(scaled32)


def bound_gemm_inflate(cbar_f32: torch.Tensor, k: int) -> torch.Tensor:
    """Rigorous FP32 accumulation inflation of the bound GEMM (paper §III-E):
    (1 + k 2^-24) for the f32 sum, (1 + 2^-50) for the f64 bookkeeping."""
    return cbar_f32.to(torch.float64) * (1.0 + k * 2.0 ** -24) * (1.0 + 2.0 ** -50)


def accurate_exponents(cbar_max: torch.Tensor, lpre: torch.Tensor,
                       abs_max: torch.Tensor, ms: ModuliSet) -> torch.Tensor:
    """Paper eq. (15): lmu[i] = lpre[i] + floor(P' - 0.5*log2 max_h Cbar[i,h])."""
    pprime = _log2_sqrt_half_p(ms)
    l2 = 0.5 * numerics.log2_up(torch.clamp(cbar_max, min=2.0 ** -64))
    e = torch.floor(pprime - l2).to(torch.int32) + lpre
    return _clip_scale(e, abs_max)


def scaling_accurate(a: torch.Tensor, b: torch.Tensor, ms: ModuliSet) -> ScalingResult:
    k = a.shape[-1]
    lmu2, abar = accurate_prescale(a, 1)
    lnu2, bbar = accurate_prescale(b, 0)
    cbar = bound_gemm_inflate(numerics.matmul_exact_fp8(abar, bbar), k)
    lmu = accurate_exponents(cbar.amax(dim=1), lmu2, a.abs().amax(dim=1), ms)
    lnu = accurate_exponents(cbar.amax(dim=0), lnu2, b.abs().amax(dim=0), ms)
    return ScalingResult(lmu, lnu, 1)


def compute_scaling(a: torch.Tensor, b: torch.Tensor, ms: ModuliSet,
                    mode: str) -> ScalingResult:
    if mode == "fast":
        return scaling_fast(a, b, ms)
    if mode == "accurate":
        return scaling_accurate(a, b, ms)
    raise ValueError(f"unknown mode {mode!r}")
