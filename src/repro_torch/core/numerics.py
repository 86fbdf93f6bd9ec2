"""Numeric-format helpers shared by the emulation schemes (the torch
counterpart of ``repro/core/numerics.py``).

Everything here is exactness-critical. Each helper keeps the reference's op
sequence, so that on inputs away from the subnormal range the results are
bitwise equal to the JAX package's (``tests/test_torch_core.py``).
"""
from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
_F64_INF_BITS = 0x7FF0000000000000


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0**e as float64 for integer ``e``, built from the bit pattern.

    Exact wherever 2**e is representable (normal and subnormal), 0 below
    2**-1074 and inf above 2**1023. Built from bits, not from ``pow``, so the
    CPU, the card and the CUDA kernel (``csrc/ozaki_int.cuh``) agree bit for
    bit whatever their math libraries do.
    """
    e = e.to(torch.int64)
    normal = (e.clamp(-1022, 1023) + 1023) << 52
    subnormal = torch.ones_like(e) << (e + 1074).clamp(0, 51)
    bits = torch.where(e >= -1022, normal,
                       torch.where(e >= -1074, subnormal, torch.zeros_like(e)))
    bits = torch.where(e > 1023, torch.full_like(e, _F64_INF_BITS), bits)
    return bits.view(torch.float64)


def ldexp_wide(x: torch.Tensor, e) -> torch.Tensor:
    """x * 2**e for |e| beyond the single-factor float64 range (~1023).

    The exponent is split in halves with a FLOOR division (``e1 = e // 2``),
    as in the reference; each half is an exact power-of-two multiply, and
    the intermediate lies between |x| and the result, so it is representable
    whenever both are.
    """
    e = torch.as_tensor(e, dtype=torch.int32, device=x.device)
    e1 = torch.div(e, 2, rounding_mode="floor")
    return (x * pow2(e1)) * pow2(e - e1)


def cast_e4m3_roundup(x: torch.Tensor) -> torch.Tensor:
    """Cast float32 -> e4m3 rounding toward +inf (paper §III-E round-up cast).

    Round-to-nearest cast, then a +-1 step on the uint8 view wherever the
    cast landed below ``x``: e4m3fn bit patterns are monotone within each
    sign half. Valid for |x| <= 448 (callers guarantee < 256).
    """
    x = x.to(torch.float32)
    y = x.to(E4M3)
    yf = y.to(torch.float32)
    bits = y.view(torch.uint8)
    # toward +inf: positives step up the uint ladder, negatives step down.
    bumped = torch.where(yf >= 0, bits + 1, bits - 1)
    return torch.where(yf < x, bumped, bits).view(E4M3)


def f64_to_mant_exp(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose integer-valued float64 ``a`` into (m, e) with a = m * 2**e,
    m int64, e int32 >= 0, exactly, for any magnitude representable in
    float64. For |a| >= 1 the normalising right-shift is at most 52 bits."""
    m, e = torch.frexp(a)
    m53 = (m * (2.0 ** 53)).to(torch.int64)
    e53 = (e - 53).to(torch.int32)
    shift = torch.clamp(-e53, min=0).to(torch.int64)
    return m53 >> shift, torch.clamp(e53, min=0)


def centered_mod(x: torch.Tensor, p: int) -> torch.Tensor:
    """Symmetric residue of integer tensor ``x`` modulo ``p``: odd p gives
    [-(p-1)/2, (p-1)/2], even p [-p/2, p/2-1]. ``torch.remainder`` floors,
    like ``jnp.mod`` (``torch.fmod`` truncates and would be wrong)."""
    r = torch.remainder(x, p)
    half = (p - 1) // 2
    return (r - p * (r > half).to(r.dtype)).to(torch.int32)


def residues_from_mant_exp(m: torch.Tensor, e: torch.Tensor, p: int,
                           pow2_table: torch.Tensor) -> torch.Tensor:
    """Centred residue of (m * 2**e) mod p, exact, int32.
    ``pow2_table[j] = 2**j mod p``; the combining product is < p^2 < 2^21."""
    r = torch.remainder(m, p)
    t = pow2_table[torch.clamp(e, 0, pow2_table.shape[0] - 1).long()].to(torch.int64)
    return centered_mod(torch.remainder(r * t, p), p)


_VELTKAMP = 2.0 ** 27 + 1.0


def fma_int(x: torch.Tensor, w: float, y: torch.Tensor) -> torch.Tensor:
    """x*w + y with ONE rounding, as a fused multiply-add computes it, for
    integer-valued float64 ``x`` (|x| < 2^26) and |y| <= 2^-3 |x*w| or x = 0.

    x*w = uh + ul exactly (Dekker's product with w split in 26-bit halves),
    ul + y = th + tl exactly (TwoSum), then RN(uh + RO(th + tl)), where RO
    rounds to odd: with the product dominating, the odd sticky bit sits far
    enough below uh's rounding position to round the exact sum correctly
    (Boldo & Melquiond, IEEE TC 2008).
    """
    t = _VELTKAMP * w
    w_hi = t - (t - w)
    w_lo = w - w_hi
    uh = x * w
    ul = (x * w_hi - uh) + x * w_lo
    th = y + ul
    bp = th - y
    tl = (y - (th - bp)) + (ul - bp)
    even = (th.view(torch.int64) & 1) == 0
    toward = torch.where(tl > 0, torch.full_like(th, float("inf")),
                         torch.full_like(th, float("-inf")))
    return uh + torch.where((tl != 0) & even, torch.nextafter(th, toward), th)


def kahan_weighted_sum(digits: torch.Tensor, weights) -> torch.Tensor:
    """Compensated sum_i digits[i] * weights[i] over the leading axis, in
    float64 and in the reference's sequential order (Kahan, DESIGN.md I6).
    ``weights`` holds N floats.

    The term x*w - c is rounded ONCE, as a fused multiply-add: XLA on the CPU
    contracts the reference's ``x * w - c`` into an FMA, and the CUDA kernel
    spells it ``__fma_rn``. The digits are integers |x| <= 544 and the
    compensation is at most ~2^-51 |x*w| (the partial sum stays below the
    next radix weight), so ``fma_int`` reproduces the FMA exactly.
    """
    s = c = digits[0].to(torch.float64) * 0.0
    for x, w in zip(digits, weights):
        term = fma_int(x.to(torch.float64), float(w), -c)
        t = s + term
        c = (t - s) - term
        s = t
    return s


def matmul_exact_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """e4m3 x e4m3 -> f32 product, computed as an f32 matmul of the e4m3->f32
    casts: exact for integer entries |x| <= 16 while k*2^8 <= 2^24, and the
    accurate-mode bound GEMM (``scaling.scaling_accurate``), whose inflation
    (1 + k 2^-24) assumes true f32 accumulation. The inputs are exact in TF32,
    but a TF32 tensor core's accumulation is not known to be f32's, so the
    call runs with the global TF32 switch off
    (``torch.backends.cuda.matmul.allow_tf32``) and restores the caller's
    setting after."""
    matmul = torch.backends.cuda.matmul
    allow_tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        return torch.matmul(_as_f32(a), _as_f32(b))
    finally:
        matmul.allow_tf32 = allow_tf32


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32, exactly. An e4m3 tensor on the CPU goes through
    float16, which holds every e4m3 value: PyTorch's CPU conversion from
    e4m3 to float16 runs several times faster than to float32."""
    if x.dtype == E4M3 and x.device.type == "cpu":
        x = x.to(torch.float16)
    return x.to(torch.float32)


def matmul_exact_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 product, as an f64 matmul (exact: k*2^14 < 2^53;
    the card has no plain int8 matmul outside a kernel)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def log2_up(x: torch.Tensor, guard: float = 2.0 ** -40) -> torch.Tensor:
    """Upper bound on log2(x) in float64: an absolute 2^-40 guard dominates
    the few-ulp error of log2 for |log2| <= 1100."""
    return torch.log2(x) + guard
