"""FP8-based Ozaki-I scheme (paper §IV-A; the comparison baseline), the
torch counterpart of ``repro/core/ozaki1.py``.

A is approximated by S e4m3 slices per row: a_i ~= sum_l 2^{lz_l[i]} A_l[i,:]
with |A_l| <= 16 integer-valued (4 bits per slice + 1 redundant sign bit
between slices -> 5S-1 effective bits). Products A_i @ B_j are error-free FP8
GEMMs (k <= 2^16); the result is the doubly-scaled sum over slice pairs:

  accurate mode: all S^2 pairs        (paper: S^2 GEMMs)
  fast mode:     pairs with i+j <= S+1 (paper: S(S+1)/2 GEMMs, drops small terms)

The slice products run through ``numerics.matmul_exact_fp8``, the core
executor's f32 GEMM of the e4m3 casts (on the card an f32 SGEMM, not the FP8
tensor cores); the op sequence is the reference's, so the result is bitwise
equal to it away from the subnormal range. ``torch.round`` rounds half to
even as ``jnp.round`` does, and ``torch.frexp`` matches ``jnp.frexp``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import numerics

#: Effective bits gained per additional slice (4 mantissa + 1 sign-redundancy).
BITS_PER_SLICE = 5


class SlicedOperand(NamedTuple):
    slices: tuple[torch.Tensor, ...]  # each e4m3 (m,k) or (k,n)
    lz: torch.Tensor  # int32 (S, m) or (S, n): log2 slice scales


def slice_operand(a: torch.Tensor, num_slices: int, axis: int) -> SlicedOperand:
    """Extract S e4m3 slices along rows (axis=0: A-side) or columns (axis=1)."""
    amax = a.abs().amax(dim=1 - axis)
    _, e = torch.frexp(amax)  # floor(log2 amax) = e - 1
    base = torch.where(amax > 0, e.to(torch.int32) - 1, torch.zeros_like(e, dtype=torch.int32))

    slices = []
    lzs = []
    r = a
    for l in range(num_slices):
        lz = base - 3 - BITS_PER_SLICE * l  # zeta_l = 2^lz
        lze = lz.unsqueeze(1 - axis)
        # ldexp_wide, not a single 2.0**e factor: denormal-range rows push
        # |lz| toward ~1080, past the single-factor float64 range.
        q = torch.round(numerics.ldexp_wide(r, -lze))  # |q| <= 16, integer, exact
        slices.append(q.to(torch.float32).to(numerics.E4M3))
        r = r - numerics.ldexp_wide(q, lze)  # exact residual
        lzs.append(lz)
    return SlicedOperand(tuple(slices), torch.stack(lzs))


def ozmm_ozaki1_fp8(a: torch.Tensor, b: torch.Tensor, *, num_slices: int = 11,
                    mode: str = "accurate") -> torch.Tensor:
    """Emulated DGEMM of 2-D tensors via FP8 Ozaki-I, on their device."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    sa = slice_operand(a, num_slices, axis=0)
    sb = slice_operand(b, num_slices, axis=1)

    m, n = a.shape[0], b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float64, device=a.device)
    for i in range(num_slices):
        for j in range(num_slices):
            if mode == "fast" and (i + 1) + (j + 1) > num_slices + 1:
                continue
            cij = numerics.matmul_exact_fp8(sa.slices[i], sb.slices[j])
            scale = sa.lz[i][:, None] + sb.lz[j][None, :]
            acc = acc + numerics.ldexp_wide(cij.to(torch.float64), scale)
    return acc


def num_matmuls(num_slices: int, mode: str) -> int:
    """Paper Table II counts."""
    s = num_slices
    return s * (s + 1) // 2 if mode == "fast" else s * s


def effective_bits(num_slices: int) -> int:
    return BITS_PER_SLICE * num_slices - 1
