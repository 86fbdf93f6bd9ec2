"""Quantization: float64 inputs -> integer matrices -> per-modulus residues ->
low-precision (e4m3 / int8) operand matrices; the torch counterpart of
``repro/core/quantize.py``.

  A' = trunc(2^lmu * A)          exact in float64 (power-of-two scale, trunc)
  (m, e) = mant/exp decomposition of A'       exact, any magnitude
  r_l = centred residue of A' mod p_l          exact int32 (pow2 tables)
  e4m3 splits:
    Karatsuba modulus (s = 16): hi = sign(r) * ceil(|r|/16), lo = r - 16*hi,
        hs = hi + lo.  |hi|,|hs| <= 16, |lo| <= 15.
    Square modulus (p = s^2):   hi = round(r/s) (half to even), lo = r - s*hi.
  int8 family: residues are emitted directly as int8 (|r| <= 128).
"""
from __future__ import annotations

import torch

from . import numerics
from .moduli import KARATSUBA_S, ModuliSet


def scaled_int(a: torch.Tensor, lscale: torch.Tensor, axis: int) -> torch.Tensor:
    """trunc(2^lscale * a): axis=0 scales rows (lscale[i]), axis=1 columns.
    Returns integer-valued float64."""
    e = lscale.unsqueeze(1 - axis)
    return torch.trunc(numerics.ldexp_wide(a, e))


def residues_all(a_int: torch.Tensor, ms: ModuliSet,
                 pow2_tables: torch.Tensor) -> list[torch.Tensor]:
    """Centred residues of integer-valued float64 ``a_int`` for every modulus."""
    m, e = numerics.f64_to_mant_exp(a_int)
    return [numerics.residues_from_mant_exp(m, e, p, pow2_tables[l])
            for l, p in enumerate(ms.ps)]


def _f8(x: torch.Tensor) -> torch.Tensor:
    """Integer parts |x| <= 16 as e4m3, exactly (one cast: every such
    integer is an e4m3 value)."""
    return x.to(numerics.E4M3)


def split_karatsuba(r: torch.Tensor):
    """Ceil-split of a residue |r| <= 256 into (hi, lo, hi+lo), all e4m3-exact."""
    s = KARATSUBA_S
    hi = torch.sign(r) * ((r.abs() + (s - 1)) // s)
    lo = r - s * hi
    return _f8(hi), _f8(lo), _f8(hi + lo)


def _round_div(r: torch.Tensor, s: int) -> torch.Tensor:
    """round(r / s) half to even, in float32 like the reference. The divisor
    is a tensor on r's device: PyTorch's CUDA division by a host scalar
    multiplies by the reciprocal instead of dividing."""
    d = torch.tensor(float(s), dtype=torch.float32, device=r.device)
    return torch.round(r.to(torch.float32) / d).to(torch.int32)


def split_square(r: torch.Tensor, s: int):
    """Round-split of a residue of a square modulus p = s^2: r = s*hi + lo,
    |hi|, |lo| <= 16 (paper §III-C/D)."""
    hi = _round_div(r, s)
    return _f8(hi), _f8(r - s * hi)


def split_residues(rs: list[torch.Tensor], ms: ModuliSet) -> tuple:
    """Per-modulus low-precision parts from centred residues, selection
    order: (hi, lo) for square moduli, (hi, lo, hs) for Karatsuba moduli,
    (r,) int8 for the int8 family."""
    parts = []
    for r, sq, s in zip(rs, ms.is_square, ms.split_s):
        if ms.family == "int8":
            parts.append((r.to(torch.int8),))
        elif sq:
            parts.append(split_square(r, s))
        else:
            parts.append(split_karatsuba(r))
    return tuple(parts)


def quantize_operand(a: torch.Tensor, lscale: torch.Tensor, axis: int,
                     ms: ModuliSet, pow2_tables: torch.Tensor) -> tuple:
    """Per-modulus low-precision parts of one operand (``split_residues``).
    ``axis``: 0 scales rows (A side), 1 columns."""
    return split_residues(residues_all(scaled_int(a, lscale, axis), ms, pow2_tables), ms)
