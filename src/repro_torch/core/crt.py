"""Residue-product combination and CRT reconstruction (paper §II steps 2-3);
the torch counterpart of ``repro/core/crt.py``.

  int8:       C'_l = centred_mod(int32 GEMM, p)
  square p:   eq. (12): C'_l = mod(s*(A1B2 + A2B1) + A2B2, p)        3 GEMMs
  karatsuba:  eq. (9):  A'B' = 256*C1 + C2 + 16*(C3 - C1 - C2)       3 GEMMs

Balanced Garner mixed-radix digits x_i with radix weights W_i give the
symmetric representative V = sum_i x_i W_i of A'B' mod P; the float64 result
is ldexp(V, -(lmu_i + lnu_j)) with V summed by Kahan compensation.
"""
from __future__ import annotations

import torch

from . import numerics
from .moduli import KARATSUBA_S, ModuliSet
from .numerics import centered_mod


def combine_residue_product(cparts, p: int, is_square: bool, s: int,
                            family: str) -> torch.Tensor:
    """Centred residue C'_l from the per-modulus GEMM outputs (int32)."""
    if family == "int8":
        (c,) = cparts
        return centered_mod(c, p)
    c1, c2, c3 = (x.to(torch.int32) for x in cparts)
    if is_square:
        return centered_mod(s * (c1 + c2) + c3, p)
    # mod-reduce the big terms first so every intermediate stays below 2^31
    t = (KARATSUBA_S * KARATSUBA_S * centered_mod(c1, p)
         + centered_mod(c2, p)
         + KARATSUBA_S * centered_mod(c3 - c1 - c2, p))
    return centered_mod(t, p)


def garner_digits(cs: list[torch.Tensor], ms: ModuliSet) -> torch.Tensor:
    """Balanced mixed-radix digits (radix order, even modulus first) from
    centred residues in selection order. All int32, |values| < 2^21. The
    steps reduce into [0, p) and only the digit is centred: every step is
    linear mod p, so the digit is the one that centring each step gives."""
    digits: list[torch.Tensor] = []
    for i, pi in enumerate(ms.radix_ps):
        t = cs[ms.radix_order[i]].to(torch.int32)
        for j in range(i):
            t = torch.remainder((t - digits[j]) * int(ms.garner_inv[j, i]), pi)
        digits.append(centered_mod(t, pi))
    return torch.stack(digits)


def reconstruct(digits: torch.Tensor, ms: ModuliSet, lmu: torch.Tensor,
                lnu: torch.Tensor) -> torch.Tensor:
    """C = V / (mu_i nu_j) with V = sum_i digits[i] * W_i (float64)."""
    v = numerics.kahan_weighted_sum(digits, ms.radix_weights_f64.tolist())
    return numerics.ldexp_wide(v, -(lmu[:, None] + lnu[None, :]))
