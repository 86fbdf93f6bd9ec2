"""The Ozaki-II emulated GEMM, the port's core executor (the torch
counterpart of ``repro/core/ozaki2.py``): a thin layer over ``core.plan``.

Total = N (int8) or 3N (fp8) low-precision GEMMs in fast mode, +1 bound
GEMM in accurate mode, exactly Table II of the paper.
"""
from __future__ import annotations

import torch

from .moduli import DEFAULT_NUM_MODULI, make_moduli_set
from .plan import ozmm_prepared, quantize_matrix


def ozmm_ozaki2(a: torch.Tensor, b: torch.Tensor, *, family: str = "fp8-hybrid",
                num_moduli: int | None = None, mode: str = "accurate") -> torch.Tensor:
    """Emulated DGEMM of 2-D tensors via Ozaki-II on their device.
    ``family``: "fp8-hybrid" (paper §III-D), "fp8-karatsuba" (§III-B) or
    "int8" (§II baseline)."""
    ms = make_moduli_set(family, num_moduli or DEFAULT_NUM_MODULI[family])
    qa = quantize_matrix(a.to(torch.float64), "lhs", ms, mode=mode)
    qb = quantize_matrix(b.to(torch.float64), "rhs", ms, mode=mode)
    return ozmm_prepared(qa, qb)
