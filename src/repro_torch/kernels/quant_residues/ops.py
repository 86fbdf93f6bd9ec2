"""Host side of the residue quantization pass (the torch counterpart of
``repro/kernels/quant_residues/ops.py``): scale to integers and decompose in
plain PyTorch, then one ``quant_residues`` launch over all moduli. The
kernel is elementwise, so nothing is padded or cropped."""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.core.moduli import ModuliSet
from repro_torch.core.plan import pow2_tables

from .kernel import quant_residues
from .ref import decompose_int


def quant_residues_op(a: torch.Tensor, lscale: torch.Tensor, *, ms: ModuliSet, axis: int = 0):
    """f64 ``a`` and its per-row (axis=0) or per-column (axis=1) log2 scales
    -> the stacked low-precision residue operands (N, m, k). A strided ``a``
    (a transposed view) is copied once, so that the frames are contiguous."""
    mh, ml, e = decompose_int(quantize.scaled_int(a.contiguous(), lscale, axis))
    return quant_residues(mh, ml, e, pow2_tables(ms, a.device), ms=ms)
