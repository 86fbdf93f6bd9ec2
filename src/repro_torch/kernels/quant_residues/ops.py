"""Host side of the residue quantization pass (the torch counterpart of
``repro/kernels/quant_residues/ops.py``): one ``quant_residues_f64`` launch
over all moduli, which scales the f64 operand and takes it apart in the
kernel (on the CPU its plain version: ``quantize.scaled_int`` and
``decompose_int``, then the residues). The kernel is elementwise, so nothing
is padded or cropped."""
from __future__ import annotations

import torch

from repro_torch.core.moduli import ModuliSet
from repro_torch.core.plan import pow2_tables

from .kernel import quant_residues_f64


def quant_residues_op(a: torch.Tensor, lscale: torch.Tensor, *, ms: ModuliSet, axis: int = 0):
    """f64 ``a`` and its per-row (axis=0) or per-column (axis=1) log2 scales
    -> the stacked low-precision residue operands (N, m, k). A strided ``a``
    (a transposed view) is copied once, so that the kernel reads it
    row-major."""
    return quant_residues_f64(a.contiguous(), lscale.to(torch.int32).contiguous(),
                              pow2_tables(ms, a.device), ms=ms, axis=axis)
