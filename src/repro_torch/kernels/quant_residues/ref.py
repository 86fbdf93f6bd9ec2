"""Oracle of the residue quantization pass (the torch counterpart of
``repro/kernels/quant_residues/ref.py``): the core quantization itself, and
the kernel's input contract ``decompose_int``."""
from __future__ import annotations

import torch

from repro_torch.core import numerics, quantize
from repro_torch.core.moduli import ModuliSet
from repro_torch.core.plan import pow2_tables

from ..common import stack_parts

MANT_SPLIT = 26  # mant = mh * 2^26 + ml


def decompose_int(a_int: torch.Tensor):
    """Integer-valued float64 -> (mh, ml, e) int32 with a_int = (mh*2^26 +
    ml) * 2^e exactly: mh the arithmetic right shift of the int64 mantissa
    by 26 (signed), 0 <= ml < 2^26, e >= 0."""
    mant, e = numerics.f64_to_mant_exp(a_int)
    mh = (mant >> MANT_SPLIT).to(torch.int32)
    ml = (mant & ((1 << MANT_SPLIT) - 1)).to(torch.int32)
    return mh, ml, e.to(torch.int32)


def quant_residues_ref(a_int: torch.Tensor, ms: ModuliSet):
    """The stacked parts the kernel emits for integer-valued float64
    ``a_int``, from the core quantization: (hi, lo, hs) e4m3 stacks (N, m, k)
    for the fp8 families (hs zero-filled for square moduli), one int8 stack
    for int8."""
    rs = quantize.residues_all(a_int, ms, pow2_tables(ms, a_int.device))
    return stack_parts(quantize.split_residues(rs, ms), ms)
