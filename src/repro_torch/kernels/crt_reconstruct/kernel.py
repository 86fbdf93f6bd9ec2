"""The requant + Garner pass (K5): wrapper of the hand-written Hopper
kernel ``csrc/requant_garner.cu``, which replaces
``repro/kernels/crt_reconstruct/kernel.py::requant_garner`` (bodies
``_kernel_fp8``/``_kernel_int8``), and its plain PyTorch version.

From the residue products of the GEMM schedule, ``(c1, c2, c3)`` float32
stacks (N, m, n) for the fp8 families or ``(c,)`` one int32 stack for int8,
to the balanced Garner digits (N, m, n) int16 in radix order (the TPU
kernel's output), or, given the scaling exponents ``lmu``/``lnu``, on to C
(m, n) float64: the reference's XLA epilogue ``reconstruct_f64`` (the
port's ``core/crt.py::reconstruct``), which the kernel finishes on the card.
Elementwise, so nothing is padded.

A CUDA tensor goes to the kernel or raises; only CPU tensors take the plain
version ``requant_garner_plain``. ``requant_garner.launches`` counts kernel
launches and ``requant_garner_plain.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import crt
from repro_torch.core.moduli import ModuliSet

from ..launch import (MODULI_TAIL, bind, check_moduli, check_tensors, kernel_scope, moduli_tail,
                      raise_on_error)


def requant_garner_plain(cparts, *, ms: ModuliSet, lmu: torch.Tensor | None = None,
                         lnu: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``requant_garner``: the core route's combine
    (``crt.combine_residue_product``) and digits (``crt.garner_digits``), as
    the reference's ``ref.py`` composes them; with ``lmu``/``lnu``, then
    ``crt.reconstruct``."""
    requant_garner_plain.calls += 1
    cs = [crt.combine_residue_product(tuple(c[l] for c in cparts), p, sq, s, ms.family)
          for l, (p, sq, s) in enumerate(zip(ms.ps, ms.is_square, ms.split_s))]
    digits = crt.garner_digits(cs, ms).to(torch.int16)
    return digits if lmu is None else crt.reconstruct(digits, ms, lmu, lnu)


requant_garner_plain.calls = 0


@functools.cache
def _load() -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    return bind("requant_garner.cu", "requant_garner_launch",
                [ptr] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                + MODULI_TAIL)


@kernel_scope("requant_garner")
def requant_garner(cparts, *, ms: ModuliSet, lmu: torch.Tensor | None = None,
                   lnu: torch.Tensor | None = None) -> torch.Tensor:
    """From ``cparts`` ((c1, c2, c3) float32 stacks (N, m, n) for the fp8
    families, or a 1-tuple of an int32 stack for int8): the balanced Garner
    digits (N, m, n) int16, radix order; or, given ``lmu`` (m,) and ``lnu``
    (n,) int32, C (m, n) float64. CUDA tensors run the kernel (or raise);
    CPU tensors run ``requant_garner_plain``."""
    int8 = ms.family == "int8"
    if len(cparts) != (1 if int8 else 3):
        raise ValueError(f"requant_garner: {ms.family} takes {1 if int8 else 3} product "
                         f"stacks, got {len(cparts)}")
    if (lmu is None) != (lnu is None):
        raise ValueError("requant_garner: give both lmu and lnu, or neither")
    _, m, n = cparts[0].shape
    dtype = torch.int32 if int8 else torch.float32
    named = [(f"cparts[{i}]", c, dtype, (ms.n, m, n)) for i, c in enumerate(cparts)]
    if lmu is not None:
        named += [("lmu", lmu, torch.int32, (m,)), ("lnu", lnu, torch.int32, (n,))]
    dev = check_tensors("requant_garner", named)
    check_moduli("requant_garner", ms)
    if dev.type == "cpu":
        return requant_garner_plain(cparts, ms=ms, lmu=lmu, lnu=lnu)
    lib = _load()
    ptrs = [None] * 3 + [cparts[0].data_ptr()] if int8 else [c.data_ptr() for c in cparts] + [None]
    if lmu is None:
        out = torch.empty((ms.n, m, n), dtype=torch.int16, device=dev)
        tail = [None, None, out.data_ptr(), None]
    else:
        out = torch.empty((m, n), dtype=torch.float64, device=dev)
        tail = [lmu.data_ptr(), lnu.data_ptr(), None, out.data_ptr()]
    err = lib.requant_garner_launch(*ptrs, *tail, m * n, n, ms.n, dev.index,
                                    *moduli_tail(ms, dev))
    raise_on_error("requant_garner", lib, err)
    requant_garner.launches += 1
    return out


requant_garner.launches = 0
