"""The residue quantization pass (K6): wrapper of the hand-written Hopper
kernel ``csrc/quant_residues.cu``, which replaces
``repro/kernels/quant_residues/kernel.py::quant_residues`` (bodies
``_quant_kernel``/``_quant_kernel_int8``), and its plain PyTorch versions.

For every modulus in one pass: the centred residue of each element of a
scaled integer operand, then the split into (hi, lo, hs) e4m3 stacks
(N, m, k) (hs zero-filled for square moduli), or one int8 stack. Two
entries of the one kernel:

* ``quant_residues`` takes the int32 frame (mh, ml, e)
  (``ref.decompose_int``, the TPU kernel's input) and the 2^e-mod-p tables;
* ``quant_residues_f64`` takes the f64 operand and its log2 scales and does
  the scaling and the frame's split itself (``quantize.scaled_int`` and
  ``decompose_int`` in registers), so those two PyTorch passes do not run.

A CUDA tensor goes to the kernel or raises; only CPU tensors take the plain
versions ``quant_residues_plain`` / ``quant_residues_f64_plain``.
``.launches`` counts kernel launches of each entry and ``.calls``
plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import numerics, quantize
from repro_torch.core.moduli import POW2_TABLE_LEN, ModuliSet

from ..common import stack_parts
from ..launch import (MODULI_TAIL, bind, check_moduli, check_tensors, kernel_scope, moduli_tail,
                      raise_on_error)
from .ref import MANT_SPLIT, decompose_int


def quant_residues_plain(mh, ml, e, tbl, *, ms: ModuliSet):
    """Plain PyTorch version of ``quant_residues`` on the inputs' device: the
    kernel's int32 residue arithmetic (2^26 mod p is the table's entry 26;
    the index e clamped to the table, as JAX's gather clamps), then the core
    route's split and ``stack_parts``."""
    quant_residues_plain.calls += 1
    idx = e.clamp(0, tbl.shape[1] - 1).long()
    rs = []
    for l, p in enumerate(ms.ps):
        pw = tbl[l]
        rm = torch.remainder(mh, p) * pw[MANT_SPLIT] + torch.remainder(ml, p)
        rs.append(numerics.centered_mod(torch.remainder(rm, p) * pw[idx], p))
    return stack_parts(quantize.split_residues(rs, ms), ms)


quant_residues_plain.calls = 0


def quant_residues_f64_plain(a, lscale, tbl, *, ms: ModuliSet, axis: int = 0):
    """Plain PyTorch version of ``quant_residues_f64``: the scaled integers
    (``quantize.scaled_int``), their frame (``decompose_int``), then
    ``quant_residues_plain``."""
    quant_residues_f64_plain.calls += 1
    return quant_residues_plain(*decompose_int(quantize.scaled_int(a, lscale, axis)), tbl,
                                ms=ms)


quant_residues_f64_plain.calls = 0


@functools.cache
def _load() -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    return bind("quant_residues.cu", "quant_residues_launch",
                [ptr] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int] + MODULI_TAIL)


def _launch(kernel: str, inputs, tbl, shape, axis: int, ms: ModuliSet, dev: torch.device):
    """One launch of the kernel on the frame (mh, ml, e) or on (a, lscale);
    returns the part stacks (N, m, k)."""
    lib = _load()
    int8 = ms.family == "int8"
    outs = tuple(torch.empty((ms.n, *shape), dtype=torch.int8 if int8 else numerics.E4M3,
                             device=dev) for _ in range(1 if int8 else 3))
    ptrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
    err = lib.quant_residues_launch(*inputs, tbl.data_ptr(), *ptrs, shape[0] * shape[1],
                                    shape[1], axis, ms.n, dev.index, *moduli_tail(ms, dev))
    raise_on_error(kernel, lib, err)
    return outs[0] if int8 else outs


@kernel_scope("quant_residues")
def quant_residues(mh, ml, e, tbl, *, ms: ModuliSet):
    """Part stacks (N, m, k) of the frame mh, ml, e (int32 (m, k)) under the
    tables ``tbl`` (int32 (N, 1024)): (hi, lo, hs) e4m3 for the fp8
    families, one int8 stack for int8. CUDA tensors run the kernel (or
    raise); CPU tensors run ``quant_residues_plain``."""
    m, k = mh.shape
    named = [("mh", mh, torch.int32, (m, k)), ("ml", ml, torch.int32, (m, k)),
             ("e", e, torch.int32, (m, k)), ("tbl", tbl, torch.int32, (ms.n, POW2_TABLE_LEN))]
    dev = check_tensors("quant_residues", named)
    check_moduli("quant_residues", ms)
    if dev.type == "cpu":
        return quant_residues_plain(mh, ml, e, tbl, ms=ms)
    out = _launch("quant_residues", [mh.data_ptr(), ml.data_ptr(), e.data_ptr(), None, None],
                  tbl, (m, k), 0, ms, dev)
    quant_residues.launches += 1
    return out


quant_residues.launches = 0


@kernel_scope("quant_residues_f64")
def quant_residues_f64(a, lscale, tbl, *, ms: ModuliSet, axis: int = 0):
    """Part stacks (N, m, k) of trunc(2^lscale * a) for the f64 operand ``a``
    (m, k) and its log2 scales ``lscale`` (int32), per row (``axis=0``, m
    entries) or per column (``axis=1``, k entries), under the tables
    ``tbl``. CUDA tensors run the kernel (or raise); CPU tensors run
    ``quant_residues_f64_plain``."""
    if axis not in (0, 1):
        raise ValueError(f"quant_residues_f64: axis must be 0 or 1, got {axis}")
    m, k = a.shape
    named = [("a", a, torch.float64, (m, k)),
             ("lscale", lscale, torch.int32, ((m, k)[axis],)),
             ("tbl", tbl, torch.int32, (ms.n, POW2_TABLE_LEN))]
    dev = check_tensors("quant_residues_f64", named)
    check_moduli("quant_residues_f64", ms)
    if dev.type == "cpu":
        return quant_residues_f64_plain(a, lscale, tbl, ms=ms, axis=axis)
    out = _launch("quant_residues_f64", [None, None, None, a.data_ptr(), lscale.data_ptr()],
                  tbl, (m, k), axis, ms, dev)
    quant_residues_f64.launches += 1
    return out


quant_residues_f64.launches = 0
