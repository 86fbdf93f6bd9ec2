"""What every kernel wrapper of the port does around a launch: check its
tensors, bind a C entry point of a built library, pass the moduli constants
and the stream, and raise on a launch error.

A wrapper checks its inputs and then takes its plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises. There is no
fallback on a failed build or launch.

A kernel launched through ``ctypes`` is not an aten op, so a
``TorchDispatchMode`` sees only the ``torch.empty`` of its outputs. While a
graph recorder traces (``repro_torch.analysis.graph_check``, in
``RECORDERS``), every wrapper, decorated with ``kernel_scope`` under its
kernel's name, reports each call as a scope (on CPU tensors the scope holds
its plain version), and ``raise_on_error`` marks the open scope as
launched: the recorder then makes the call one node from its input tensors
to its output tensors. With no recorder active the decorator costs one list
test a call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.moduli import ModuliSet

from .build import load_library

KIND_SQUARE, KIND_KARATSUBA, KIND_INT8 = 0, 1, 2  # fused_common.cuh
#: MAXN of csrc/fused_common.cuh: the moduli parameter block's capacity.
MAX_MODULI = 20


#: Graph recorders while they trace, innermost last; each has
#: ``enter_scope(name, args, kwargs)``, ``exit_scope(name, out)`` and
#: ``launched()``.
RECORDERS: list = []


def kernel_scope(name: str) -> Callable:
    """Decorator of a kernel wrapper, under the kernel's ``name``: while a
    recorder traces, a call is a scope of it."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not RECORDERS:
                return fn(*args, **kwargs)
            rec = RECORDERS[-1]
            rec.enter_scope(name, args, kwargs)
            out = None
            try:
                out = fn(*args, **kwargs)
            finally:
                rec.exit_scope(name, out)
            return out
        return call
    return deco


def check_tensors(kernel: str, named) -> torch.device:
    """Raise unless every (name, tensor, dtype, shape) of ``named`` matches,
    is contiguous and all lie on one CPU or CUDA device; return it."""
    for name, t, dtype, shape in named:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            want = str(dtype).removeprefix("torch.")
            raise ValueError(f"{kernel}: {name} must be a contiguous {want} "
                             f"tensor of shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    devices = {t.device for _, t, _, _ in named}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {dev}")
    return dev


def check_moduli(kernel: str, ms: ModuliSet) -> None:
    if ms.n > MAX_MODULI:
        raise ValueError(f"{kernel}: {ms.n} moduli exceed the kernel's {MAX_MODULI}")


def bind(source: str, launch: str, argtypes) -> ctypes.CDLL:
    """Load the library of ``csrc/<source>`` (building every source at first
    use) and type its entry ``launch`` (returning the CUDA error as int) and
    ``cuda_error_string``."""
    lib = load_library(source)
    fn = getattr(lib, launch)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


#: ctypes argument types of the moduli arrays and the stream, the tail of
#: every launch entry that takes a moduli parameter block.
MODULI_TAIL = [ctypes.c_void_p] * 8


@functools.lru_cache(maxsize=None)
def moduli_consts(ms: ModuliSet) -> tuple[np.ndarray, ...]:
    """Moduli constants the C entries copy into the kernels' parameter block
    (``fused_common.cuh::Moduli``): ps, split_s, kind (selection order),
    radix_order, radix_ps, garner_inv (N x N, row j = inverse of radix
    modulus j), radix weights."""
    if ms.family == "int8":
        kind = [KIND_INT8] * ms.n
    else:
        kind = [KIND_SQUARE if sq else KIND_KARATSUBA for sq in ms.is_square]
    i32 = functools.partial(np.ascontiguousarray, dtype=np.int32)
    return (i32(ms.ps), i32(ms.split_s), i32(kind), i32(ms.radix_order),
            i32(ms.radix_ps), i32(ms.garner_inv),
            np.ascontiguousarray(ms.radix_weights_f64, dtype=np.float64))


def moduli_tail(ms: ModuliSet, dev: torch.device) -> tuple:
    """The moduli arrays and the stream, the last arguments of a launch."""
    return (*(c.ctypes.data for c in moduli_consts(ms)), stream(dev))


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on_error(kernel: str, lib: ctypes.CDLL, err: int) -> None:
    """Raise on a failed launch; after a launch that succeeded, tell the
    active recorder that the open scope launched its kernel."""
    if err:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
    if RECORDERS:
        RECORDERS[-1].launched()
