"""The fused emulated GEMM kernels: wrappers of the hand-written Hopper kernels
``csrc/fused_raw.cu`` (K1) and ``csrc/fused_parts.cu`` (K2), which replace
``repro/kernels/fused/kernel.py::ozmm_fused_raw`` (body ``_kernel_raw``) and
``::ozmm_fused_parts`` (bodies ``_kernel_parts_fp8``/``_kernel_parts_int8``),
and their plain PyTorch versions.

``ozmm_fused_raw`` takes both operands as sign-folded two-limb raw frames
x = (mh*2^26 + ml) * 2^e (``ops.decompose_raw``), the pairing exponents
lmu (m, 1) / lnu (1, n) and the 2^e-mod-p tables, and returns the f64
product: on-chip residues, e4m3 split (or int8), the eq. (8)/(12) products
(or the single int8 product), combine, balanced Garner digits, Kahan f64 sum
and ``ldexp_wide``, all in one launch. ``ozmm_fused_parts`` takes the
residue parts of two fast-mode plans instead, stacked by
``kernels.common.stack_parts`` ((hi, lo, hs) e4m3 stacks (N, m, k) /
(N, k, n), or one int8 stack each), and runs the same products and
epilogue.

A CUDA tensor goes to the kernel or raises; only CPU tensors take the plain
versions ``ozmm_fused_raw_ref`` / ``ozmm_fused_parts_ref``, the port's
counterparts of the Pallas interpreter. ``<wrapper>.launches`` counts
kernel launches and ``<plain version>.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import crt, numerics, quantize
from repro_torch.core.moduli import POW2_TABLE_LEN, ModuliSet
from repro_torch.core.plan import residue_products

from ..launch import (MAX_MODULI, MODULI_TAIL, bind, check_tensors, moduli_tail,
                      raise_on_error, stream)

MANT_SPLIT = 26  # raw frame: mant = mh * 2^26 + ml (ops.decompose_raw)

#: (BM, BN, BK) compiled into csrc/fused_common.cuh; operands arrive padded to it.
KERNEL_TILE = (64, 64, 64)
#: Largest contraction the int32 arithmetic keeps exact: the square-modulus
#: combine reaches 67*k*2^8 and the int8 accumulator k*2^14, both < 2^31.
MAX_K = 2 ** 16


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _residue_tile(mh, ml, sc, p: int, pw):
    """Centred residue mod ``p`` of trunc(2^sc * (mh*2^26 + ml)), int32.
    Negative ``sc`` truncates by shifts of the magnitudes (the sign is
    applied afterwards), the high-limb shift clipped to 31; positive ``sc``
    multiplies by 2^sc mod p from the table, indices clipped to the table."""
    amh, aml = mh.abs(), ml.abs()
    sg = torch.where(mh != 0, torch.sign(mh), torch.sign(ml))
    t = torch.clamp(-sc, min=0)
    tl = torch.clamp(t, max=MANT_SPLIT)
    th = torch.clamp(t - MANT_SPLIT, 0, 31)
    mh_sh = amh >> th
    ml_sh = aml >> tl
    sp = torch.clamp(sc, min=0)
    hi_cap = pw.shape[0] - 1
    idx_h = torch.clamp(MANT_SPLIT - tl + sp, 0, hi_cap).long()
    idx_l = torch.clamp(sp, 0, hi_cap).long()
    r = torch.remainder(torch.remainder(mh_sh, p) * pw[idx_h]
                        + torch.remainder(ml_sh, p) * pw[idx_l], p)
    return numerics.centered_mod(sg * r, p)


def ozmm_fused_raw_ref(mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl, *,
                       ms: ModuliSet) -> torch.Tensor:
    """Plain PyTorch version of ``ozmm_fused_raw`` on whole matrices, on the
    inputs' device: the kernel's residues from the raw frames, then the core
    route's split, products (f32 or f64 matmuls of the integer-valued parts,
    exact), combine, Garner digits and Kahan sum, so the plain version
    equals the core route by construction."""
    ozmm_fused_raw_ref.calls += 1

    def parts(mh, ml, sc):
        return quantize.split_residues(
            [_residue_tile(mh, ml, sc, p, tbl[l]) for l, p in enumerate(ms.ps)], ms)

    cs = residue_products(parts(mh_a, ml_a, e_a + lmu), parts(mh_b, ml_b, e_b + lnu), ms)
    return crt.reconstruct(crt.garner_digits(cs, ms), ms, lmu[:, 0], lnu[0])


ozmm_fused_raw_ref.calls = 0


def _unstack(stacks, ms: ModuliSet) -> list[tuple]:
    """Stacked parts -> the core plan's per-modulus part tuples (a square
    modulus has no hs part)."""
    if ms.family == "int8":
        return [(stacks[l],) for l in range(ms.n)]
    hi, lo, hs = stacks
    return [(hi[l], lo[l]) if sq else (hi[l], lo[l], hs[l])
            for l, sq in enumerate(ms.is_square)]


def ozmm_fused_parts_ref(sa, sb, lmu, lnu, *, ms: ModuliSet) -> torch.Tensor:
    """Plain PyTorch version of ``ozmm_fused_parts`` on whole matrices, on the
    inputs' device: the core route's products over the unstacked parts,
    combine, Garner digits and Kahan sum, so it equals ``ozmm_prepared`` by
    construction."""
    ozmm_fused_parts_ref.calls += 1
    cs = residue_products(_unstack(sa, ms), _unstack(sb, ms), ms)
    return crt.reconstruct(crt.garner_digits(cs, ms), ms, lmu[:, 0], lnu[0])


ozmm_fused_parts_ref.calls = 0


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _bind(source: str, launch: str, n_ptr: int) -> ctypes.CDLL:
    """Bind a fused kernel's launch entry: ``n_ptr`` device pointers, then
    m, n, k, num_moduli and the device, then the 7 moduli arrays and the
    stream."""
    return bind(source, launch, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + MODULI_TAIL)


@functools.cache
def _load() -> ctypes.CDLL:
    lib = _bind("fused_raw.cu", "ozmm_fused_raw_launch", 10)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mma_probe_launch.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr]
    lib.mma_probe_launch.restype = i32
    return lib


@functools.cache
def _load_parts() -> ctypes.CDLL:
    return _bind("fused_parts.cu", "ozmm_fused_parts_launch", 9)


def _check_inputs(kernel: str, named, m: int, n: int, k: int,
                  ms: ModuliSet) -> torch.device:
    """Raise unless every (name, tensor, dtype, shape) of ``named`` matches and
    (m, n, k, N) is what the kernel takes; return the one device."""
    dev = check_tensors(kernel, named)
    if any(d % b for d, b in zip((m, n, k), KERNEL_TILE)):
        raise ValueError(f"{kernel}: (m, n, k) = {(m, n, k)} must be "
                         f"multiples of the kernel tile {KERNEL_TILE} (ops pads)")
    if k > MAX_K:
        raise ValueError(f"{kernel}: k = {k} exceeds {MAX_K}, beyond "
                         "which the int32 residue products are not exact")
    if ms.n > MAX_MODULI:
        raise ValueError(f"{kernel}: {ms.n} moduli exceed the kernel's "
                         f"{MAX_MODULI} shared-memory residue tiles")
    return dev


def ozmm_fused_raw(mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl, *,
                   ms: ModuliSet) -> torch.Tensor:
    """Fused emulated GEMM from raw frames, (m, n) float64. CUDA tensors run
    the kernel (or raise); CPU tensors run ``ozmm_fused_raw_ref``."""
    args = (mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl)
    m, k = mh_a.shape
    n = mh_b.shape[1]
    shapes = [(m, k)] * 3 + [(m, 1)] + [(k, n)] * 3 + [(1, n), (ms.n, POW2_TABLE_LEN)]
    names = ("mh_a", "ml_a", "e_a", "lmu", "mh_b", "ml_b", "e_b", "lnu", "tbl")
    dev = _check_inputs("ozmm_fused_raw",
                        [(nm, t, torch.int32, sh) for nm, t, sh in zip(names, args, shapes)],
                        m, n, k, ms)
    if dev.type == "cpu":
        return ozmm_fused_raw_ref(*args, ms=ms)
    lib = _load()
    out = torch.empty((m, n), dtype=torch.float64, device=dev)
    err = lib.ozmm_fused_raw_launch(*(t.data_ptr() for t in args), out.data_ptr(),
                                    m, n, k, ms.n, dev.index, *moduli_tail(ms, dev))
    raise_on_error("ozmm_fused_raw", lib, err)
    ozmm_fused_raw.launches += 1
    return out


ozmm_fused_raw.launches = 0


def ozmm_fused_parts(sa, sb, lmu, lnu, *, ms: ModuliSet) -> torch.Tensor:
    """Fused emulated GEMM from stacked residue parts (``stack_parts``
    layout: (hi, lo, hs) e4m3 stacks (N, m, k) / (N, k, n) for the fp8
    families, one int8 stack each for int8), lmu (m, 1) and lnu (1, n)
    int32; (m, n) float64. CUDA tensors run the kernel (or raise); CPU
    tensors run ``ozmm_fused_parts_ref``."""
    int8 = ms.family == "int8"
    parts_a, parts_b = ((sa,), (sb,)) if int8 else (tuple(sa), tuple(sb))
    m, k = parts_a[0].shape[1:]
    n = parts_b[0].shape[2]
    dtype = torch.int8 if int8 else numerics.E4M3
    named = ([(f"sa[{i}]", t, dtype, (ms.n, m, k)) for i, t in enumerate(parts_a)]
             + [(f"sb[{i}]", t, dtype, (ms.n, k, n)) for i, t in enumerate(parts_b)]
             + [("lmu", lmu, torch.int32, (m, 1)), ("lnu", lnu, torch.int32, (1, n))])
    dev = _check_inputs("ozmm_fused_parts", named, m, n, k, ms)
    if dev.type == "cpu":
        return ozmm_fused_parts_ref(sa, sb, lmu, lnu, ms=ms)
    if any(t.data_ptr() % 16 for t in parts_a + parts_b):
        raise ValueError("ozmm_fused_parts: the part stacks must be 16-byte aligned")
    lib = _load_parts()
    out = torch.empty((m, n), dtype=torch.float64, device=dev)
    ptrs_a = [t.data_ptr() for t in parts_a] + [None] * (3 - len(parts_a))
    ptrs_b = [t.data_ptr() for t in parts_b] + [None] * (3 - len(parts_b))
    err = lib.ozmm_fused_parts_launch(*ptrs_a, *ptrs_b, lmu.data_ptr(), lnu.data_ptr(),
                                      out.data_ptr(), m, n, k, ms.n, dev.index,
                                      *moduli_tail(ms, dev))
    raise_on_error("ozmm_fused_parts", lib, err)
    ozmm_fused_parts.launches += 1
    return out


ozmm_fused_parts.launches = 0


def mma_probe(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the kernel's own k32 FP8 MMA step on e4m3 ``a`` (16, k) @ ``b``
    (k, 8), k a multiple of 32, on the card. Returns the product as the
    kernel forms it (int32, each k32 step from a zero f32 fragment) and as a
    plain f32 accumulation across the k steps would (float32)."""
    if a.dtype != numerics.E4M3 or b.dtype != numerics.E4M3 or not a.is_cuda:
        raise ValueError("mma_probe takes e4m3 CUDA tensors")
    k = a.shape[1]
    if a.shape != (16, k) or b.shape != (k, 8) or k % 32:
        raise ValueError(f"mma_probe needs (16, k) @ (k, 8) with k % 32 == 0, "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    lib = _load()
    a, bt = a.contiguous(), b.t().contiguous()
    exact = torch.empty((16, 8), dtype=torch.int32, device=a.device)
    chained = torch.empty((16, 8), dtype=torch.float32, device=a.device)
    err = lib.mma_probe_launch(a.data_ptr(), bt.data_ptr(), k, exact.data_ptr(),
                               chained.data_ptr(), a.device.index, stream(a.device))
    raise_on_error("mma_probe", lib, err)
    return exact, chained
