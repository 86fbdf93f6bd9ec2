"""The fused emulated GEMM kernels: wrappers of the hand-written Hopper kernels
``csrc/fused_raw.cu`` (K1) and ``csrc/fused_parts.cu`` (K2), which replace
``repro/kernels/fused/kernel.py::ozmm_fused_raw`` (body ``_kernel_raw``) and
``::ozmm_fused_parts`` (bodies ``_kernel_parts_fp8``/``_kernel_parts_int8``),
and their plain PyTorch versions.

``ozmm_fused_raw`` takes both operands as sign-folded two-limb raw frames
x = (mh*2^26 + ml) * 2^e (``ops.decompose_raw``), the pairing exponents
lmu (m, 1) / lnu (1, n) and the 2^e-mod-p tables, and returns the f64
product: residues, e4m3 split (or int8), the eq. (8)/(12) products (or the
single int8 product), combine, balanced Garner digits, Kahan f64 sum and
``ldexp_wide`` (or, with ``reconstruct="xla"``, the int16 Garner digit
stack (N, m, n), as the reference's). On the card that is two launches of
the residue prologue
(``raw_parts``: each operand's parts once, K-major) and one of the GEMM
core (``gemm_core``, ``csrc/hopper_gemm.cuh``). ``ozmm_fused_parts`` takes
the residue parts of two fast-mode plans instead, stacked by
``kernels.common.stack_parts`` ((hi, lo, hs) e4m3 stacks (N, m, k) /
(N, k, n), or one int8 stack each): one launch of the B transpose
(``transpose_parts``, to K-major) and one of the same core.

A CUDA tensor goes to the kernels or raises; only CPU tensors take the plain
versions ``ozmm_fused_raw_ref`` / ``ozmm_fused_parts_ref`` /
``raw_parts_plain`` / ``transpose_parts_plain``, the port's counterparts of
the Pallas interpreter. ``<wrapper>.launches`` counts kernel launches
(``ozmm_fused_raw`` and ``ozmm_fused_parts`` one per call, the core's) and
``<plain version>.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import crt, numerics, quantize
from repro_torch.core.moduli import POW2_TABLE_LEN, ModuliSet
from repro_torch.core.plan import residue_products

from ..common import resolve_reconstruct, stack_parts
from ..launch import (MAX_MODULI, MODULI_TAIL, bind, check_tensors, kernel_scope, moduli_tail,
                      raise_on_error, stream)

MANT_SPLIT = 26  # raw frame: mant = mh * 2^26 + ml (ops.decompose_raw)

#: (BM, BN, BK) of the GEMM core (csrc/hopper_gemm.cuh): a cluster of two
#: blocks per 128 x 128 output tile (128 x 64 each), 128-deep k-tiles;
#: operands arrive padded to it.
KERNEL_TILE = (128, 128, 128)
#: Contraction of one chunk of the core's accumulation (``hopper_gemm.cuh``
#: CHUNK): each FP8 product's f32 accumulator reaches K_CHUNK*2^8 = 2^24,
#: exact, and the square-modulus combine of a chunk 67*2^24 < 2^31; each
#: chunk's centred residue is added mod p to the earlier chunks'.
K_CHUNK = 2 ** 16
#: Largest contraction of the fp8 families, the reference's (its int32
#: accumulators reach k*2^9 < 2^31), and of int8 (the s32 accumulator
#: k*2^14 < 2^31, in one chunk).
_MAX_K = 2 ** 21
_MAX_K_INT8 = 2 ** 16


def max_k(ms: ModuliSet) -> int:
    """The largest contraction K1/K2 take for ``ms``'s family."""
    return _MAX_K_INT8 if ms.family == "int8" else _MAX_K


def check_k(kernel: str, k: int, ms: ModuliSet) -> None:
    """Raise unless ``kernel`` keeps a contraction of ``k`` exact for ``ms``."""
    if k > max_k(ms):
        raise ValueError(f"{kernel}: k = {k} exceeds {max_k(ms)} ({ms.family}), beyond "
                         "which the products' accumulators are not exact")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _frame_shifts(mh, ml, sc, table_len: int) -> tuple:
    """The part of ``_residue_tile`` that no modulus changes: the sign, the
    magnitudes truncated by shifts for negative ``sc`` (the high-limb shift
    clipped to 31), and the 2^e-mod-p table indices for positive ``sc``,
    clipped to the table (int32: ``_lookup`` takes them)."""
    amh, aml = mh.abs(), ml.abs()
    sg = torch.where(mh != 0, torch.sign(mh), torch.sign(ml))
    t = torch.clamp(-sc, min=0)
    tl = torch.clamp(t, max=MANT_SPLIT)
    th = torch.clamp(t - MANT_SPLIT, 0, 31)
    sp = torch.clamp(sc, min=0)
    hi_cap = table_len - 1
    return (sg, amh >> th, aml >> tl, torch.clamp(MANT_SPLIT - tl + sp, 0, hi_cap),
            torch.clamp(sp, 0, hi_cap))


def _lookup(pw, idx):
    """``pw[idx]`` as one ``index_select`` over the flattened indices: the
    same values, several times faster than advanced indexing on a CPU."""
    return torch.index_select(pw, 0, idx.reshape(-1)).view(idx.shape)


#: Elements of one block of the plain versions' elementwise work on a CPU:
#: each of its hundreds of passes (residues, splits, the combine, the Garner
#: steps, the Kahan sum) then stays in cache, several times faster than
#: passes over a whole large operand or C.
CPU_BLOCK = 1 << 18


def _blocks(rows: int, cols: int, device) -> list[slice]:
    """Slices of the rows of a (rows, cols) elementwise computation: blocks
    of at most CPU_BLOCK elements on a CPU, one block on the card."""
    step = max(1, CPU_BLOCK // max(cols, 1)) if device.type == "cpu" else max(rows, 1)
    return [slice(r0, r0 + step) for r0 in range(0, max(rows, 1), step)]


def _residue_of(shifts: tuple, p: int, pw):
    """Centred residue mod ``p`` from ``_frame_shifts``, int32: each limb
    mod p times its power of two mod p from the table, the sign last."""
    sg, mh_sh, ml_sh, idx_h, idx_l = shifts
    r = torch.remainder(torch.remainder(mh_sh, p) * _lookup(pw, idx_h)
                        + torch.remainder(ml_sh, p) * _lookup(pw, idx_l), p)
    return numerics.centered_mod(sg * r, p)


def _residue_tile(mh, ml, sc, p: int, pw):
    """Centred residue mod ``p`` of trunc(2^sc * (mh*2^26 + ml)), int32.
    Negative ``sc`` truncates by shifts of the magnitudes (the sign is
    applied afterwards), the high-limb shift clipped to 31; positive ``sc``
    multiplies by 2^sc mod p from the table, indices clipped to the table."""
    return _residue_of(_frame_shifts(mh, ml, sc, pw.shape[0]), p, pw)


def _residues(mh, ml, sc, tbl, ms: ModuliSet) -> list:
    """``_residue_tile`` for every modulus of ``ms``, the shifts made once."""
    shifts = _frame_shifts(mh, ml, sc, tbl.shape[1])
    return [_residue_of(shifts, p, tbl[l]) for l, p in enumerate(ms.ps)]


def ozmm_fused_raw_ref(mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl, *,
                       ms: ModuliSet, reconstruct: str = "onchip") -> torch.Tensor:
    """Plain PyTorch version of ``ozmm_fused_raw`` on whole matrices, on the
    inputs' device: the kernel's residues from the raw frames, then the core
    route's split, products (f32 or f64 matmuls of the integer-valued parts,
    exact, in the kernel's chunks of k), combine, Garner digits and Kahan
    sum, so up to K_CHUNK the plain version equals the core route by
    construction."""
    ozmm_fused_raw_ref.calls += 1
    return parts_product_plain(raw_split_parts(mh_a, ml_a, e_a + lmu, tbl, ms=ms),
                               raw_split_parts(mh_b, ml_b, e_b + lnu, tbl, ms=ms), lmu, lnu,
                               ms=ms, reconstruct=reconstruct)


ozmm_fused_raw_ref.calls = 0


def raw_split_parts(mh, ml, sc, tbl, *, ms: ModuliSet) -> tuple:
    """The core route's per-modulus parts (``quantize.split_residues``) of
    one operand from its raw frames under the exponents ``sc`` (e + lexp):
    the plain versions' residues, split (elementwise: in ``_blocks`` of
    rows)."""
    blocks = [quantize.split_residues(_residues(mh[r], ml[r], sc[r], tbl, ms), ms)
              for r in _blocks(*mh.shape, mh.device)]
    if len(blocks) == 1:
        return blocks[0]
    return tuple(tuple(torch.cat(planes) for planes in zip(*parts)) for parts in zip(*blocks))


def chunked_residue_products(pa, pb, ms: ModuliSet) -> list[torch.Tensor]:
    """The core's centred residue products C'_l from both operands'
    per-modulus parts (A's (m, k), B's (k, n)), as the kernel accumulates
    them: ``core.plan.residue_products`` on each chunk of K_CHUNK of the
    contraction, each chunk's residues added mod p to the earlier chunks'.
    Exact at any k (the combine is linear mod p), where one f32 product
    over a whole k past K_CHUNK is not; at k <= K_CHUNK it is
    ``residue_products`` itself. On a CPU the chunks are shorter, of at most
    CPU_BLOCK elements of either operand, so that the e4m3 casts and their
    products stay in cache: the same exact sum."""
    (m, k), n = pa[0][0].shape, pb[0][0].shape[1]
    step = K_CHUNK
    if pa[0][0].device.type == "cpu":
        step = min(step, max(1, CPU_BLOCK // max(m, n, 1)))
    cs = None
    for k0 in range(0, k, step):
        ks = slice(k0, k0 + step)
        part = residue_products([tuple(x[:, ks] for x in ap) for ap in pa],
                                [tuple(x[ks] for x in bp) for bp in pb], ms)
        cs = part if cs is None else [numerics.centered_mod(c + d, p)
                                      for c, d, p in zip(cs, part, ms.ps)]
    return cs


def parts_product_plain(pa, pb, lmu, lnu, *, ms: ModuliSet,
                        reconstruct: str = "onchip") -> torch.Tensor:
    """The plain versions' GEMM from both operands' per-modulus parts: the
    products (``chunked_residue_products``), Garner digits and Kahan sum
    under lmu (m, 1) and lnu (1, n); with ``reconstruct="xla"`` the digits,
    int16 (N, m, n). Output rows and columns are independent, so blocks of
    A's rows and B's columns give blocks of C: it runs on ``_blocks`` of
    C's columns."""
    a0 = pa[0][0]
    xla = resolve_reconstruct(reconstruct) == "xla"
    out = []
    for cs in _blocks(pb[0][0].shape[1], a0.shape[0], a0.device):
        digits = crt.garner_digits(
            chunked_residue_products(pa, [tuple(x[:, cs] for x in bp) for bp in pb], ms), ms)
        out.append(digits.to(torch.int16) if xla else
                   crt.reconstruct(digits, ms, lmu[:, 0], lnu[0, cs]))
    return out[0] if len(out) == 1 else torch.cat(out, -1)


def _unstack(stacks, ms: ModuliSet) -> list[tuple]:
    """Stacked parts -> the core plan's per-modulus part tuples (a square
    modulus has no hs part)."""
    if ms.family == "int8":
        return [(stacks[l],) for l in range(ms.n)]
    hi, lo, hs = stacks
    return [(hi[l], lo[l]) if sq else (hi[l], lo[l], hs[l])
            for l, sq in enumerate(ms.is_square)]


def ozmm_fused_parts_ref(sa, sb, lmu, lnu, *, ms: ModuliSet,
                         reconstruct: str = "onchip") -> torch.Tensor:
    """Plain PyTorch version of ``ozmm_fused_parts`` on whole matrices, on the
    inputs' device: the core route's products over the unstacked parts (in
    the kernel's chunks of k), combine, Garner digits and Kahan sum, so up to
    K_CHUNK it equals ``ozmm_prepared`` by construction."""
    ozmm_fused_parts_ref.calls += 1
    return parts_product_plain(_unstack(sa, ms), _unstack(sb, ms), lmu, lnu, ms=ms,
                               reconstruct=reconstruct)


ozmm_fused_parts_ref.calls = 0


def raw_parts_plain(mh, ml, e, lexp, tbl, *, ms: ModuliSet, axis: int):
    """Plain PyTorch version of ``raw_parts``, in its output layout: the
    K-major part stacks of one operand from its raw frames under the pairing
    exponents ``lexp``. ``axis=0``: A, frames (m, k), lexp (m, 1), stacks
    (N, m, k); ``axis=1``: B, frames (k, n), lexp (1, n), stacks (N, n, k).
    The ``stack_parts`` layout otherwise: (hi, lo, hs) e4m3 with hs zero for
    square moduli (the kernel leaves those planes unwritten), or one int8
    stack."""
    raw_parts_plain.calls += 1
    rs = _residues(mh, ml, e + lexp, tbl, ms)
    if axis == 1:
        rs = [r.t().contiguous() for r in rs]
    return stack_parts(quantize.split_residues(rs, ms), ms)


raw_parts_plain.calls = 0


def _tuple_of(x, ms: ModuliSet) -> tuple:
    """Part stacks as a tuple: (stack,) for int8, (hi, lo, hs) otherwise."""
    return (x,) if ms.family == "int8" else tuple(x)


def _untuple(ts, ms: ModuliSet):
    """``_tuple_of``'s inverse: the int8 stack itself, or the (hi, lo, hs) tuple."""
    return ts[0] if ms.family == "int8" else tuple(ts)


def transpose_parts_plain(sb, *, ms: ModuliSet):
    """Plain PyTorch version of ``transpose_parts``: (N, k, n) part stacks to
    K-major (N, n, k), through the uint8 view."""
    transpose_parts_plain.calls += 1
    return _untuple([t.view(torch.uint8).transpose(1, 2).contiguous().view(t.dtype)
                      for t in _tuple_of(sb, ms)], ms)


transpose_parts_plain.calls = 0


def part_planes(stacks, ms: ModuliSet) -> list[torch.Tensor]:
    """The (rows, k) planes of a part stack that the kernels write and the
    core reads: every modulus' hi and lo (int8: its one plane) and the hs of
    each Karatsuba modulus, never a square modulus' hs."""
    if ms.family == "int8":
        return [stacks[l] for l in range(ms.n)]
    hi, lo, hs = stacks
    return [t[l] for l, sq in enumerate(ms.is_square)
            for t in ((hi, lo) if sq else (hi, lo, hs))]


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
    lib.raw_parts_launch.argtypes = [ptr] * 8 + [i32] * 5 + MODULI_TAIL
    lib.mma_probe_launch.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr]
    lib.wgmma_probe_launch.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, i32, ptr]
    lib.gemm_core_kc.argtypes = []
    for fn in (lib.raw_parts_launch, lib.mma_probe_launch, lib.wgmma_probe_launch,
               lib.gemm_core_kc):
        fn.restype = i32
    return lib


@functools.cache
def _load_parts() -> ctypes.CDLL:
    lib = _bind("fused_parts.cu", "ozmm_fused_parts_launch", 10)
    lib.transpose_parts_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                           + MODULI_TAIL)
    lib.transpose_parts_launch.restype = ctypes.c_int
    return lib


def _check_inputs(kernel: str, named, m: int, n: int, k: int,
                  ms: ModuliSet) -> torch.device:
    """Raise unless every (name, tensor, dtype, shape) of ``named`` matches and
    (m, n, k, N) is what the kernel takes; return the one device."""
    dev = check_tensors(kernel, named)
    if any(d % b for d, b in zip((m, n, k), KERNEL_TILE)):
        raise ValueError(f"{kernel}: (m, n, k) = {(m, n, k)} must be "
                         f"multiples of the kernel tile {KERNEL_TILE} (ops pads)")
    check_k(kernel, k, ms)
    if ms.n > MAX_MODULI:
        raise ValueError(f"{kernel}: {ms.n} moduli exceed the {MAX_MODULI} of the "
                         "kernels' moduli parameter block")
    return dev


def _ptrs(ts) -> list:
    """Device pointers of 1 or 3 part stacks, padded with NULLs to 3."""
    return [t.data_ptr() for t in ts] + [None] * (3 - len(ts))


def _empty_parts(ms: ModuliSet, shape, dev) -> tuple:
    """Uninitialized part stacks of ``shape``: three e4m3, or one int8."""
    dtype = torch.int8 if ms.family == "int8" else numerics.E4M3
    return tuple(torch.empty(shape, dtype=dtype, device=dev)
                 for _ in range(1 if ms.family == "int8" else 3))


@kernel_scope("raw_parts")
def raw_parts(mh, ml, e, lexp, tbl, *, ms: ModuliSet, axis: int):
    """K1's residue prologue: the K-major part stacks of one operand from its
    raw frames (``raw_parts_plain`` has the layout). CUDA tensors run the
    kernel (or raise); CPU tensors run ``raw_parts_plain``."""
    kdim, rows = mh.shape if axis == 1 else mh.shape[::-1]
    frame = (rows, kdim) if axis == 0 else (kdim, rows)
    named = ([(nm, t, torch.int32, frame) for nm, t in (("mh", mh), ("ml", ml), ("e", e))]
             + [("lexp", lexp, torch.int32, (rows, 1) if axis == 0 else (1, rows)),
                ("tbl", tbl, torch.int32, (ms.n, POW2_TABLE_LEN))])
    dev = check_tensors("raw_parts", named)
    if rows % 64 or kdim % 64:
        raise ValueError(f"raw_parts: {frame} must be multiples of 64 (ops pads)")
    if dev.type == "cpu":
        return raw_parts_plain(mh, ml, e, lexp, tbl, ms=ms, axis=axis)
    lib = _load()
    out = _empty_parts(ms, (ms.n, rows, kdim), dev)
    err = lib.raw_parts_launch(*(t.data_ptr() for t in (mh, ml, e, lexp, tbl)), *_ptrs(out),
                               rows, kdim, axis, ms.n, dev.index, *moduli_tail(ms, dev))
    raise_on_error("raw_parts", lib, err)
    raw_parts.launches += 1
    return _untuple(out, ms)


raw_parts.launches = 0


@kernel_scope("transpose_parts")
def transpose_parts(sb, *, ms: ModuliSet):
    """K2's B transpose: (N, k, n) part stacks (``stack_parts`` layout) to
    K-major (N, n, k), square moduli's hs planes left unwritten. CUDA
    tensors run the kernel (or raise); CPU tensors run
    ``transpose_parts_plain``."""
    src = _tuple_of(sb, ms)
    _, k, n = src[0].shape
    if src[0].device.type == "cpu":
        return transpose_parts_plain(sb, ms=ms)
    lib = _load_parts()
    dst = _empty_parts(ms, (ms.n, n, k), src[0].device)
    err = lib.transpose_parts_launch(*_ptrs(src), *_ptrs(dst), k, n, ms.n, src[0].device.index,
                                     *moduli_tail(ms, src[0].device))
    raise_on_error("transpose_parts", lib, err)
    transpose_parts.launches += 1
    return _untuple(dst, ms)


transpose_parts.launches = 0


def gemm_core(kernel: str, pa, pb, lmu, lnu, *, ms: ModuliSet,
              reconstruct: str = "onchip") -> torch.Tensor:
    """The GEMM core (``csrc/hopper_gemm.cuh``) of ``kernel``
    ("ozmm_fused_raw" or "ozmm_fused_parts", whose library it launches from)
    on K-major part stacks pa (N, m, k) and pb (N, n, k) on the card; returns
    the (m, n) float64 product, or with ``reconstruct="xla"`` the int16
    Garner digits (N, m, n), which the kernel writes over its residue
    scratch. The wrapper has checked the shapes."""
    lib = _load() if kernel == "ozmm_fused_raw" else _load_parts()
    sa, sb = _tuple_of(pa, ms), _tuple_of(pb, ms)
    (_, m, k), n = sa[0].shape, sb[0].shape[1]
    dev = sa[0].device
    digits = reconstruct == "xla"
    out = None if digits else torch.empty((m, n), dtype=torch.float64, device=dev)
    res = torch.empty((ms.n, m, n), dtype=torch.int16, device=dev)
    err = getattr(lib, f"{kernel}_launch")(*_ptrs(sa), *_ptrs(sb), lmu.data_ptr(),
                                          lnu.data_ptr(), res.data_ptr(),
                                          None if digits else out.data_ptr(),
                                          m, n, k, ms.n, dev.index, *moduli_tail(ms, dev))
    raise_on_error(kernel, lib, err)
    return res if digits else out


@kernel_scope("ozmm_fused_raw")
def ozmm_fused_raw(mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl, *,
                   ms: ModuliSet, reconstruct: str = "onchip") -> torch.Tensor:
    """Fused emulated GEMM from raw frames, (m, n) float64, or with
    ``reconstruct="xla"`` the int16 Garner digit stack (N, m, n). CUDA
    tensors run the kernels (the residue prologue of each operand, then the
    core; or raise); CPU tensors run ``ozmm_fused_raw_ref``."""
    reconstruct = resolve_reconstruct(reconstruct)
    args = (mh_a, ml_a, e_a, lmu, mh_b, ml_b, e_b, lnu, tbl)
    m, k = mh_a.shape
    n = mh_b.shape[1]
    shapes = [(m, k)] * 3 + [(m, 1)] + [(k, n)] * 3 + [(1, n), (ms.n, POW2_TABLE_LEN)]
    names = ("mh_a", "ml_a", "e_a", "lmu", "mh_b", "ml_b", "e_b", "lnu", "tbl")
    dev = _check_inputs("ozmm_fused_raw",
                        [(nm, t, torch.int32, sh) for nm, t, sh in zip(names, args, shapes)],
                        m, n, k, ms)
    if dev.type == "cpu":
        return ozmm_fused_raw_ref(*args, ms=ms, reconstruct=reconstruct)
    pa = raw_parts(mh_a, ml_a, e_a, lmu, tbl, ms=ms, axis=0)
    pb = raw_parts(mh_b, ml_b, e_b, lnu, tbl, ms=ms, axis=1)
    out = gemm_core("ozmm_fused_raw", pa, pb, lmu, lnu, ms=ms, reconstruct=reconstruct)
    ozmm_fused_raw.launches += 1
    return out


ozmm_fused_raw.launches = 0


@kernel_scope("ozmm_fused_parts")
def ozmm_fused_parts(sa, sb, lmu, lnu, *, ms: ModuliSet,
                     reconstruct: str = "onchip") -> torch.Tensor:
    """Fused emulated GEMM from stacked residue parts (``stack_parts``
    layout: (hi, lo, hs) e4m3 stacks (N, m, k) / (N, k, n) for the fp8
    families, one int8 stack each for int8), lmu (m, 1) and lnu (1, n)
    int32; (m, n) float64, or with ``reconstruct="xla"`` the int16 Garner
    digit stack (N, m, n). CUDA tensors run the kernels (B's transpose, then
    the core; or raise); CPU tensors run ``ozmm_fused_parts_ref``."""
    reconstruct = resolve_reconstruct(reconstruct)
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
        return ozmm_fused_parts_ref(sa, sb, lmu, lnu, ms=ms, reconstruct=reconstruct)
    if any(t.data_ptr() % 16 for t in parts_a + parts_b):
        raise ValueError("ozmm_fused_parts: the part stacks must be 16-byte aligned")
    out = gemm_core("ozmm_fused_parts", sa, transpose_parts(sb, ms=ms), lmu, lnu, ms=ms,
                    reconstruct=reconstruct)
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


def wgmma_probe(a: torch.Tensor, b: torch.Tensor):
    """Run the GEMM core's k32 FP8 step (wgmma m64n8k32 into a fresh f32
    fragment, promoted into an f32 sum) on e4m3 ``a`` (64, k) @ ``b`` (k, 8),
    k a multiple of 32, on the card, beside an f32 accumulator chained across
    every step. Returns (the promoted product as int32, the chained product
    as float32, the first k32 step at which the chain left the exact sum or
    -1), each (64, 8)."""
    if a.dtype != numerics.E4M3 or b.dtype != numerics.E4M3 or not a.is_cuda:
        raise ValueError("wgmma_probe takes e4m3 CUDA tensors")
    k = a.shape[1]
    if a.shape != (64, k) or b.shape != (k, 8) or k % 32:
        raise ValueError(f"wgmma_probe needs (64, k) @ (k, 8) with k % 32 == 0, "
                         f"got {tuple(a.shape)} @ {tuple(b.shape)}")
    lib = _load()
    a, bt = a.contiguous(), b.t().contiguous()
    exact = torch.empty((64, 8), dtype=torch.int32, device=a.device)
    chained = torch.empty((64, 8), dtype=torch.float32, device=a.device)
    first_bad = torch.empty((64, 8), dtype=torch.int32, device=a.device)
    err = lib.wgmma_probe_launch(a.data_ptr(), bt.data_ptr(), k, exact.data_ptr(),
                                 chained.data_ptr(), first_bad.data_ptr(), a.device.index,
                                 stream(a.device))
    raise_on_error("wgmma_probe", lib, err)
    return exact, chained, first_bad


def gemm_kc() -> int:
    """The GEMM core's FP8 promotion interval in k32 steps, as compiled
    (``hopper_gemm.cuh::KC``)."""
    return _load().gemm_core_kc()
