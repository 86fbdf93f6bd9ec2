"""Host side of the fused emulated GEMM (the torch counterpart of
``repro/kernels/fused/ops.py``): scaling and the raw-frame decomposition in
plain PyTorch, zero padding to the kernel tile, one ``ozmm_fused_raw``
call (K1), crop (with ``reconstruct="xla"``: crop the digit stack and
combine it by ``crt.reconstruct``, the reference's ``_epilogue``). Prepared
pairings (``ozmm_pallas_fused_prepared``) stream a
fast-mode plan's cached parts through one ``ozmm_fused_parts`` call (K2), and
run an accurate-mode pairing on ``ozmm_fused_raw`` under the exponents of
its bound GEMM.

Padding is exactness-preserving: a zero element decomposes to an all-zero
raw frame, whose residues and parts are 0 for every modulus, so padded
results equal unpadded results bitwise.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.core import crt, scaling
from repro_torch.core.moduli import DEFAULT_NUM_MODULI, ModuliSet, make_moduli_set
from repro_torch.core.plan import QuantizedMatrix, pair_exponents, pow2_tables

from ..common import resolve_reconstruct, row_major, stack_parts
from .kernel import KERNEL_TILE, MANT_SPLIT, check_k, ozmm_fused_parts, ozmm_fused_raw

#: Env override of the padding tile: "bm,bn,bk" (the ``blocks=`` kwarg wins
#: over the env, the env over the table).
BLOCKS_ENV = "REPRO_FUSED_BLOCKS"

#: Device type -> (bm, bn, bk). The kernel's tile is compiled in, so the
#: "cuda" row is that tile; the plain version pads the same way, so the CPU
#: tests run the kernel's shapes.
BLOCK_TABLE = {"cuda": KERNEL_TILE, "cpu": KERNEL_TILE}


def select_blocks(device_type: str, override=None) -> tuple[int, int, int]:
    """Resolve the padding tile: ``override`` > ``REPRO_FUSED_BLOCKS`` >
    table. The kernel takes any multiple of its compiled tile."""
    if override is not None:
        bm, bn, bk = (int(v) for v in override)
        return bm, bn, bk
    env = os.environ.get(BLOCKS_ENV)
    if env:
        try:
            bm, bn, bk = (int(v) for v in env.split(","))
        except ValueError:
            raise ValueError(
                f"{BLOCKS_ENV} must be 'bm,bn,bk' integers, got {env!r}") from None
        return bm, bn, bk
    if device_type not in BLOCK_TABLE:
        raise ValueError(f"no fused-kernel tile for device type {device_type!r}")
    return BLOCK_TABLE[device_type]


def decompose_raw(x: torch.Tensor):
    """f64 -> sign-folded two-limb raw frame: x = (mh*2^26 + ml) * 2^e with
    mh, ml, e int32, the sign carried by BOTH limbs (|mh| < 2^27,
    |ml| < 2^26). Pairing-independent: the kernel folds the pairing scale in."""
    mant, e = torch.frexp(x)
    m53 = (mant * (2.0 ** 53)).to(torch.int64)
    sg = torch.sign(m53)
    am = m53.abs()
    mh = (sg * (am >> MANT_SPLIT)).to(torch.int32)
    ml = (sg * (am & ((1 << MANT_SPLIT) - 1))).to(torch.int32)
    return mh, ml, (e - 53).to(torch.int32)


def _pad2(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0, p1 = (-x.shape[0]) % m0, (-x.shape[1]) % m1
    return F.pad(x, (0, p1, 0, p0)) if (p0 or p1) else x.contiguous()


def _pad3(x: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """Zero-pad the last two axes of a 1-byte part stack (e4m3 or int8),
    through its uint8 view: the zero byte is +0 in both types."""
    p1, p2 = (-x.shape[1]) % m1, (-x.shape[2]) % m2
    if not (p1 or p2):
        return x.contiguous()
    return F.pad(x.view(torch.uint8), (0, p2, 0, p1)).view(x.dtype)


def fused_raw_args(a, lmu, b, lnu, ms: ModuliSet, blocks) -> tuple[torch.Tensor, ...]:
    """The padded inputs of ``ozmm_fused_raw`` for f64 ``a``, ``b`` and the
    pairing exponents ``lmu`` (m,), ``lnu`` (n,)."""
    bm, bn, bk = blocks
    fa = tuple(_pad2(v, bm, bk) for v in decompose_raw(a))
    fb = tuple(_pad2(v, bk, bn) for v in decompose_raw(b))
    return (*fa, _pad2(lmu[:, None], bm, 1), *fb, _pad2(lnu[None, :], 1, bn),
            pow2_tables(ms, a.device))


def fused_parts_args(sa, lmu, sb, lnu, ms: ModuliSet, blocks) -> tuple:
    """The padded inputs of ``ozmm_fused_parts`` for the stacked parts
    ``sa`` / ``sb`` (``stack_parts``) and the pairing exponents ``lmu`` (m,),
    ``lnu`` (n,)."""
    bm, bn, bk = blocks
    if ms.family == "int8":
        pa, pb = _pad3(sa, bm, bk), _pad3(sb, bk, bn)
    else:
        pa = tuple(_pad3(v, bm, bk) for v in sa)
        pb = tuple(_pad3(v, bk, bn) for v in sb)
    return pa, pb, _pad2(lmu[:, None], bm, 1), _pad2(lnu[None, :], 1, bn)


def _epilogue(out, m: int, n: int, ms: ModuliSet, lmu, lnu, reconstruct: str):
    """Crop the padding; for the digit stack, the f64 combine
    (``crt.reconstruct``: the kernel's Kahan sum and ``ldexp_wide``, so the
    two modes give the same bits)."""
    if reconstruct == "onchip":
        return out[:m, :n]
    return crt.reconstruct(out[:, :m, :n], ms, lmu, lnu)


def _fused_from_frames(a, lmu, b, lnu, *, ms: ModuliSet, blocks,
                       reconstruct: str) -> torch.Tensor:
    """Raw-frame path: decompose both operands, pad, one ``ozmm_fused_raw``
    call, epilogue."""
    args = fused_raw_args(a, lmu, b, lnu, ms, blocks)
    return _epilogue(ozmm_fused_raw(*args, ms=ms, reconstruct=reconstruct), a.shape[0],
                     b.shape[1], ms, lmu, lnu, reconstruct)


def _fused_from_parts(sa, lmu, sb, lnu, *, ms: ModuliSet, blocks,
                      reconstruct: str) -> torch.Tensor:
    """Prepared fast-mode path: the cached part stacks, padded, through one
    ``ozmm_fused_parts`` call, epilogue."""
    out = ozmm_fused_parts(*fused_parts_args(sa, lmu, sb, lnu, ms, blocks), ms=ms,
                           reconstruct=reconstruct)
    return _epilogue(out, lmu.shape[0], lnu.shape[0], ms, lmu, lnu, reconstruct)


def ozmm_pallas_fused(a: torch.Tensor, b: torch.Tensor, *, family: str = "fp8-hybrid",
                      num_moduli: int | None = None, mode: str = "accurate",
                      reconstruct: str | None = None, blocks=None) -> torch.Tensor:
    """Single-kernel emulated FP64 matmul of 2-D tensors on their device (the
    name is the reference's). Bitwise-equal to ``core.ozaki2.ozmm_ozaki2``
    up to k = 2^16 (past it, the kernel's chunked sums are exact where one
    f32 product is not); any m/n/k (zero-pad + crop); either
    ``reconstruct`` mode gives the same bits."""
    reconstruct = resolve_reconstruct(reconstruct)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"ozmm_pallas_fused takes 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    ms = make_moduli_set(family, num_moduli or DEFAULT_NUM_MODULI[family])
    check_k("ozmm_fused_raw", a.shape[1], ms)  # before the frames of a long k
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    scal = scaling.compute_scaling(a, b, ms, mode)  # on the layout the core route sees
    return _fused_from_frames(row_major(a), scal.lmu, row_major(b), scal.lnu, ms=ms,
                              blocks=select_blocks(a.device.type, blocks),
                              reconstruct=reconstruct)


def ozmm_pallas_fused_prepared(qa: QuantizedMatrix, qb: QuantizedMatrix, *,
                               reconstruct: str | None = None, blocks=None) -> torch.Tensor:
    """Execute a prepared pairing (core.plan) on the fused kernels, on the
    plans' device (the name is the reference's).

    Fast mode streams the plans' cached residue parts through
    ``ozmm_fused_parts`` without re-quantizing. Accurate mode derives the
    pairing exponents from the cached casts (``pair_exponents``: the bound
    GEMM, an f32 ``torch.matmul`` outside any kernel) and runs the raw-frame
    kernel ``ozmm_fused_raw``, which quantizes on chip under them. Bitwise
    equal to ``ozmm_prepared`` in both modes (up to k = 2^16).
    """
    reconstruct = resolve_reconstruct(reconstruct)
    ms = qa.ms
    blocks = select_blocks(qa.device.type, blocks)
    lmu, lnu = pair_exponents(qa, qb)
    if qa.mode == "fast":
        return _fused_from_parts(stack_parts(qa.parts, ms), lmu, stack_parts(qb.parts, ms),
                                 lnu, ms=ms, blocks=blocks, reconstruct=reconstruct)
    return _fused_from_frames(qa.x, lmu, qb.x, lnu, ms=ms, blocks=blocks,
                              reconstruct=reconstruct)
