"""Host side of the fused emulated GEMM (the torch counterpart of
``repro/kernels/fused/ops.py``): scaling and the raw-frame decomposition in
plain PyTorch, zero padding to the kernel tile, one ``ozmm_fused_raw``
launch, crop.

Padding is exactness-preserving: a zero element decomposes to an all-zero
raw frame, whose residues and parts are 0 for every modulus, so padded
results equal unpadded results bitwise.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.core import scaling
from repro_torch.core.moduli import DEFAULT_NUM_MODULI, ModuliSet, make_moduli_set
from repro_torch.core.plan import pow2_tables

from ..common import resolve_reconstruct
from .kernel import KERNEL_TILE, MANT_SPLIT, ozmm_fused_raw

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


def fused_raw_args(a, lmu, b, lnu, ms: ModuliSet, blocks) -> tuple[torch.Tensor, ...]:
    """The padded inputs of ``ozmm_fused_raw`` for f64 ``a``, ``b`` and the
    pairing exponents ``lmu`` (m,), ``lnu`` (n,)."""
    bm, bn, bk = blocks
    fa = tuple(_pad2(v, bm, bk) for v in decompose_raw(a))
    fb = tuple(_pad2(v, bk, bn) for v in decompose_raw(b))
    return (*fa, _pad2(lmu[:, None], bm, 1), *fb, _pad2(lnu[None, :], 1, bn),
            pow2_tables(ms, a.device))


def ozmm_pallas_fused(a: torch.Tensor, b: torch.Tensor, *, family: str = "fp8-hybrid",
                      num_moduli: int | None = None, mode: str = "accurate",
                      reconstruct: str | None = None, blocks=None) -> torch.Tensor:
    """Single-kernel emulated FP64 matmul of 2-D tensors on their device (the
    name is the reference's). Bitwise-equal to ``core.ozaki2.ozmm_ozaki2``;
    any m/n/k (zero-pad + crop)."""
    resolve_reconstruct(reconstruct)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"ozmm_pallas_fused takes 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    ms = make_moduli_set(family, num_moduli or DEFAULT_NUM_MODULI[family])
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    scal = scaling.compute_scaling(a, b, ms, mode)
    args = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, select_blocks(a.device.type, blocks))
    return ozmm_fused_raw(*args, ms=ms)[:a.shape[0], :b.shape[1]]
