"""Resolution helpers and layout glue shared by the kernel packages (the
torch counterpart of ``repro/kernels/common.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.moduli import ModuliSet

RECONSTRUCT_MODES = ("onchip", "xla")


def resolve_reconstruct(reconstruct: str | None) -> str:
    """Where the fused kernels perform the final f64 digit combine.

    ``"onchip"``: the kernel writes the f64 product; the default here, since
    the H100 has native f64 (the reference defaults to ``"xla"`` on a TPU,
    whose Mosaic lacks f64). ``"xla"``: the kernel writes the int16 Garner
    digit stack (N, m, n) and ``crt.reconstruct`` combines it outside, as
    the reference's ``_epilogue``; both give the same bits.
    """
    if reconstruct is None:
        return "onchip"
    if reconstruct in RECONSTRUCT_MODES:
        return reconstruct
    raise ValueError(f"reconstruct must be one of {RECONSTRUCT_MODES} or None, "
                     f"got {reconstruct!r}")


def stack_parts(parts, ms: ModuliSet):
    """Core plan layout (per-modulus part tuples) -> the kernels' stacked
    layout: (hi, lo, hs) stacks of shape (N, ...) for the fp8 families, with
    ``hs`` zero-filled for square moduli (which have no third part), or one
    int8 stack for the int8 family."""
    if ms.family == "int8":
        return torch.stack([p[0] for p in parts])
    his = torch.stack([p[0] for p in parts])
    los = torch.stack([p[1] for p in parts])
    hss = torch.stack([p[2] if len(p) > 2 else _zeros_like(p[0]) for p in parts])
    return his, los, hss


def _zeros_like(x: torch.Tensor) -> torch.Tensor:
    """Zeros of ``x``'s shape and 1-byte type through the uint8 view (the
    zero byte is +0 in e4m3 and int8), so no fill kernel of the fp8 type is
    needed."""
    return torch.zeros_like(x.view(torch.uint8)).view(x.dtype)


def row_major(x: torch.Tensor) -> torch.Tensor:
    """An f64 operand as a contiguous matrix, the layout K1's frames and K6
    read: a copy only when ``x`` is a strided view, such as A^T in the
    backward's dB = A^T @ dC. ``row_major.copies`` counts the copies made."""
    if x.is_contiguous():
        return x
    row_major.copies += 1
    return x.contiguous()


row_major.copies = 0


def k_major(b: torch.Tensor) -> torch.Tensor:
    """B^T as a contiguous matrix: the one copy of B (f64) that the unprepared
    and accurate prepared routes make, so that K6 writes B's parts K-major.
    No copy when B is itself the transpose of a contiguous matrix, such as
    B^T in the backward's dA = dC @ B^T; ``k_major.copies`` counts the
    copies made."""
    bt = b.t()
    if bt.is_contiguous():
        return bt
    k_major.copies += 1
    return bt.contiguous()


k_major.copies = 0
