"""Resolution helpers and layout glue shared by the kernel packages (the
torch counterpart of ``repro/kernels/common.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.moduli import ModuliSet

RECONSTRUCT_MODES = ("onchip", "xla")


def resolve_reconstruct(reconstruct: str | None) -> str:
    """Where the fused kernel performs the final f64 digit combine.

    The H100 has native f64, so the on-chip epilogue (``"onchip"``: the
    kernel writes the f64 tile) is the default and the only mode ported.
    ``"xla"`` (the int16 digit stack plus a separate combine) exists in the
    reference only because TPU Mosaic lacks f64; it is ROADMAP item B6's
    remainder here.
    """
    if reconstruct is None or reconstruct == "onchip":
        return "onchip"
    if reconstruct == "xla":
        raise NotImplementedError(
            "reconstruct='xla' (the int16 Garner digit stack) is not ported; "
            "the on-chip f64 epilogue is the port's only mode (ROADMAP B6)")
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
