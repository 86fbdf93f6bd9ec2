"""Resolution helpers shared by the kernel packages (the torch counterpart of
``repro/kernels/common.py``)."""
from __future__ import annotations

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
