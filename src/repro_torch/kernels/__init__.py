"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (which the CPU tests run) and its host-side glue. Ported so far:
the fused raw-frame kernel (``fused``), which carries the main path."""
from .common import resolve_reconstruct
from .fused import (BLOCK_TABLE, decompose_raw, ozmm_fused_raw, ozmm_fused_raw_ref,
                    ozmm_fused_ref, ozmm_pallas_fused, select_blocks)

__all__ = [
    "resolve_reconstruct", "BLOCK_TABLE", "decompose_raw", "ozmm_fused_raw",
    "ozmm_fused_raw_ref", "ozmm_fused_ref", "ozmm_pallas_fused", "select_blocks",
]
