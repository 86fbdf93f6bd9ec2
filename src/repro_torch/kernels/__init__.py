"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (which the CPU tests run) and its host-side glue. Ported so far:
the fused kernels (``fused``): from raw frames (K1), which carries the
main path, and from prepared residue parts (K2), which carries prepared
pairings such as the linalg block updates."""
from .common import resolve_reconstruct, stack_parts
from .fused import (BLOCK_TABLE, decompose_raw, ozmm_fused_parts, ozmm_fused_parts_ref,
                    ozmm_fused_raw, ozmm_fused_raw_ref, ozmm_fused_ref,
                    ozmm_pallas_fused, ozmm_pallas_fused_prepared, select_blocks)

__all__ = [
    "resolve_reconstruct", "stack_parts", "BLOCK_TABLE", "decompose_raw",
    "ozmm_fused_parts", "ozmm_fused_parts_ref", "ozmm_fused_raw", "ozmm_fused_raw_ref",
    "ozmm_fused_ref", "ozmm_pallas_fused", "ozmm_pallas_fused_prepared", "select_blocks",
]
