from .kernel import (KERNEL_TILE, mma_probe, ozmm_fused_parts,
                     ozmm_fused_parts_ref, ozmm_fused_raw, ozmm_fused_raw_ref)
from .ops import (BLOCK_TABLE, BLOCKS_ENV, decompose_raw, fused_parts_args,
                  fused_raw_args, ozmm_pallas_fused, ozmm_pallas_fused_prepared,
                  select_blocks)
from .ref import ozmm_fused_ref

__all__ = [
    "KERNEL_TILE", "mma_probe", "ozmm_fused_parts", "ozmm_fused_parts_ref",
    "ozmm_fused_raw", "ozmm_fused_raw_ref", "BLOCK_TABLE", "BLOCKS_ENV",
    "decompose_raw", "fused_parts_args", "fused_raw_args", "ozmm_pallas_fused",
    "ozmm_pallas_fused_prepared", "select_blocks", "ozmm_fused_ref",
]
