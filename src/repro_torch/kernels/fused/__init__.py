from .kernel import (K_CHUNK, KERNEL_TILE, gemm_core, gemm_kc, mma_probe, ozmm_fused_parts,
                     ozmm_fused_parts_ref, ozmm_fused_raw, ozmm_fused_raw_ref, part_planes,
                     raw_parts, raw_parts_plain, transpose_parts, transpose_parts_plain,
                     wgmma_probe)
from .ops import (BLOCK_TABLE, BLOCKS_ENV, decompose_raw, fused_parts_args,
                  fused_raw_args, ozmm_pallas_fused, ozmm_pallas_fused_prepared,
                  select_blocks)
from .ref import ozmm_fused_ref

__all__ = [
    "K_CHUNK", "KERNEL_TILE", "gemm_core", "gemm_kc", "mma_probe", "ozmm_fused_parts",
    "ozmm_fused_parts_ref", "ozmm_fused_raw", "ozmm_fused_raw_ref", "part_planes",
    "raw_parts", "raw_parts_plain", "transpose_parts", "transpose_parts_plain",
    "wgmma_probe", "BLOCK_TABLE", "BLOCKS_ENV", "decompose_raw", "fused_parts_args",
    "fused_raw_args", "ozmm_pallas_fused", "ozmm_pallas_fused_prepared", "select_blocks",
    "ozmm_fused_ref",
]
