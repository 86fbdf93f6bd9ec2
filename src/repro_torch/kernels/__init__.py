"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (which the CPU tests run) and its host-side glue, one package per
TPU kernel package of the reference:

* ``fused``: the single-kernel schedule, from raw frames (K1), which
  carries the main path, and from prepared residue parts (K2), which
  carries prepared pairings such as the linalg block updates;
* the phase-split pipeline (``pipeline``, the ``+unfused`` route):
  ``quant_residues`` (K6), ``fp8_gemm`` (K3), ``int8_gemm`` (K4) and
  ``crt_reconstruct`` (K5).
"""
from .common import resolve_reconstruct, stack_parts
from .crt_reconstruct import requant_garner, requant_garner_plain
from .fp8_gemm import fp8_gemm, fp8_gemm_plain
from .fused import (BLOCK_TABLE, decompose_raw, ozmm_fused_parts, ozmm_fused_parts_ref,
                    ozmm_fused_raw, ozmm_fused_raw_ref, ozmm_fused_ref,
                    ozmm_pallas_fused, ozmm_pallas_fused_prepared, select_blocks)
from .int8_gemm import int8_gemm, int8_gemm_plain
from .pipeline import ozmm_pallas, ozmm_pallas_prepared
from .quant_residues import (decompose_int, quant_residues, quant_residues_f64,
                             quant_residues_f64_plain, quant_residues_op, quant_residues_plain,
                             quant_residues_ref)

__all__ = [
    "resolve_reconstruct", "stack_parts", "BLOCK_TABLE", "decompose_raw",
    "ozmm_fused_parts", "ozmm_fused_parts_ref", "ozmm_fused_raw", "ozmm_fused_raw_ref",
    "ozmm_fused_ref", "ozmm_pallas_fused", "ozmm_pallas_fused_prepared", "select_blocks",
    "fp8_gemm", "fp8_gemm_plain", "int8_gemm", "int8_gemm_plain",
    "requant_garner", "requant_garner_plain", "decompose_int", "quant_residues",
    "quant_residues_f64", "quant_residues_f64_plain", "quant_residues_op",
    "quant_residues_plain", "quant_residues_ref",
    "ozmm_pallas", "ozmm_pallas_prepared",
]
