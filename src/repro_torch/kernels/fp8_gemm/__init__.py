from .kernel import (MAX_K, ROUTES, fp8_gemm, fp8_gemm_plain, reset_counts, residue_gemm,
                     residue_gemm_route)

__all__ = ["MAX_K", "ROUTES", "fp8_gemm", "fp8_gemm_plain", "reset_counts", "residue_gemm",
           "residue_gemm_route"]
