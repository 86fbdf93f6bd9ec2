from .kernel import (ROUTES, fp8_gemm, fp8_gemm_plain, max_k, reset_counts, residue_gemm,
                     residue_gemm_route)

__all__ = ["ROUTES", "fp8_gemm", "fp8_gemm_plain", "max_k", "reset_counts", "residue_gemm",
           "residue_gemm_route"]
