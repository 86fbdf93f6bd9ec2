from .kernel import MAX_K, fp8_gemm, fp8_gemm_plain, residue_gemm

__all__ = ["MAX_K", "fp8_gemm", "fp8_gemm_plain", "residue_gemm"]
