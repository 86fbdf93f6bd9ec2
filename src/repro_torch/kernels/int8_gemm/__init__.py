from .kernel import int8_gemm, int8_gemm_plain

__all__ = ["int8_gemm", "int8_gemm_plain"]
