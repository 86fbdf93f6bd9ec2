"""repro_torch.linalg: emulated-FP64 dense linear algebra on top of ``ozmm``
(the torch counterpart of ``repro.linalg``; its block-cyclic distributed
counterparts are in ``repro_torch.linalg.dist``).

Blocked, GEMM-dominant BLAS-3 / LAPACK-style algorithms where every O(n^3)
flop routes through ``repro_torch.core.backend_matmul`` under one
``policy=`` (a ``PrecisionPolicy``, a spec string like
``"ozaki2-fp8/fast@8"``, or None for the precision context), on the entry
point's ``device=`` (None: the card; the tests pass ``device="cpu"``).
Matrices are host numpy float64 at the API boundary.

Public API:
  gemm / trsm / syrk                       blocked BLAS-3 (blas3.py)
  lu_factor / lu_unpack                    right-looking partial-pivoting LU
  cholesky                                 blocked lower Cholesky
  qr                                       blocked Householder WY QR
  lu_solve / cholesky_solve / refine_solve solves + iterative refinement
  hpl_scaled_residual / run_hpl            HPL-native accuracy currency
"""
from .blas3 import DEFAULT_BLOCK, emulated_matmul, gemm, syrk, trsm
from .cholesky import cholesky
from .hpl import HPL_THRESHOLD, hpl_flop_count, hpl_matrix, hpl_scaled_residual, run_hpl
from .lu import lu_factor, lu_unpack
from .qr import qr
from .solve import cholesky_solve, lu_solve, refine_solve

__all__ = [
    "DEFAULT_BLOCK", "emulated_matmul", "gemm", "syrk", "trsm",
    "cholesky", "lu_factor", "lu_unpack", "qr",
    "cholesky_solve", "lu_solve", "refine_solve",
    "HPL_THRESHOLD", "hpl_flop_count", "hpl_matrix", "hpl_scaled_residual", "run_hpl",
]
