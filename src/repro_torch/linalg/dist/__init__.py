"""repro_torch.linalg.dist: 2-D block-cyclic distributed dense linear
algebra (the torch counterpart of ``repro.linalg.dist``).

The blocked, GEMM-dominant algorithms of ``repro_torch.linalg`` with the
matrix scattered block-cyclically over a P x Q :class:`ProcessGrid`,
pivoting resolved by argmax-allreduce collectives, and panels broadcast as
``QuantizedMatrix`` residue plans (``core.plan.plan_to_wire``), so that
receivers execute prepared instead of re-quantizing. One process drives
every rank (single-controller, as the reference); every rank's GEMM runs on
its device: the card unless the caller passes ``device="cpu"``.

Public API:
  ProcessGrid / BlockCyclicMatrix / parse_grid    grid + layout (grid.py)
  lu_factor_dist                                  block-cyclic pivoted LU
  lu_solve_dist                                   distributed triangular-
                                                  solve epilogue (trsm.py)
  run_hpl_dist / hpl_scaled_residual_dist         distributed HPL harness
  dist_inf_norm / dist_residual                   distributed norm pieces
"""
from .grid import BlockCyclicMatrix, ProcessGrid, parse_grid
from .hpl import dist_inf_norm, dist_residual, hpl_scaled_residual_dist, run_hpl_dist
from .lu import lu_factor_dist
from .trsm import lu_solve_dist

__all__ = [
    "BlockCyclicMatrix", "ProcessGrid", "parse_grid",
    "lu_factor_dist", "lu_solve_dist",
    "dist_inf_norm", "dist_residual", "hpl_scaled_residual_dist",
    "run_hpl_dist",
]
