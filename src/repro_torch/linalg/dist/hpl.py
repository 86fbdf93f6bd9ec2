"""Distributed HPL harness (the torch counterpart of
``repro/linalg/dist/hpl.py``): block-cyclic emulated-DGEMM LU, scored in
HPL's currency with distributed norms.

The factorization (the 2/3 n^3 flops HPL measures) runs distributed
(``lu_factor_dist``: plan-broadcast panels, one emulated GEMM per rank per
step), and so does the O(n^2) triangular-solve epilogue (``lu_solve_dist``);
the factors are never gathered. The scaled residual

    ||A x - b||_inf / (eps * (||A||_inf ||x||_inf + ||b||_inf) * n)  <= 16

is evaluated with distributed norms: ||A||_inf and the residual matvec come
from per-rank partials over the block-cyclic layout (row sums reduced
across process columns, maxima across process rows).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.obs import span
from repro_torch.precision import resolve_policy

from ..blas3 import DEFAULT_BLOCK, emulated_matmul
from ..hpl import HPL_THRESHOLD, hpl_flop_count, hpl_matrix
from .grid import BlockCyclicMatrix
from .lu import as_grid, lu_factor_dist
from .trsm import lu_solve_dist, merge_stats


def dist_inf_norm(a_dist: BlockCyclicMatrix) -> float:
    """||A||_inf from per-rank partial row sums: each rank sums |local| along
    its columns, partials are summed across the process row, and the row
    maxima reduced across process rows."""
    g = a_dist.grid
    best = 0.0
    for p in range(g.nprow):
        partial = sum(np.sum(np.abs(a_dist.local(p, q)), axis=1) for q in range(g.npcol))
        if np.size(partial):
            best = max(best, float(np.max(partial)))
    return best


def dist_residual(a_dist: BlockCyclicMatrix, x: np.ndarray, b: np.ndarray,
                  policy=None) -> np.ndarray:
    """``A @ x - b`` over the block-cyclic layout: rank (p, q) multiplies its
    local block by its slice of x, partials sum (f64) across the process
    row, and the result scatters back to global order.

    ``policy=None`` keeps the matvec plain host f64, the yardstick of the
    scaled residual. An emulated policy runs each rank's local matvec as an
    emulated GEMM on its device (the refinement residual of
    ``run_hpl_dist``); the cross-rank partial sum stays f64, so the
    contraction is split at process-column boundaries."""
    g = a_dist.grid
    x = np.asarray(x, dtype=np.float64)
    r = np.empty_like(np.asarray(b, dtype=np.float64))
    for p in range(g.nprow):
        rows = a_dist.global_rows(p)
        if policy is None:
            partial = sum(a_dist.local(p, q) @ x[a_dist.global_cols(q)]
                          for q in range(g.npcol))
        else:
            partial = sum(
                emulated_matmul(a_dist.local(p, q), x[a_dist.global_cols(q)][:, None], policy,
                                device=g.device(p, q))[:, 0]
                for q in range(g.npcol))
        r[rows] = partial - b[rows]
    return r


def hpl_scaled_residual_dist(a_dist: BlockCyclicMatrix, x: np.ndarray, b: np.ndarray,
                             a_inf_norm: float | None = None) -> float:
    """The HPL acceptance metric with every matrix-sized reduction
    distributed; only O(n) vectors are handled globally. ``a_inf_norm``
    reuses an already-reduced ``dist_inf_norm``."""
    n = a_dist.shape[0]
    eps = np.finfo(np.float64).eps
    if a_inf_norm is None:
        a_inf_norm = dist_inf_norm(a_dist)
    r_inf = float(np.max(np.abs(dist_residual(a_dist, x, b))))
    denom = eps * (a_inf_norm * np.linalg.norm(x, np.inf) + np.linalg.norm(b, np.inf)) * n
    return float(r_inf / denom)


def run_hpl_dist(n: int, policy=None, *, grid=(2, 2), block: int = DEFAULT_BLOCK,
                 refine_steps: int = 1, seed: int = 0, panel_wire: str | None = None,
                 target_rel_err: float | None = None, device=None) -> dict:
    """Factor and solve the HPL problem on a P x Q block-cyclic grid, every
    rank on its device (``device`` for a (P, Q) tuple, None: the card), and
    score it HPL-style. ``n`` is arbitrary (ragged edge blocks). Returns
    ``run_hpl``'s result dict extended with the grid, the wire format, bytes
    on the wire, per-phase times (factorization and epilogue) and GFLOP/s
    (HPL's count 2/3 n^3 + 3/2 n^2 over factorization + solve wall time;
    refinement and scoring excluded)."""
    pol = resolve_policy(policy)
    g = as_grid(grid, device)
    a, b = hpl_matrix(n, seed=seed)
    with span("dist.hpl.run", n=n, grid=f"{g.nprow}x{g.npcol}"):
        return _run_scored(n, pol, g, a, b, block, refine_steps, panel_wire, target_rel_err)


def _run_scored(n, pol, g, a, b, block, refine_steps, panel_wire, target_rel_err) -> dict:
    t0 = time.perf_counter()
    lu_dist, perm, stats = lu_factor_dist(a, pol, grid=g, block=block, panel_wire=panel_wire,
                                          target_rel_err=target_rel_err)
    factor_seconds = time.perf_counter() - t0
    pol = resolve_policy(stats["policy"])  # resolve_for may have picked @N

    # The distributed O(n^2) epilogue; the scoring scaffolding (scattering A
    # for the norms, the norm) stays outside the timed window:
    # epilogue_seconds covers the solves and refinement, ep_stats["timings"]
    # the pure sweeps.
    res_pol = dataclasses.replace(pol, mode="accurate") if pol.is_emulated else pol
    a_dist = BlockCyclicMatrix.from_global(a, g, block)
    a_norm = dist_inf_norm(a_dist)
    scale = a_norm + np.linalg.norm(b, np.inf)
    t0 = time.perf_counter()
    x, ep_stats = lu_solve_dist(lu_dist, perm, b, pol, panel_wire=stats["panel_wire"])
    solve_seconds = time.perf_counter() - t0
    residuals = []
    with span("dist.hpl.refine", steps=refine_steps):
        for _ in range(refine_steps):
            r = -dist_residual(a_dist, x, b, policy=res_pol)  # b - A @ x
            residuals.append(float(np.linalg.norm(r, np.inf)) / scale)
            dx, s = lu_solve_dist(lu_dist, perm, r, pol, panel_wire=stats["panel_wire"])
            merge_stats(ep_stats, s)
            x = x + dx
        # the residual after the final update: refine_steps + 1 entries, as
        # refine_solve / run_hpl (the last is the converged one)
        r = -dist_residual(a_dist, x, b, policy=res_pol)
        residuals.append(float(np.linalg.norm(r, np.inf)) / scale)
    epilogue_seconds = time.perf_counter() - t0

    with span("dist.hpl.score"):
        resid = hpl_scaled_residual_dist(a_dist, x, b, a_inf_norm=a_norm)
    flops = hpl_flop_count(n)
    return {"n": n, "block": block, "grid": stats["grid"],
            "scheme": pol.scheme, "mode": pol.mode, "policy": pol.spec,
            "panel_wire": stats["panel_wire"],
            "mesh_collectives": stats["mesh_collectives"],
            "refine_steps": refine_steps, "scaled_residual": resid,
            "passed": resid <= HPL_THRESHOLD, "refine_history": residuals,
            "factor_seconds": factor_seconds, "solve_seconds": solve_seconds,
            # HPL's definition: the full op count over factor + solve wall
            # time (refinement and scoring excluded, as in HPL itself)
            "gflops": flops / (factor_seconds + solve_seconds) / 1e9,
            "wire_bytes": stats["wire_bytes"], "f64_bytes": stats["f64_bytes"],
            "swap_bytes": stats["swap_bytes"], "timings": stats["timings"],
            "epilogue_seconds": epilogue_seconds,
            "epilogue_wire_bytes": ep_stats["wire_bytes"],
            "epilogue_f64_bytes": ep_stats["f64_bytes"],
            "epilogue_timings": ep_stats["timings"]}
