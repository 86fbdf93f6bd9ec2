"""Distributed triangular-solve epilogue (the torch counterpart of
``repro/linalg/dist/trsm.py``): block-cyclic forward/backward substitution
on the packed LU factors, without ever gathering them.

``lu_solve_dist`` is the O(n^2) companion of ``lu_factor_dist``: pivot
apply, then a unit-lower forward sweep and a general-upper backward sweep
over the block-cyclic factors. The right-hand side lives as block-row
segments on the grid's **rhs process column** (column 0, HPL's appended b
column). Per block step K (diagonal block owner ``(pk, qk) = (K mod P, K
mod Q)``):

1. the rhs segment of block row K travels from the rhs column to the
   diagonal owner (a no-op when ``qk == 0``), which runs the substitution on
   its device (``blocks.solve_triangular``: unit diagonal for L, general for
   U, the solve ``blas3.trsm`` uses) and sends the solved x_K back;
2. x_K is broadcast down process column ``qk``: as a plan wire (quantized
   ONCE on the owner, ``panel_wire="plans"``) or as raw f64 with receivers
   quantizing (``"f64"``), as the factorization's panels;
3. every rank ``(p, qk)`` applies its off-diagonal update, the trailing
   (forward) or leading (backward) local rows of block column K against the
   received x_K, as ONE emulated GEMM per rank on its device (K2 on a Hopper
   card in fast mode, K1 in accurate mode), and ships the f64 update back to
   the rhs column, where it is subtracted.

In fast mode with a plan-capable policy the result is bitwise equal to the
single-device ``solve.lu_solve`` on the gathered factors: the per-rank GEMMs
see row subsets of the same block pairings (fast-mode lhs scales are per
row), updates are subtracted in elimination order (``blas3.trsm``'s fold
order), and the diagonal solves are the shared column-independent
substitution. Plan-less policies differ only in contraction grouping and
agree to FP64 grade.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span
from repro_torch.precision import resolve_policy

from ..blas3 import device_matmul
from ..blocks import solve_triangular
from .grid import BlockCyclicMatrix
from .lu import broadcast_block, resolve_panel_wire


def _empty_stats(panel_wire: str) -> dict:
    return {"panel_wire": panel_wire, "wire_bytes": 0, "f64_bytes": 0, "solve_bcasts": 0,
            "timings": {"pivot": 0.0, "l_solve": 0.0, "u_solve": 0.0}}


def merge_stats(into: dict, other: dict) -> None:
    """Accumulate one solve's accounting into another's (refinement loops)."""
    for key in ("wire_bytes", "f64_bytes", "solve_bcasts"):
        into[key] += other[key]
    for phase, dt in other["timings"].items():
        into["timings"][phase] += dt


def _substitution_sweep(A: BlockCyclicMatrix, y: dict[int, np.ndarray], pol, *,
                        lower: bool, panel_wire: str, stats: dict) -> None:
    """One distributed substitution sweep over the packed factors, in place.

    ``y`` maps process row -> that row's rhs segments (local row packing,
    resident on the rhs process column). Forward (``lower``, unit diagonal)
    runs block steps ascending, backward (upper, general diagonal)
    descending: updates hit each block row in elimination order, the
    single-device fold order."""
    g = A.grid
    n, b = A.shape[0], A.block
    nb = BlockCyclicMatrix.num_blocks(n, b)
    P = g.nprow
    for K in (range(nb) if lower else range(nb - 1, -1, -1)):
        k0, k1 = K * b, min((K + 1) * b, n)
        bw = k1 - k0
        pk, qk = g.row_owner(K), g.col_owner(K)
        lr0, lc0 = A.local_row(k0), A.local_col(k0)

        # 1. diagonal solve on the owner (rhs segment travels rhs-col <-> qk)
        r_k = y[pk][lr0:lr0 + bw]
        if qk != 0:
            stats["wire_bytes"] += r_k.nbytes
            stats["f64_bytes"] += r_k.nbytes
        diag = A.local(pk, qk)[lr0:lr0 + bw, lc0:lc0 + bw]
        x_k = solve_triangular(diag, r_k, lower=lower, unit_diag=lower,
                               device=g.device(pk, qk))
        y[pk][lr0:lr0 + bw] = x_k
        if qk != 0:  # the solved segment returns to the rhs column
            stats["wire_bytes"] += x_k.nbytes
            stats["f64_bytes"] += x_k.nbytes

        # off-diagonal segments (forward: local rows below block K; backward:
        # rows above it); the last step of a sweep has none, and then nothing
        # is quantized or broadcast
        segs = {}
        for p in range(P):
            seg = (slice(A.local_row_tail(p, K + 1), None) if lower
                   else slice(0, A.local_row_tail(p, K)))
            t_blk = A.local(p, qk)[seg, lc0:lc0 + bw]
            if t_blk.shape[0]:
                segs[p] = (seg, t_blk)
        if not segs:
            continue

        # 2. x_K down process column qk (plans or f64 on the wire)
        devs = g.col_devices(qk, skip=pk)
        owner, recv, payload = broadcast_block(x_k, "rhs", pol, panel_wire,
                                               g.device(pk, qk), devs)
        stats["wire_bytes"] += payload * (P - 1)
        stats["f64_bytes"] += x_k.nbytes * (P - 1)
        stats["solve_bcasts"] += 1
        x_at = dict(zip((p for p in range(P) if p != pk), recv))
        x_at[pk] = owner

        # 3. off-diagonal update: ONE emulated GEMM per rank of column qk
        for p, (seg, t_blk) in segs.items():
            upd = device_matmul(t_blk, x_at[p], pol, device=g.device(p, qk)).cpu().numpy()
            y[p][seg] -= upd
            if qk != 0:  # the update travels back to the rhs column
                stats["wire_bytes"] += upd.nbytes
                stats["f64_bytes"] += upd.nbytes


def lu_solve_dist(lu: BlockCyclicMatrix, perm: np.ndarray, b, policy=None, *,
                  panel_wire: str | None = None) -> tuple[np.ndarray, dict]:
    """Solve ``A x = b`` from the distributed ``(lu, perm)`` of
    :func:`lu_factor_dist`, the triangular sweeps distributed over its grid
    (on the grid's devices).

    ``b`` is a vector or (n, nrhs) matrix; ``panel_wire`` selects the x_K
    broadcast format as in the factorization (default: plans when the
    policy supports them). Returns ``(x, stats)`` with per-phase timings and
    bytes on the wire."""
    pol = resolve_policy(policy)
    panel_wire = resolve_panel_wire(pol, panel_wire)
    n = lu.shape[0]
    rhs = np.asarray(b, dtype=np.float64)
    was_vec = rhs.ndim == 1
    if was_vec:
        rhs = rhs[:, None]
    if rhs.shape[0] != n:
        raise ValueError(f"rhs rows {rhs.shape[0]} != matrix dim {n}")
    stats = _empty_stats(panel_wire)

    with span("dist.trsm.solve", n=n, nrhs=rhs.shape[1], panel_wire=panel_wire):
        # pivot apply + scatter: O(n nrhs) vector work, like HPL's pivoting
        # of the appended rhs column; each process row's segment lives on the
        # rhs process column (column 0)
        with span("dist.trsm.pivot") as sp:
            z = rhs[np.asarray(perm)]
            y = {p: z[lu.global_rows(p)].copy() for p in range(lu.grid.nprow)}
        stats["timings"]["pivot"] += sp.elapsed
        with span("dist.trsm.l_solve") as sp:
            _substitution_sweep(lu, y, pol, lower=True, panel_wire=panel_wire, stats=stats)
        stats["timings"]["l_solve"] += sp.elapsed
        with span("dist.trsm.u_solve") as sp:
            _substitution_sweep(lu, y, pol, lower=False, panel_wire=panel_wire, stats=stats)
        stats["timings"]["u_solve"] += sp.elapsed

    if obs_metrics.metrics_enabled():
        obs_metrics.inc("dist.trsm.wire_bytes", float(stats["wire_bytes"]))
        obs_metrics.inc("dist.trsm.f64_bytes", float(stats["f64_bytes"]))
        obs_metrics.inc("dist.trsm.solve_bcasts", float(stats["solve_bcasts"]))
        for phase, dt in stats["timings"].items():
            obs_metrics.observe("dist.trsm.phase_seconds", dt, phase=phase)

    x = np.empty_like(rhs)
    for p, seg in y.items():
        x[lu.global_rows(p)] = seg
    return (x[:, 0] if was_vec else x), stats
