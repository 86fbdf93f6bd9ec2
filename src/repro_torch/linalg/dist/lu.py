"""2-D block-cyclic right-looking LU with partial pivoting, plan-broadcast
panels, and one emulated GEMM per rank per step (the torch counterpart of
``repro/linalg/dist/lu.py``).

The algorithm is HPL's: at block step K (panel = block column K, owned by
process column ``qk = K mod Q``)

1. **Panel factorization**: for each panel column ``j`` every process row
   contributes its local pivot candidate (``blocks.pivot_argmax`` on its
   rank's device over its row subset of the column), the winner is resolved
   by an argmax-allreduce along the grid's row axis (ties -> smallest global
   row), and the pivot row is exchanged with row ``j`` across every process
   column (full rows, so packed dgetrf storage stays consistent on every
   rank). Scaling and the rank-1 update are rank-local elementwise host ops
   shared with the single-device path (``blocks.py``).
2. **U12**: L11 travels along process row ``pk = K mod P``; each rank of
   that row runs the unit-diagonal substitution on its rank's device over
   its local columns of the trailing block row.
3. **Panel broadcast**: process row p's slice of L21 is quantized ONCE on its
   owner rank (p, qk) and the plan wire format travels along the process row
   (``core.distributed.broadcast_plan``); U12 slices travel down process
   columns the same way. Receivers execute the prepared plans. Policies
   without plans (native, ozaki1) or ``panel_wire="f64"`` broadcast raw f64
   blocks instead, and receivers quantize; both wire formats are counted.
4. **Trailing update**: rank (p, q) applies ``A22 -= L21_p @ U12_q`` as ONE
   emulated GEMM between the received plans on its device: on a Hopper card
   K2 in fast mode (plans' parts), ``pair_exponents`` + K1 in accurate mode.

In fast mode the result is bitwise equal to the single-device
``linalg.lu_factor``: the per-rank work is elementwise, exact per output
element (residue GEMMs are error-free, and fast-mode scales are per row of
L21 and per column of U12), or column-independent by construction (the
substitution of ``blocks.solve_tri_tensor``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import resolve_device
from repro_torch.core.distributed import broadcast_f64, broadcast_plan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span
from repro_torch.precision import resolve_policy

from ..blas3 import DEFAULT_BLOCK, device_matmul, prepare
from ..blocks import pivot_argmax, rank1_update, scale_pivot_column, solve_triangular
from .grid import BlockCyclicMatrix, ProcessGrid

PANEL_WIRES = ("plans", "f64")


def as_grid(grid, device=None) -> ProcessGrid:
    """A ProcessGrid from a grid or (P, Q), on ``device`` (None: the card);
    a grid keeps its own device, and a different ``device`` raises."""
    if isinstance(grid, ProcessGrid):
        if device is not None and grid.entry_device != resolve_device(device):
            raise ValueError(f"{grid!r} runs on {grid.entry_device}, not {device}")
        return grid
    return ProcessGrid(*grid, device=device)


def resolve_panel_wire(pol, panel_wire: str | None) -> str:
    """Default + validate the broadcast wire format for a policy, shared by
    the factorization and the solve epilogue so they cannot diverge."""
    if panel_wire is None:
        return "plans" if pol.plans_enabled else "f64"
    if panel_wire not in PANEL_WIRES:
        raise ValueError(f"panel_wire must be one of {PANEL_WIRES}, got {panel_wire!r}")
    if panel_wire == "plans" and not pol.plans_enabled:
        raise ValueError(
            f"panel_wire='plans' needs a plan-capable policy, got {pol.spec!r}")
    return panel_wire


def broadcast_block(x: np.ndarray, role: str, pol, panel_wire: str, owner_dev, devs: list):
    """One panel broadcast from its owner: returns ``(owner's operand,
    received operands, payload bytes)``, one received operand for each of
    ``devs``. Plans: quantized once on the owner's device, the wire to each
    receiver. f64: the raw block travels and receivers quantize at their
    GEMM."""
    if panel_wire == "plans":
        owner = prepare(x, role, pol, device=owner_dev)
        recv, payload = broadcast_plan(owner, devs)
    else:
        recv, payload = broadcast_f64(x, devs)
        owner = broadcast_f64(x, [owner_dev])[0][0]
    return owner, recv, payload


def lu_factor_dist(a, policy=None, *, grid=(2, 2), block: int = DEFAULT_BLOCK,
                   panel_wire: str | None = None, target_rel_err: float | None = None,
                   device=None) -> tuple[BlockCyclicMatrix, np.ndarray, dict]:
    """Block-cyclic ``A[perm] = L @ U`` over a P x Q process grid, every
    rank's work on its device (the grid's; ``device`` for a (P, Q) tuple,
    None: the card).

    ``policy`` resolves like everywhere else (policy | spec | None ->
    context); ``target_rel_err`` lets ``resolve_for`` pick ``num_moduli``
    from A's exponent-range sketch. ``panel_wire``: ``"plans"`` (default
    for plan-capable policies: residue parts travel) or ``"f64"`` (raw
    blocks travel, receivers quantize). Returns ``(lu, perm, stats)``:
    the distributed packed factorization (``to_global()`` matches the
    single-device ``lu_factor`` storage), the pivot index vector, and the
    communication/timing accounting.
    """
    pol = resolve_policy(policy)
    g = as_grid(grid, device)
    a = np.asarray(a, dtype=np.float64)
    n, m = a.shape
    if n != m:
        raise ValueError(f"lu_factor_dist requires a square matrix, got {a.shape}")
    if target_rel_err is not None and pol.supports_plans:
        pol = pol.resolve_for(a, a, target_rel_err=target_rel_err)
    panel_wire = resolve_panel_wire(pol, panel_wire)

    A = BlockCyclicMatrix.from_global(a, g, block)
    nb = BlockCyclicMatrix.num_blocks(n, block)
    perm = np.arange(n)
    stats = {"policy": pol.spec, "grid": f"{g.nprow}x{g.npcol}", "n": n, "block": block,
             "panel_wire": panel_wire, "mesh_collectives": True,
             "wire_bytes": 0, "f64_bytes": 0, "swap_bytes": 0,
             "panel_bcast_bytes": 0, "pivot_collectives": 0,
             "timings": {"panel": 0.0, "trsm": 0.0, "broadcast": 0.0, "update": 0.0}}

    with span("dist.lu.factor", n=n, block=block, grid=stats["grid"], panel_wire=panel_wire):
        _factor_loop(A, perm, stats, pol, g, n, nb, block, panel_wire)
    # The communication accounting into the global registry, once per
    # factorization (the per-step loop stays registry-free).
    if obs_metrics.metrics_enabled():
        for key in ("wire_bytes", "f64_bytes", "swap_bytes", "panel_bcast_bytes"):
            obs_metrics.inc(f"dist.lu.{key}", float(stats[key]))
        obs_metrics.inc("dist.lu.pivot_collectives", float(stats["pivot_collectives"]))
        for phase, dt in stats["timings"].items():
            obs_metrics.observe("dist.lu.phase_seconds", dt, phase=phase)
    return A, perm, stats


def _panel(A: BlockCyclicMatrix, perm: np.ndarray, stats: dict, g: ProcessGrid, n: int,
           K: int, k0: int, k1: int) -> None:
    """Step 1: the unblocked pivoted factorization of panel K on process
    column qk."""
    P = g.nprow
    pk, qk = g.row_owner(K), g.col_owner(K)
    bw = k1 - k0
    lc0 = A.local_col(k0)  # the panel's local columns are contiguous
    for j in range(k0, k1):
        lj = lc0 + (j - k0)
        vals = np.full(P, -1.0)
        idxs = np.full(P, n, dtype=np.int64)
        starts = np.zeros(P, dtype=np.int64)
        for p in range(P):
            start = A.local_row(j) if p == pk else A.local_row_tail(p, K + 1)
            starts[p] = start
            seg = A.local(p, qk)[start:, lj]
            if seg.size:
                off, mag = pivot_argmax(seg, device=g.device(p, qk))
                vals[p] = mag
                idxs[p] = A.global_row(p, start + off)
        mag, piv = g.argmax_allreduce(vals, idxs)
        stats["pivot_collectives"] += 1
        if mag == 0.0:
            raise np.linalg.LinAlgError(f"singular: zero pivot column {j}")
        if piv != j:
            stats["swap_bytes"] += A.swap_rows(j, piv)
            perm[[j, piv]] = perm[[piv, j]]
        # the pivot row segment (columns j..k1) broadcast down the column
        ljrow = A.local_row(j)
        urow = A.local(pk, qk)[ljrow, lj + 1:lc0 + bw]
        ajj = A.local(pk, qk)[ljrow, lj]
        stats["panel_bcast_bytes"] += (urow.nbytes + 8) * (P - 1)
        for p in range(P):
            start = starts[p] if p != pk else ljrow + 1
            loc = A.local(p, qk)
            if loc.shape[0] <= start:
                continue
            loc[start:, lj] = scale_pivot_column(loc[start:, lj], ajj)
            rank1_update(loc[start:, lj + 1:lc0 + bw], loc[start:, lj], urow)


def _factor_loop(A: BlockCyclicMatrix, perm: np.ndarray, stats: dict, pol, g: ProcessGrid,
                 n: int, nb: int, b: int, panel_wire: str) -> None:
    P, Q = g.nprow, g.npcol
    for K in range(nb):
        # bw < b only for a ragged LAST panel, which never reaches the
        # broadcast/update phases (the loop breaks at k1 == n first).
        k0, k1 = K * b, min((K + 1) * b, n)
        pk, qk = g.row_owner(K), g.col_owner(K)

        with span("dist.lu.panel", step=K) as sp:
            _panel(A, perm, stats, g, n, K, k0, k1)
        stats["timings"]["panel"] += sp.elapsed
        if k1 == n:
            break

        # ---- 2. U12 on process row pk ----
        lr0, lc0 = A.local_row(k0), A.local_col(k0)
        with span("dist.lu.trsm", step=K) as sp:
            l11 = A.local(pk, qk)[lr0:lr0 + b, lc0:lc0 + b]
            l11_recv, l11_payload = broadcast_f64(l11, g.row_devices(pk, skip=qk))
            stats["f64_bytes"] += l11_payload * (Q - 1)
            stats["wire_bytes"] += l11_payload * (Q - 1)
            l11_by_q = dict(zip((q for q in range(Q) if q != qk), l11_recv))
            l11_by_q[qk] = l11
            for q in range(Q):
                ctail = A.local_col_tail(q, K + 1)
                loc = A.local(pk, q)
                if loc.shape[1] <= ctail:
                    continue
                loc[lr0:lr0 + b, ctail:] = solve_triangular(
                    l11_by_q[q], loc[lr0:lr0 + b, ctail:], lower=True, unit_diag=True,
                    device=g.device(pk, q))
        stats["timings"]["trsm"] += sp.elapsed

        # ---- 3. panel broadcasts (plans or f64 on the wire) ----
        with span("dist.lu.broadcast", step=K) as sp:
            l21_at: dict[tuple[int, int], object] = {}
            u12_at: dict[tuple[int, int], object] = {}
            for p in range(P):
                l21 = A.local(p, qk)[A.local_row_tail(p, K + 1):, lc0:lc0 + b]
                if not l21.shape[0]:
                    continue
                devs = g.row_devices(p, skip=qk)
                owner, recv, payload = broadcast_block(l21, "lhs", pol, panel_wire,
                                                       g.device(p, qk), devs)
                stats["wire_bytes"] += payload * (Q - 1)
                stats["f64_bytes"] += l21.nbytes * (Q - 1)
                l21_at[(p, qk)] = owner
                l21_at.update(zip(((p, q) for q in range(Q) if q != qk), recv))
            for q in range(Q):
                u12 = A.local(pk, q)[lr0:lr0 + b, A.local_col_tail(q, K + 1):]
                if not u12.shape[1]:
                    continue
                devs = g.col_devices(q, skip=pk)
                owner, recv, payload = broadcast_block(u12, "rhs", pol, panel_wire,
                                                       g.device(pk, q), devs)
                stats["wire_bytes"] += payload * (P - 1)
                stats["f64_bytes"] += u12.nbytes * (P - 1)
                u12_at[(pk, q)] = owner
                u12_at.update(zip(((p, q) for p in range(P) if p != pk), recv))
        stats["timings"]["broadcast"] += sp.elapsed

        # ---- 4. trailing update: ONE emulated GEMM per rank ----
        with span("dist.lu.update", step=K) as sp:
            for p in range(P):
                rtail = A.local_row_tail(p, K + 1)
                for q in range(Q):
                    ctail = A.local_col_tail(q, K + 1)
                    loc = A.local(p, q)
                    if loc.shape[0] <= rtail or loc.shape[1] <= ctail:
                        continue
                    upd = device_matmul(l21_at[(p, q)], u12_at[(p, q)], pol,
                                        device=g.device(p, q))
                    loc[rtail:, ctail:] -= upd.cpu().numpy()
        stats["timings"]["update"] += sp.elapsed
