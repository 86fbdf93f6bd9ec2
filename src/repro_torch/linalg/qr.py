"""Blocked Householder QR with compact-WY trailing updates (emulated GEMMs);
the torch counterpart of ``repro/linalg/qr.py``.

Per panel: an unblocked Householder factorization builds (V, T) in host fp64
(small, O(m·b^2)); the cubic trailing update A := (I - V T V^T)^T A is then
exactly two emulated GEMMs — Y = V^T @ A (emulated), Z = T^T @ Y (small host
product), A -= V @ Z (emulated). Q is reconstructed the same way, so QR is
GEMM-dominant end to end like LAPACK's dgeqrf/dorgqr pair.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import resolve_device
from repro_torch.precision import PrecisionPolicy, resolve_policy

from .blas3 import DEFAULT_BLOCK, emulated_matmul


def _householder(x: np.ndarray) -> tuple[np.ndarray, float, float]:
    """LAPACK dlarfg: v (v[0] = 1), tau, beta with (I - tau v v^T) x = beta e1."""
    normx = np.linalg.norm(x)
    alpha = x[0]
    if normx == 0.0 or normx == abs(alpha):  # already +-beta e1
        return np.concatenate(([1.0], np.zeros(x.size - 1))), 0.0, float(alpha)
    beta = -np.copysign(normx, alpha)
    v = x / (alpha - beta)
    v[0] = 1.0
    tau = (beta - alpha) / beta
    return v, float(tau), float(beta)


def _panel_qr(panel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """In-place Householder QR of a tall panel; returns compact-WY (V, T).

    On return ``panel`` holds R in its upper triangle (zeros below);
    H_1 H_2 ... H_b = I - V @ T @ V.T with V unit lower trapezoidal and T
    upper triangular (LAPACK dlarft, columnwise/forward).
    """
    m, b = panel.shape
    v_mat = np.zeros((m, b))
    t_mat = np.zeros((b, b))
    for j in range(b):
        v, tau, beta = _householder(panel[j:, j].copy())
        v_mat[j:, j] = v
        if j + 1 < b:  # apply H_j to the rest of the panel (host fp64)
            w = v @ panel[j:, j + 1:]
            panel[j:, j + 1:] -= tau * np.outer(v, w)
        panel[j, j] = beta
        panel[j + 1:, j] = 0.0
        if j > 0:
            t_mat[:j, j] = -tau * (t_mat[:j, :j] @ (v_mat[j:, :j].T @ v))
        t_mat[j, j] = tau
    return v_mat, t_mat


def _apply_block_reflector(v: np.ndarray, t: np.ndarray, c: np.ndarray,
                           pol: PrecisionPolicy, *, trans: bool, device) -> None:
    """C := (I - V T V^T)^op C in place; the two tall products are emulated."""
    y = emulated_matmul(v.T, c, pol, device=device)  # emulated GEMM 1: V^T C
    z = (t.T if trans else t) @ y                    # small b x b, host fp64
    c -= emulated_matmul(v, z, pol, device=device)   # emulated GEMM 2: V Z


def qr(a, policy=None, *, block: int = DEFAULT_BLOCK, mode: str = "reduced",
       device=None):
    """Blocked Householder QR of an m x n matrix (m >= n), its GEMMs on
    ``device`` (None: the card).

    ``policy`` is a ``PrecisionPolicy`` / spec string / None (precision
    context). mode="reduced" -> (Q, R) with Q m x n orthonormal columns,
    R n x n upper; mode="r" -> R only (skips the Q reconstruction GEMMs).
    """
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = np.array(a, dtype=np.float64)
    m, n = a.shape
    if m < n:
        raise ValueError(f"qr requires m >= n, got {a.shape}")
    if mode not in ("reduced", "r"):
        raise ValueError(f"mode must be 'reduced' or 'r', got {mode!r}")
    factors: list[tuple[int, np.ndarray, np.ndarray]] = []
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        v, t = _panel_qr(a[k0:, k0:k1])
        factors.append((k0, v, t))
        if k1 < n:  # trailing update A := Q_panel^T A — two emulated GEMMs
            _apply_block_reflector(v, t, a[k0:, k1:], pol, trans=True, device=dev)
    r = np.triu(a[:n])
    if mode == "r":
        return r
    # Q = (I - V1 T1 V1^T)(I - V2 T2 V2^T)... applied to I_{m x n}, built by
    # sweeping the block reflectors in reverse (dorgqr) — same two-GEMM shape.
    q = np.eye(m, n)
    for k0, v, t in reversed(factors):
        _apply_block_reflector(v, t, q[k0:], pol, trans=False, device=dev)
    return q, r
