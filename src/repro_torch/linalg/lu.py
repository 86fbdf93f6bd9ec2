"""Right-looking blocked LU with partial pivoting, trailing update emulated
(the torch counterpart of ``repro/linalg/lu.py``).

Per panel step, one blocked TRSM forms U12 and the rank-b trailing update
A22 -= L21 @ U12 applies >= 2/3 of all flops for b << n. Under Ozaki-II
policies the trailing update pairs a prepared L21 panel plan with U12, so on
a Hopper card in fast mode each step is one launch of the fused kernel from
parts (K2); the per-step reuse lives in the U12 TRSM (blas3.trsm).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import resolve_device
from repro_torch.precision import resolve_policy

from .blas3 import DEFAULT_BLOCK, device_matmul, gemm, prepare, trsm
from .blocks import pivot_argmax, rank1_update, scale_pivot_column


def lu_factor(a, policy=None, *, block: int = DEFAULT_BLOCK, device=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Factor square A with partial pivoting on ``device`` (None: the card):
    ``A[perm] = L @ U``.

    ``policy`` is a ``PrecisionPolicy`` / spec string / None (precision
    context). Returns ``(lu, perm)``, host numpy: ``lu`` packs unit-lower L
    (implicit diagonal) below U (LAPACK dgetrf storage), ``perm`` is the row
    permutation as an index vector (apply as ``a[perm]`` / ``b[perm]``).
    """
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = np.array(a, dtype=np.float64)  # owned copy, factored in place
    n, m = a.shape
    if n != m:
        raise ValueError(f"lu_factor requires a square matrix, got {a.shape}")
    perm = np.arange(n)
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        # Panel: unblocked partial-pivoting LU of a[k0:, k0:k1]. Row swaps
        # apply to the FULL rows, so the packed storage stays consistent.
        # The pivot search runs on the device; the O(n·b^2) updates on the
        # host.
        for j in range(k0, k1):
            off, mag = pivot_argmax(a[j:, j], device=dev)
            p = j + off
            if mag == 0.0:
                raise np.linalg.LinAlgError(f"singular: zero pivot column {j}")
            if p != j:
                a[[j, p]] = a[[p, j]]
                perm[[j, p]] = perm[[p, j]]
            a[j + 1:, j] = scale_pivot_column(a[j + 1:, j], a[j, j])
            rank1_update(a[j + 1:, j + 1:k1], a[j + 1:, j], a[j, j + 1:k1])
        if k1 == n:
            break
        # U12 := L11^{-1} A12, blocked TRSM
        a[k0:k1, k1:] = trsm(a[k0:k1, k0:k1], a[k0:k1, k1:], pol,
                             side="left", lower=True, unit_diag=True,
                             block=block, device=dev)
        # trailing update A22 -= L21 @ U12: THE emulated DGEMM of the step,
        # from the prepared L21 panel under plan-capable policies.
        if pol.plans_enabled:
            l21 = prepare(a[k1:, k0:k1], "lhs", pol, device=dev)
            a[k1:, k1:] -= device_matmul(l21, a[k0:k1, k1:], pol, device=dev).cpu().numpy()
        else:
            a[k1:, k1:] = gemm(a[k1:, k0:k1], a[k0:k1, k1:], pol,
                               alpha=-1.0, beta=1.0, c=a[k1:, k1:], device=dev)
    return a, perm


def lu_unpack(lu: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split packed dgetrf storage into (unit-lower L, upper U)."""
    n = lu.shape[0]
    return np.tril(lu, -1) + np.eye(n), np.triu(lu)
