"""Blocked right-looking Cholesky (lower), SYRK trailing update emulated (the
torch counterpart of ``repro/linalg/cholesky.py``).

The SYRK trailing update inherits the plan reuse from blas3.syrk: under
Ozaki-II policies each panel block-row is quantized once (as lhs and as
transposed rhs) and reused across its whole tile row/column of A22.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import resolve_device
from repro_torch.precision import resolve_policy

from .blas3 import DEFAULT_BLOCK, syrk, trsm


def cholesky(a, policy=None, *, block: int = DEFAULT_BLOCK, device=None) -> np.ndarray:
    """Lower-triangular L with ``A = L @ L.T`` for SPD A, on ``device``
    (None: the card).

    Per block step: host fp64 Cholesky of the (already-updated) diagonal
    block, blocked TRSM for the panel ``L21 = A21 @ L11^{-T}``, and an
    emulated SYRK trailing update ``A22 -= L21 @ L21.T`` (the cubic term).
    """
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = np.array(a, dtype=np.float64)
    n, m = a.shape
    if n != m:
        raise ValueError(f"cholesky requires a square matrix, got {a.shape}")
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        a[k0:k1, k0:k1] = np.linalg.cholesky(a[k0:k1, k0:k1])
        if k1 == n:
            break
        a[k1:, k0:k1] = trsm(a[k0:k1, k0:k1], a[k1:, k0:k1], pol,
                             side="right", lower=True, trans=True,
                             block=block, device=dev)
        a[k1:, k1:] = syrk(a[k1:, k0:k1], pol, alpha=-1.0, beta=1.0,
                           c=a[k1:, k1:], block=block, device=dev)
    return np.tril(a)
