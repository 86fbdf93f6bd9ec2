"""Block operations of the blocked factorizations (the torch counterpart of
``repro/linalg/blocks.py``): the pivot search and the diagonal-block
triangular solves run on the entry point's device with torch ops; the
unblocked panel updates are host numpy, as in the reference.

* ``pivot_argmax`` — |column| argmax on the device; ties break to the
  smallest index (``torch.argmax`` returns the first maximal index, as
  ``np.argmax`` and ``jnp.argmax`` do).
* ``solve_triangular`` — the diagonal-block solve as a row-substitution loop
  in the reference's elimination order, unit diagonal (no divides) or
  general diagonal (one divide per eliminated row).

The reference pads the column and the right-hand side to a power of two so
that its jitted kernels compile O(log n) times; PyTorch runs eagerly, so the
port does not pad. Each row's reduction ``sum_j t[i, j] * x_j`` is summed in
torch's order, not XLA's (which lowers the reference's scan body in an order
that neither ``torch.sum`` nor a sequential sum reproduces), so the solves
agree with the reference to rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gemm import resolve_device


def as_tensor(x, dev: torch.device) -> torch.Tensor:
    """A float64 tensor on ``dev`` that shares no memory with ``x`` (numpy
    or a tensor), so no tensor aliases a host matrix that a factorization
    updates in place."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64, copy=True)
    return torch.tensor(np.asarray(x, dtype=np.float64), device=dev)


def pivot_argmax(col, *, device=None) -> tuple[int, float]:
    """Partial-pivot search over one column segment on ``device`` (None: the
    card). Returns ``(offset, |value|)`` of the largest-magnitude entry, the
    smallest offset among ties."""
    a = as_tensor(col, resolve_device(device)).abs()
    i = torch.argmax(a)
    idx, mag = torch.stack((i.to(torch.float64), a[i])).tolist()
    return int(idx), mag


def solve_tri_tensor(t: torch.Tensor, rhs: torch.Tensor, *, lower: bool,
                     unit_diag: bool) -> torch.Tensor:
    """``solve_triangular`` on float64 tensors of one device, returning a
    tensor there: row ``i`` (in elimination order) is
    ``x_i = (rhs_i - sum_j t[i, j] * x_j) / t_ii``, the sum over the strict
    triangle of ``t`` (so unsolved rows, still holding ``rhs``, are masked,
    and the strict OTHER triangle is ignored: packed dgetrf storage passes
    raw). ``rhs`` is (n, w); the divide is skipped for a unit diagonal."""
    n = t.shape[0]
    diag = torch.diagonal(t)
    if not unit_diag and not bool((diag != 0.0).all()):
        raise np.linalg.LinAlgError("singular triangular factor: zero diagonal")
    strict = torch.tril(t, -1) if lower else torch.triu(t, 1)
    x = rhs.clone()
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        xi = x[i] - torch.sum(strict[i][:, None] * x, dim=0)
        if not unit_diag:
            xi = xi / diag[i]
        x[i] = xi
    return x


def solve_triangular(t, rhs, *, lower: bool, unit_diag: bool = False,
                     device=None) -> np.ndarray:
    """Diagonal-block triangular solve on ``device`` (None: the card), unit
    or general diagonal; host numpy in and out (``rhs`` (n,) or (n, w))."""
    dev = resolve_device(device)
    rhs = as_tensor(rhs, dev)
    vec = rhs.ndim == 1
    out = solve_tri_tensor(as_tensor(t, dev), rhs[:, None] if vec else rhs,
                           lower=lower, unit_diag=unit_diag).cpu().numpy()
    return out[:, 0] if vec else out


def scale_pivot_column(col_seg: np.ndarray, pivot: float) -> np.ndarray:
    """L-column formation ``col / pivot`` (host, elementwise)."""
    return col_seg / pivot


def rank1_update(tail: np.ndarray, l_col: np.ndarray, u_row: np.ndarray) -> None:
    """In-place ``tail -= outer(l_col, u_row)``: the unblocked panel update
    (host, elementwise per (i, j))."""
    tail -= np.outer(l_col, u_row)
