"""Block operations of the blocked factorizations (the torch counterpart of
``repro/linalg/blocks.py``): the pivot search and the diagonal-block
triangular solves run on the entry point's device with torch ops; the
unblocked panel updates are host numpy, as in the reference.

* ``pivot_argmax`` — |column| argmax on the device; ties break to the
  smallest index (``torch.argmax`` returns the first maximal index, as
  ``np.argmax`` and ``jnp.argmax`` do).
* ``solve_triangular`` — the diagonal-block solve in the reference's
  elimination order, unit diagonal (no divides) or general diagonal (one
  divide per eliminated row).

The reference pads the column and the right-hand side to a power of two so
that its jitted kernels compile O(log n) times; PyTorch runs eagerly, so the
port does not pad. The reference's scan sums each row's ``sum_j t[i, j] *
x_j`` in the order XLA lowers its body to. The port keeps, for every row, a
running sum of the products of the rows solved so far (one product and one
addition a solved row, both elementwise), so row i's sum is taken j by j in
elimination order. For a lower solve that is XLA's order on blocks of up to
32 rows, bit for bit (longer ones XLA sums in another order, which no torch
reduction reproduces; an upper solve's elimination order is the reverse of
XLA's): the solves agree with the reference to rounding, and bitwise on
small blocks. Every element of the solution depends on its own column
alone, in an order fixed by the triangle, whatever the width of the
right-hand side and on any device, so a block-cyclic rank that solves a
subset of the columns (``linalg.dist``) gets the bits of the whole solve.
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
    tensor there: in elimination order, ``x_i = (rhs_i - s_i) / t_ii`` (no
    divide for a unit diagonal), where ``s_i`` is the running sum of
    ``t[i, j] * x_j`` over the rows j solved before it, added as each is
    solved. Only the strict triangle of ``t`` is read (packed dgetrf storage
    passes raw). ``rhs`` is (n, w)."""
    n = t.shape[0]
    diag = torch.diagonal(t)
    if not unit_diag and not bool((diag != 0.0).all()):
        raise np.linalg.LinAlgError("singular triangular factor: zero diagonal")
    x = rhs.clone()
    sums = torch.zeros_like(x)
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        xi = x[i] - sums[i]
        if not unit_diag:
            xi = xi / diag[i]
        x[i] = xi
        later = slice(i + 1, n) if lower else slice(0, i)
        sums[later] += t[later, i:i + 1] * xi
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
