"""Blocked BLAS-3 on the emulated GEMM: gemm (alpha/beta), TRSM, SYRK (the
torch counterpart of ``repro/linalg/blas3.py``).

Layout contract shared by the whole subsystem, as in the reference: matrices
are host numpy float64 at the API boundary; each cubic-flop update is ONE
``backend_matmul`` call on the entry point's device (``device=None``: the
card), emulated per the active :class:`PrecisionPolicy`; the O(n^2·b)
triangular bookkeeping stays on the host, except the pivot search and the
diagonal-block solves (``blocks.py``), which run on the device.

Operand reuse (core.plan): under Ozaki-II schemes the blocked kernels
quantize each block ONCE and reuse the prepared ``QuantizedMatrix`` across
every GEMM it takes part in. TRSM caches each solved block-row as a rhs plan
(reused by all later block steps) and keeps its block intermediates on the
device; SYRK prepares each block-row pair once for its whole tile row and
column. On a Hopper card those pairings run on the fused kernel from parts
(K2, ``ozmm_fused_parts``) in fast mode. Schemes with no plan support
(native, ozaki1) and policies with ``cache_plans=False`` keep the single
GEMM per step path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend_matmul, prepare_operand, resolve_device
from repro_torch.core.plan import QuantizedMatrix
from repro_torch.precision import resolve_policy

from .blocks import as_tensor, solve_tri_tensor, solve_triangular

#: Default panel/block width, the reference's.
DEFAULT_BLOCK = 128


def _as_f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def emulated_matmul(a, b, policy=None, *, device=None) -> np.ndarray:
    """One emulated GEMM on ``device``: host f64 in, host f64 out, scheme per
    ``policy``. Either side may be a prepared ``QuantizedMatrix`` (its cached
    quantization is reused)."""
    return device_matmul(a, b, policy, device=device).cpu().numpy()


def device_matmul(a, b, policy=None, *, device=None) -> torch.Tensor:
    """Emulated GEMM whose result stays on ``device``; operands may be host
    numpy, tensors, or prepared plans."""
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = a if isinstance(a, QuantizedMatrix) else as_tensor(a, dev)
    b = b if isinstance(b, QuantizedMatrix) else as_tensor(b, dev)
    return backend_matmul(a, b, pol, device=dev)


def prepare(x, role: str, policy=None, *, device=None):
    """Quantize a block once for reuse on ``device`` (no-op for plan-less
    schemes)."""
    dev = resolve_device(device)
    return prepare_operand(as_tensor(x, dev), role, resolve_policy(policy), device=dev)


def gemm(a, b, policy=None, *, alpha: float = 1.0, beta: float = 0.0,
         c=None, device=None) -> np.ndarray:
    """C := alpha * A @ B + beta * C (BLAS dgemm semantics).

    The product is a single emulated GEMM (operands may be prepared plans);
    the axpy is host f64.
    """
    out = emulated_matmul(a, b, policy, device=device)
    if alpha != 1.0:
        out = alpha * out
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        out = out + beta * _as_f64(c)
    return out


def trsm(a, b, policy=None, *, side: str = "left", lower: bool = True,
         trans: bool = False, unit_diag: bool = False,
         block: int = DEFAULT_BLOCK, device=None) -> np.ndarray:
    """Blocked triangular solve (BLAS dtrsm): returns X with

        side="left":   op(A) @ X = B
        side="right":  X @ op(A) = B

    where op(A) = A.T if ``trans`` else A, and A is (``lower``) triangular
    with an implicit unit diagonal when ``unit_diag``.

    Plan-capable policies run the reusing solve: each solved block-row is
    quantized once (as a GEMM rhs plan) and folded into every later block
    step's elimination, with all block intermediates on the device; the
    elimination sum is accumulated per solved block in f64.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = _as_f64(a)
    b = _as_f64(b)
    # Reduce to the two left/no-trans canonical forms:
    #   X A = B         <=>  A^T X^T = B^T      (side flip transposes A)
    #   A^T X = B       <=>  solve with A^T     (trans folds into the triangle)
    if side == "right":
        return trsm(a, b.T, pol, side="left", lower=lower, trans=not trans,
                    unit_diag=unit_diag, block=block, device=dev).T
    if trans:
        a, lower = a.T, not lower
    n = a.shape[0]
    if a.shape[1] != n or b.shape[0] != n:
        raise ValueError(f"trsm shape mismatch: A {a.shape}, B {b.shape}")

    starts = list(range(0, n, block))
    if not lower:
        starts = starts[::-1]  # upper-triangular solves run bottom-up

    if not pol.plans_enabled:
        # One emulated GEMM folds the whole solved prefix.
        x = b.copy()
        for i0 in starts:
            i1 = min(i0 + block, n)
            if lower and i0 > 0:
                x[i0:i1] -= emulated_matmul(a[i0:i1, :i0], x[:i0], pol, device=dev)
            elif not lower and i1 < n:
                x[i0:i1] -= emulated_matmul(a[i0:i1, i1:], x[i1:], pol, device=dev)
            x[i0:i1] = solve_triangular(a[i0:i1, i0:i1], x[i0:i1], lower=lower,
                                        unit_diag=unit_diag, device=dev)
        return x

    a_dev = as_tensor(a, dev)
    b_dev = as_tensor(b, dev)
    solved: dict[int, torch.Tensor] = {}    # i0 -> solved block (device)
    plans: dict[int, QuantizedMatrix] = {}  # i0 -> rhs plan (quantized ONCE)
    for i0 in starts:
        i1 = min(i0 + block, n)
        acc = b_dev[i0:i1]
        # Fold in the already-solved block rows IN ELIMINATION ORDER (dict
        # insertion order = the starts sequence, descending for upper
        # solves), never sorted(): the reference's fold contract. Each fold
        # uses the block's cached residue plan, quantized at first use (a
        # single-block solve never pays for a plan).
        for j0 in solved:
            if (lower and j0 < i0) or (not lower and j0 > i0):
                j1 = min(j0 + block, n)
                if j0 not in plans:
                    plans[j0] = prepare(solved[j0], "rhs", pol, device=dev)
                acc = acc - device_matmul(a_dev[i0:i1, j0:j1], plans[j0], pol, device=dev)
        solved[i0] = solve_tri_tensor(a_dev[i0:i1, i0:i1], acc, lower=lower,
                                      unit_diag=unit_diag)
    # Assemble by placement at each block's row index (no key sort).
    x_out = np.empty_like(b)
    for i0, xi in solved.items():
        x_out[i0:i0 + xi.shape[0]] = xi.cpu().numpy()
    return x_out


def syrk(a, policy=None, *, alpha: float = 1.0, beta: float = 0.0,
         c=None, block: int = DEFAULT_BLOCK, device=None) -> np.ndarray:
    """Symmetric rank-k update: C := alpha * A @ A.T + beta * C.

    Blocked over block-row pairs (i, j <= i), one emulated GEMM per
    sub-diagonal block pair; the upper triangle is filled by symmetry, and
    the diagonal blocks are symmetrized, so the update is exactly symmetric.
    Plan-capable policies quantize each block-row exactly twice (once as a
    GEMM lhs, once transposed as a rhs) instead of once per tile: every
    tile is a plan x plan pairing.
    """
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = _as_f64(a)
    n = a.shape[0]
    prod = np.empty((n, n))
    blocks = list(range(0, n, block))
    lhs_plans: dict[int, object] = {}
    rhs_plans: dict[int, object] = {}
    use_plans = pol.plans_enabled
    if use_plans:
        for i0 in blocks:
            i1 = min(i0 + block, n)
            lhs_plans[i0] = prepare(a[i0:i1], "lhs", pol, device=dev)
            rhs_plans[i0] = prepare(a[i0:i1].T, "rhs", pol, device=dev)
    for i0 in blocks:
        i1 = min(i0 + block, n)
        for j0 in range(0, i1, block):
            j1 = min(j0 + block, n)
            if use_plans:
                blk = emulated_matmul(lhs_plans[i0], rhs_plans[j0], pol, device=dev)
            else:
                blk = emulated_matmul(a[i0:i1], a[j0:j1].T, pol, device=dev)
            prod[i0:i1, j0:j1] = blk
            if j0 < i0:
                prod[j0:j1, i0:i1] = blk.T
            else:  # diagonal block: enforce exact symmetry
                prod[i0:i1, j0:j1] = (blk + blk.T) / 2.0
    out = alpha * prod if alpha != 1.0 else prod
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        out = out + beta * _as_f64(c)
    return out
