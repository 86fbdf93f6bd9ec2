"""Solves on the emulated factorizations + mixed-precision refinement (the
torch counterpart of ``repro/linalg/solve.py``).

``refine_solve`` factors once under a (possibly fast-mode) policy, then
drives iterative refinement whose residual ``b - A @ x`` is computed through
the ACCURATE-mode emulation: the refinement GEMM's accuracy, not the
factorization's, sets the final solution quality. ``target_rel_err=``
resolves the factorization's ``num_moduli`` from the system matrix's
exponent-range sketch (``repro_torch.precision.resolve``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import resolve_device
from repro_torch.precision import resolve_policy

from .blas3 import DEFAULT_BLOCK, emulated_matmul, trsm
from .cholesky import cholesky
from .lu import lu_factor


def _as_cols(b) -> tuple[np.ndarray, bool]:
    b = np.asarray(b, dtype=np.float64)
    if b.ndim == 1:
        return b[:, None], True
    return b, False


def lu_solve(lu: np.ndarray, perm: np.ndarray, b, policy=None, *,
             block: int = DEFAULT_BLOCK, device=None) -> np.ndarray:
    """Solve A x = b given ``(lu, perm)`` from :func:`lu_factor`, on
    ``device`` (None: the card). Both sweeps run ``blas3.trsm`` on the packed
    factors; solved block-rows fold in elimination order."""
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    rhs, was_vec = _as_cols(b)
    y = trsm(lu, rhs[perm], pol, side="left", lower=True, unit_diag=True,
             block=block, device=dev)
    x = trsm(lu, y, pol, side="left", lower=False, block=block, device=dev)
    return x[:, 0] if was_vec else x


def cholesky_solve(l_fac: np.ndarray, b, policy=None, *,
                   block: int = DEFAULT_BLOCK, device=None) -> np.ndarray:
    """Solve A x = b given lower L from :func:`cholesky`, on ``device``."""
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    rhs, was_vec = _as_cols(b)
    y = trsm(l_fac, rhs, pol, side="left", lower=True, block=block, device=dev)
    x = trsm(l_fac, y, pol, side="left", lower=True, trans=True, block=block, device=dev)
    return x[:, 0] if was_vec else x


def refine_solve(a, b, policy=None, *, factor: str = "lu",
                 refine_steps: int = 2, block: int = DEFAULT_BLOCK,
                 residual_policy=None, target_rel_err: float | None = None,
                 device=None) -> tuple[np.ndarray, dict]:
    """Factor, solve, then ``refine_steps`` rounds of iterative refinement,
    on ``device`` (None: the card).

    The residual r = b - A x runs through ``residual_policy`` (default:
    ``policy`` forced to mode="accurate"), so a fast-mode factorization still
    converges to FP64-grade. ``target_rel_err`` resolves the factorization's
    ``num_moduli`` from A's exponent-range sketch (Ozaki-II policies only).
    Returns ``(x, info)`` where ``info["residuals"]`` is the relative
    inf-norm residual history (entry 0 = before any refinement) and
    ``info["policy"]`` the resolved spec.
    """
    if factor not in ("lu", "cholesky"):
        raise ValueError(f"factor must be 'lu' or 'cholesky', got {factor!r}")
    pol = resolve_policy(policy)
    dev = resolve_device(device)
    a = np.asarray(a, dtype=np.float64)
    rhs, was_vec = _as_cols(b)
    if target_rel_err is not None and pol.supports_plans:
        pol = pol.resolve_for(a, a, target_rel_err=target_rel_err)
    if residual_policy is None:
        res_pol = (dataclasses.replace(pol, mode="accurate")
                   if pol.is_emulated else pol)
    else:
        res_pol = resolve_policy(residual_policy)

    if factor == "lu":
        lu, perm = lu_factor(a, pol, block=block, device=dev)
        solve = lambda r: lu_solve(lu, perm, r, pol, block=block, device=dev)  # noqa: E731
    else:
        l_fac = cholesky(a, pol, block=block, device=dev)
        solve = lambda r: cholesky_solve(l_fac, r, pol, block=block, device=dev)  # noqa: E731

    scale = np.linalg.norm(a, np.inf) + np.linalg.norm(rhs, np.inf)
    x = solve(rhs)
    residuals = []
    for _ in range(refine_steps):
        r = rhs - emulated_matmul(a, x, res_pol, device=dev)
        residuals.append(float(np.linalg.norm(r, np.inf)) / scale)
        x = x + solve(r)
    r = rhs - emulated_matmul(a, x, res_pol, device=dev)
    residuals.append(float(np.linalg.norm(r, np.inf)) / scale)
    info = {"residuals": residuals, "refine_steps": refine_steps,
            "factor": factor, "scheme": pol.scheme,
            "policy": pol.spec, "residual_policy": res_pol.spec,
            "residual_scheme": res_pol.scheme}
    return (x[:, 0] if was_vec else x), info
