"""HPL-style accuracy harness (the torch counterpart of
``repro/linalg/hpl.py``): HPL accepts a solve when the scaled residual

    ||A x - b||_inf / (eps * (||A||_inf * ||x||_inf + ||b||_inf) * n)  <= 16

The residual metric itself is computed in plain host fp64: it is the
yardstick, not the thing under test.
"""
from __future__ import annotations

import numpy as np

from repro_torch.precision import resolve_policy

from .blas3 import DEFAULT_BLOCK
from .solve import refine_solve

#: Standard HPL pass threshold for the scaled residual.
HPL_THRESHOLD = 16.0


def hpl_flop_count(n: int) -> float:
    """The HPL operation count: 2/3 n^3 + 3/2 n^2 (factorization + solve),
    the numerator of every HPL GFLOP/s figure."""
    return 2.0 * n**3 / 3.0 + 1.5 * n**2


def hpl_matrix(n: int, *, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The HPL test problem: A, b ~ uniform(-0.5, 0.5) (needs pivoting)."""
    rng = np.random.default_rng(seed)
    return rng.random((n, n)) - 0.5, rng.random(n) - 0.5


def hpl_scaled_residual(a: np.ndarray, x: np.ndarray, b: np.ndarray) -> float:
    """||Ax - b||_inf / (eps * (||A||_inf ||x||_inf + ||b||_inf) * n)."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = a.shape[0]
    eps = np.finfo(np.float64).eps
    r = np.linalg.norm(a @ x - b, np.inf)
    denom = eps * (np.linalg.norm(a, np.inf) * np.linalg.norm(x, np.inf)
                   + np.linalg.norm(b, np.inf)) * n
    return float(r / denom)


def run_hpl(n: int, policy=None, *, block: int = DEFAULT_BLOCK,
            refine_steps: int = 1, seed: int = 0, device=None) -> dict:
    """Factor/solve the HPL problem under ``policy`` (PrecisionPolicy / spec
    string / None -> precision context) on ``device`` (None: the card) and
    score it HPL-style."""
    pol = resolve_policy(policy)
    a, b = hpl_matrix(n, seed=seed)
    x, info = refine_solve(a, b, pol, factor="lu", refine_steps=refine_steps,
                           block=block, device=device)
    resid = hpl_scaled_residual(a, x, b)
    return {"n": n, "block": block, "scheme": pol.scheme, "mode": pol.mode,
            "policy": pol.spec, "refine_steps": refine_steps,
            "scaled_residual": resid, "passed": resid <= HPL_THRESHOLD,
            "refine_history": info["residuals"]}
