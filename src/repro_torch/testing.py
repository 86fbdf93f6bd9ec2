"""Test-matrix generators shared by the port's tests, its sweep and its
benchmarks (the torch package's copy of ``repro/testing.py``).

They stay numpy, drawn from a ``numpy.random.Generator``, so that one seed
gives the same operands, bit for bit, in both packages: the paper's §V-A
lognormal spread matrices, and the conditioning families the linalg tests
factorize.
"""
from __future__ import annotations

import numpy as np


def lognormal_matrix(rng: np.random.Generator, shape, phi: float) -> np.ndarray:
    """The paper's §V-A generator: (rand - 0.5) * exp(randn * phi)."""
    return (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)


def well_conditioned_matrix(rng: np.random.Generator, n: int) -> np.ndarray:
    """Random orthogonal-ish conditioning: cond ~ O(10) general matrix."""
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.linspace(1.0, 10.0, n)
    return (q1 * d) @ q2


def graded_matrix(rng: np.random.Generator, n: int,
                  log10_cond: float = 8.0) -> np.ndarray:
    """Graded singular spectrum: cond = 10**log10_cond, values spread
    geometrically, the adverse case for truncation-based emulation."""
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0.0, -log10_cond, n)
    return (q1 * d) @ q2


def spd_matrix(rng: np.random.Generator, n: int,
               log10_cond: float = 1.0) -> np.ndarray:
    """Symmetric positive definite with prescribed condition number."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0.0, -log10_cond, n)
    return (q * d) @ q.T
