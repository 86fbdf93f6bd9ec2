"""Accuracy-targeted modulus-count resolution (the torch counterpart of
``repro/precision/resolve.py``, numpy only like the reference; operands may
be numpy arrays, tensors on any device, or prepared plans), with the
serving side's ``resolve_for_sketches`` over ``WeightSketch`` summaries.

The Ozaki-II error in the condition-free metric

    err = max_ij |C_ij - (AB)_ij| / (|A| |B|)_ij

is governed by the truncation of the scaled operands: each row of A keeps
~P' = (log2(P-1) - 1)/2 bits below its Cauchy-Schwarz row scale (eq. (3)),
so every extra modulus p buys ~log2(p)/2 more bits, while two operand
properties consume the budget:

* the contraction length ``k`` — the usual sqrt(k) accumulation factor;
* the operand EXPONENT RANGE — elements far below their row/column scale
  lose low bits, and heavy-tailed magnitude distributions shrink the typical
  (|A||B|)_ij denominator relative to the row norms that set the scales.
  The paper's Fig. 3 phi-sweep is exactly this effect.

The estimator condenses the second effect into one exponent-range sketch per
operand — the standard deviation of log2|x| over nonzero entries — and models

    log2 err  ~=  1 - P'(N) + 0.5 log2 k - CANCELLATION_BITS
                  + max(0, SPREAD_SLOPE * (sigma_A + sigma_B - SPREAD_PIVOT))
                  [+ FAST_EXTRA_BITS in fast mode]  + SAFETY_BITS

with constants calibrated on the paper's §V-A lognormal families (see
docs/precision.md for the measured anchors). ``resolve_num_moduli`` picks the
smallest N whose estimate meets the target; the estimate is strictly
decreasing in N, so a tighter target can never select fewer moduli.
"""
from __future__ import annotations

import math
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from .policy import PrecisionPolicy

#: Serving resolves a request's decode policy at ADMISSION, before any of its
#: activations exist, so the activation side enters as a fixed exponent-range
#: prior: rmsnorm'd decode activations across the smoke archs measure
#: sigma(log2|x|) ~ 1.3-1.8 — take the upper edge, erring conservative (the
#: estimator already carries SAFETY_BITS on top).
DEFAULT_ACTIVATION_SPREAD_LOG2 = 1.6


class WeightSketch(NamedTuple):
    """Admission-time summary of one matmul weight: enough to resolve a
    modulus count without touching the (possibly source-dropped) plan."""
    path: str
    contract_dim: int
    spread_log2: float

#: Calibration (docs/precision.md): bits of accuracy lost per unit of summed
#: operand log2-spread beyond the Gaussian baseline.
SPREAD_SLOPE = 2.3
#: Summed sigma(log2|x|) of two Gaussian operands — the zero-penalty pivot.
SPREAD_PIVOT = 3.2
#: Fast (Cauchy-Schwarz) scaling gives up ~2 bits vs the accurate bound GEMM.
FAST_EXTRA_BITS = 2.0
#: The worst-case truncation bound assumes every element error aligns; the
#: measured error sits ~4-6 bits below it across the §V-A families (errors of
#: independently-truncated elements partially cancel). Calibrated credit.
CANCELLATION_BITS = 5.0
#: Headroom so the estimate errs conservative (picks >= the minimal count)
#: without overshooting past +1 modulus (~4.4 bits each).
SAFETY_BITS = 3.5

#: The f64 output floor: FP64-grade emulation bottoms out at ~2^-50..-52 in
#: this metric (the final CRT reconstruction rounds to float64), so tighter
#: targets cannot be promised regardless of modulus count.
MIN_TARGET_LOG2 = -50.0

#: Search ceiling — far beyond any sensible operating point (paper: 12-16).
MAX_RESOLVE_MODULI = 26


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def operand_spread_log2(x) -> float:
    """Exponent-range sketch: std of log2|x| over nonzero entries (0.0 for
    all-zero or constant-magnitude operands)."""
    ax = np.abs(_as_numpy(x).astype(np.float64))
    nz = ax[ax > 0]
    if nz.size < 2:
        return 0.0
    return float(np.std(np.log2(nz)))


def _is_plan(x) -> bool:
    return hasattr(x, "parts") and hasattr(x, "stats")  # QuantizedMatrix


def _operand_array(x, side: str):
    """Unwrap arrays or prepared plans (reusing the plan's retained source)."""
    if _is_plan(x):
        if x.x is None:
            raise ValueError(
                f"{side} plan dropped its source (drop_source); pass the raw "
                "operand or an explicit spread_log2= to resolve_for")
        return _as_numpy(x.x)
    return _as_numpy(x)


def _contract_len(a, b) -> int:
    """Contraction length of the pairing; plan metadata works without the
    retained source, raw operands use the trailing lhs axis."""
    if _is_plan(a):
        return int(a.contract_dim)
    if _is_plan(b):
        return int(b.contract_dim)
    a_shape, b_shape = tuple(np.shape(a)), tuple(np.shape(b))
    k = a_shape[-1]
    if len(a_shape) == len(b_shape) == 2 and b_shape[0] != k:
        raise ValueError(f"contraction mismatch {a_shape} @ {b_shape}")
    return int(k)


def estimate_norm_err_log2(ms, k: int, spread_sum_log2: float, mode: str) -> float:
    """Predicted log2 of the |A||B|-normalized error for moduli set ``ms``."""
    pprime = (math.log2(ms.P - 1) - 1.0) / 2.0
    est = 1.0 - pprime + 0.5 * math.log2(max(k, 1)) - CANCELLATION_BITS
    est += max(0.0, SPREAD_SLOPE * (spread_sum_log2 - SPREAD_PIVOT))
    if mode == "fast":
        est += FAST_EXTRA_BITS
    return est + SAFETY_BITS


def resolve_num_moduli(policy: PrecisionPolicy, a, b, target_rel_err: float, *,
                       k: Optional[int] = None,
                       spread_log2: Optional[float] = None) -> int:
    """Smallest modulus count predicted to meet ``target_rel_err``.

    ``a``/``b`` may be raw matrices or prepared ``QuantizedMatrix`` plans
    (their retained f64 source is sketched). ``spread_log2`` overrides the
    measured summed exponent-range sketch; ``k`` overrides the contraction
    length (needed only when neither operand carries a shape).
    """
    if not policy.supports_plans:
        raise ValueError(
            f"resolve_for applies to Ozaki-II schemes (got {policy.scheme!r}); "
            "native is already f64 and ozaki1 is sliced, not modular")
    if not (0.0 < target_rel_err < 1.0):
        raise ValueError(f"target_rel_err must be in (0, 1), got {target_rel_err}")
    t_log2 = math.log2(target_rel_err)
    if t_log2 < MIN_TARGET_LOG2:
        raise ValueError(
            f"target_rel_err=2^{t_log2:.1f} is below the f64 output floor "
            f"(2^{MIN_TARGET_LOG2:.0f}); the reconstruction rounds to float64")

    if k is None:
        k = _contract_len(a, b)
    if spread_log2 is None:
        spread_log2 = (operand_spread_log2(_operand_array(a, "lhs"))
                       + operand_spread_log2(_operand_array(b, "rhs")))

    from repro_torch.core.moduli import make_moduli_set

    family = policy.family
    for n in range(1, MAX_RESOLVE_MODULI + 1):
        ms = make_moduli_set(family, n)
        if estimate_norm_err_log2(ms, k, spread_log2, policy.mode) <= t_log2:
            return n
    raise ValueError(
        f"no {family} modulus count <= {MAX_RESOLVE_MODULI} meets "
        f"target_rel_err=2^{t_log2:.1f} at k={k}, spread={spread_log2:.1f} "
        "(operands too heavy-tailed; consider accurate mode or pre-scaling)")


def resolve_for_sketches(policy: PrecisionPolicy,
                         sketches: Iterable[WeightSketch],
                         target_rel_err: float, *,
                         activation_spread_log2: Optional[float] = None) -> int:
    """Per-request serving resolution: the smallest ``num_moduli`` predicted
    to meet ``target_rel_err`` on EVERY cached weight sketch (the worst
    layer's contraction length x exponent spread wins), with the activation
    side entering as a prior (:data:`DEFAULT_ACTIVATION_SPREAD_LOG2`) since
    the request's activations do not exist at admission time. Monotone in
    the target, so tighter accuracy classes never select fewer moduli."""
    act = (DEFAULT_ACTIVATION_SPREAD_LOG2 if activation_spread_log2 is None
           else float(activation_spread_log2))
    sketches = tuple(sketches)
    if not sketches:
        raise ValueError("resolve_for_sketches needs at least one WeightSketch")
    return max(
        resolve_num_moduli(policy, None, None, target_rel_err,
                           k=sk.contract_dim, spread_log2=sk.spread_log2 + act)
        for sk in sketches)
