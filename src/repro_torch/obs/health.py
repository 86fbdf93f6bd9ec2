"""Numerical-health monitors: the signals that decide whether an emulated
GEMM's answer can still be trusted (the torch package's copy of
``repro/obs/health.py``).

Three monitors, each emitting into the metrics registry and optionally
escalating:

* :class:`AccuracyTripwire` — a per-call *sampled* error estimate. Every
  ``sample_every``-th observed pairing replays the cheap accurate-mode bound
  GEMM (round-up e4m3 casts, one FP8 MMA — the same ``pair_exponents``
  machinery, paper §III-E) to bound the pairing's magnitude profile, sketches
  the operands' measured exponent spread, and feeds both into the calibrated
  error estimator (:func:`repro_torch.precision.resolve.estimate_norm_err_log2`). If the
  estimate exceeds the target the policy was resolved for, the tripwire
  fires: ``health.tripwire.trips`` increments and ``on_trip`` runs.

* :class:`DriftMonitor` — exponent-range-sketch drift. A cached plan's
  ``num_moduli`` was chosen from the sketch the resolver saw
  (``resolve_for`` / ``resolve_for_sketches``); if the operands flowing
  through it later spread wider, the chosen modulus count silently stops
  being sufficient. ``check`` compares the live sketch against the resolved
  one, and past ``drift_threshold_log2`` it re-resolves the modulus count —
  when more moduli are needed, ``on_escalate(needed)`` is the hook a serving
  engine or plan cache uses to rebuild its plans.

* :func:`residue_headroom` — how close a prepared plan's residue digits sit
  to their per-modulus split bound. Emitted as ``health.residue_headroom``
  gauges (log2 bits of slack; negative would mean saturation, which the
  exactness contract forbids).

The monitors are host-side numpy (sampled, off the hot path); the probe's
bound GEMM runs in PyTorch on the card unless the caller passes
``device="cpu"`` (a tensor operand stays on its own device).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.precision.resolve import (estimate_norm_err_log2,
                                           operand_spread_log2, resolve_num_moduli)

from . import metrics

__all__ = ["AccuracyTripwire", "DriftMonitor", "DriftReport",
           "bound_gemm_probe", "residue_headroom"]


def _probe_operand(x, device):
    """An operand as f64 on the probe's device: a tensor on its own device,
    anything else on ``resolve_device(device)`` (the card by default)."""
    import torch

    from repro_torch.core.gemm import resolve_device

    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.float64)
    return torch.as_tensor(x).to(device=resolve_device(device), dtype=torch.float64)


def bound_gemm_probe(a, b, *, device=None) -> float:
    """Replay the accurate-mode bound GEMM on (a, b); returns log2 of the
    maximum bound on |(a @ b)_ij| (the inflated Cbar with the prescale
    exponents undone), so the result upper-bounds log2 max |a @ b|. Cheap:
    two round-up e4m3 casts and one FP8 MMA, exactly the paper's §III-E
    pre-pass. Runs on the card unless ``device`` says otherwise; tensors
    given without a ``device`` stay on their own."""
    import torch

    from repro_torch.core import numerics, scaling

    a, b = _probe_operand(a, device), _probe_operand(b, device)
    lpre_a, bar_a = scaling.accurate_prescale(a, 1)
    lpre_b, bar_b = scaling.accurate_prescale(b, 0)
    cbar = scaling.bound_gemm_inflate(
        numerics.matmul_exact_fp8(bar_a, bar_b), a.shape[1])
    # Cbar bounds the prescaled sum_h |a||b|; subtracting lpre in log space
    # (not 2**-lpre, which overflows for extreme-range rows) recovers a
    # bound on the raw product.
    log_bound = (torch.where(cbar > 0, torch.log2(torch.clamp(cbar, min=2.0 ** -1070)),
                             float("-inf"))
                 - lpre_a[:, None].to(torch.float64)
                 - lpre_b[None, :].to(torch.float64))
    return float(log_bound.max())


class AccuracyTripwire:
    """Sampled reconstruction-error estimate against a resolved target.

    ``observe(a, b)`` is called per pairing (host level); every ``sample_every``-th call pays the
    probe, on ``device`` (as :func:`bound_gemm_probe`: the card by default).
    Returns the estimated relative error when sampled, else None.
    """

    def __init__(self, policy, target_rel_err: float, *,
                 sample_every: int = 16,
                 on_trip: Optional[Callable[[float, float], None]] = None,
                 registry: Optional[metrics.MetricsRegistry] = None,
                 device=None):
        if policy.num_moduli is None:
            import dataclasses

            from repro_torch.core.gemm import default_num_moduli
            policy = dataclasses.replace(
                policy, num_moduli=default_num_moduli(policy.scheme))
        self.policy = policy
        self.target_rel_err = float(target_rel_err)
        self.sample_every = max(1, int(sample_every))
        self.on_trip = on_trip
        self._registry = registry
        self.device = device
        self._calls = 0
        self.trips = 0

    def _emit(self, kind: str, value: float) -> None:
        if self._registry is not None:
            if kind == "trips":
                self._registry.inc("health.tripwire.trips", value)
            else:
                self._registry.gauge(f"health.tripwire.{kind}", value)
        elif kind == "trips":
            metrics.inc("health.tripwire.trips", value)
        else:
            metrics.gauge(f"health.tripwire.{kind}", value)

    def observe(self, a, b) -> Optional[float]:
        self._calls += 1
        if self._calls % self.sample_every:
            return None
        spread = operand_spread_log2(a) + operand_spread_log2(b)
        est_log2 = estimate_norm_err_log2(
            self.policy.moduli_set(), np.shape(a)[-1], spread, self.policy.mode)
        bound_log2 = bound_gemm_probe(a, b, device=self.device)
        est = 2.0 ** est_log2
        self._emit("err_est_log2", est_log2)
        self._emit("bound_max_log2", bound_log2)
        if est > self.target_rel_err:
            self.trips += 1
            self._emit("trips", 1.0)
            if self.on_trip is not None:
                self.on_trip(est, self.target_rel_err)
        return est


class DriftReport(NamedTuple):
    drifted: bool
    spread_log2: float       # live sketch
    drift_log2: float        # live - resolved
    needed_moduli: Optional[int]  # re-resolved count when drifted, else None


class DriftMonitor:
    """Exponent-range-sketch drift vs the sketch a plan was resolved with.

    ``resolved_spread_log2`` is the summed operand sketch the resolver saw
    (for serving: weight sketch + activation prior); ``k`` the contraction
    length it resolved at. ``check`` accepts either a raw operand (sketched
    live) or a precomputed ``spread_log2`` float.
    """

    def __init__(self, policy, resolved_spread_log2: float,
                 target_rel_err: float, *, k: int,
                 drift_threshold_log2: float = 0.5,
                 on_escalate: Optional[Callable[[int], None]] = None,
                 registry: Optional[metrics.MetricsRegistry] = None,
                 name: str = "default"):
        self.policy = policy
        self.resolved_spread_log2 = float(resolved_spread_log2)
        self.target_rel_err = float(target_rel_err)
        self.k = int(k)
        self.drift_threshold_log2 = float(drift_threshold_log2)
        self.on_escalate = on_escalate
        self._registry = registry if registry is not None else metrics.global_registry()
        self._gated = registry is None  # global emission honors the obs gate
        self.name = name
        self.escalations = 0

    def _gauge(self, metric: str, value: float) -> None:
        if self._gated:
            metrics.gauge(metric, value, monitor=self.name)
        else:
            self._registry.gauge(metric, value, monitor=self.name)

    def check(self, x_or_spread) -> DriftReport:
        if isinstance(x_or_spread, (int, float)):
            spread = float(x_or_spread)
        else:
            spread = operand_spread_log2(x_or_spread)
        drift = spread - self.resolved_spread_log2
        self._gauge("health.drift.spread_log2", spread)
        self._gauge("health.drift.delta_log2", drift)
        if drift <= self.drift_threshold_log2:
            return DriftReport(False, spread, drift, None)
        needed = resolve_num_moduli(self.policy, None, None,
                                    self.target_rel_err,
                                    k=self.k, spread_log2=spread)
        have = self.policy.num_moduli
        if have is not None and needed > have:
            self.escalations += 1
            if self._gated:
                metrics.inc("health.drift.escalations", 1.0, monitor=self.name)
            else:
                self._registry.inc("health.drift.escalations", 1.0,
                                   monitor=self.name)
            if self.on_escalate is not None:
                self.on_escalate(needed)
        return DriftReport(True, spread, drift, needed)


def _numpy(part) -> np.ndarray:
    """A residue part (e4m3 or int8 tensor) as float values in numpy."""
    import torch

    if isinstance(part, torch.Tensor):
        return part.detach().to(torch.float32).cpu().numpy()
    return np.asarray(part)


def residue_headroom(q, registry: Optional[metrics.MetricsRegistry] = None,
                     name: str = "default") -> float:
    """Minimum log2 headroom of a fast-mode plan's residue digits against
    their per-modulus split bound (karatsuba splits |part| <= s/2 with
    s = 16; square splits |part| <= s/2; int8 residues |r| <= (p-1)/2).
    Positive = slack; ~0 = the digits fill the representable window (still
    exact, but no margin for a scheme change). Gauged per call."""
    ms = q.ms
    if q.parts is None:
        raise ValueError("residue_headroom needs a fast-mode plan with "
                         "materialized parts (accurate plans extract residues "
                         "at pairing time)")
    worst = math.inf
    for l, part in enumerate(q.parts):
        s = ms.split_s[l]
        if ms.family == "int8":
            bounds: tuple[float, ...] = (float(ms.centered_half[l]),)
        elif len(part) == 2:  # square split: r = s*hi + lo, both within ~s/2
            bounds = (s / 2.0 + 1.0, s / 2.0 + 1.0)
        else:  # karatsuba (hi, lo, hs): hs = hi + lo may reach s
            bounds = (s / 2.0, s / 2.0, float(s))
        for p, bound in zip(part, bounds):
            top = float(np.max(np.abs(_numpy(p))))
            worst = min(worst, math.log2(bound / top) if top > 0 else math.inf)
    value = worst if worst != math.inf else 0.0
    if registry is not None:
        registry.gauge("health.residue_headroom", value, monitor=name)
    else:
        metrics.gauge("health.residue_headroom", value, monitor=name)
    return value
