"""Metrics registry: counters, gauges, histograms (the torch package's copy
of ``repro/obs/metrics.py``, host Python with no device code).

Two kinds of registry exist:

* the **global registry** (:func:`global_registry`), fed by the gated
  module-level emit helpers (:func:`inc`, :func:`gauge`, :func:`observe`) and
  by the emulated-GEMM call instrument (:func:`record_gemm_call`). Emission
  is a no-op unless metrics are enabled (``enable_metrics()`` or
  ``REPRO_OBS_METRICS=1``) — the disabled path allocates nothing, which the
  ``ozmm`` hot-path overhead test pins (tests/test_torch_obs.py).
* **owned registries**: subsystems with a stats contract of their own hold
  a private always-on ``MetricsRegistry`` so their ``stats()`` keys work
  with global obs off, and mirror into the global registry when it is on.

Metric naming: dotted lowercase paths (``serve.tokens.emitted``,
``gemm.calls``), labels as a sorted ``(key, value)`` tuple — the snapshot
renders them ``name{k=v,...}``. Histograms keep count/sum/min/max plus
fixed log2 buckets: enough for p50/p99-ish summaries without reservoirs.

GEMM call accounting (the roofline feed): :func:`record_gemm_call` keys
calls by ``(scheme, mode, num_moduli, shape-bucket)`` and derives, from the
moduli set, the low-precision MMA-op total (``gemm.mma_ops`` — 2·m·k·n per
low-precision GEMM, 3N fp8 / N int8 of them per call, Table II) and the
residue bytes moved (``gemm.residue_bytes`` — split matrices of both
operands plus the int32 accumulator tiles).
"""
from __future__ import annotations

import math
import os
import threading
from typing import Optional

__all__ = ["MetricsRegistry", "global_registry", "metrics_enabled",
           "enable_metrics", "disable_metrics", "reset_metrics",
           "inc", "gauge", "observe", "record_gemm_call", "shape_bucket"]

_ENABLED = bool(int(os.environ.get("REPRO_OBS_METRICS", "0") or "0"))

#: Histogram bucket upper bounds: powers of 4 from 2^-20 (~1 us if seconds)
#: up to 2^20, plus +inf — 21 buckets, fixed so snapshots merge trivially.
_BUCKET_BOUNDS = tuple(4.0 ** e for e in range(-10, 11))


def metrics_enabled() -> bool:
    return _ENABLED


def enable_metrics() -> None:
    global _ENABLED
    _ENABLED = True


def disable_metrics() -> None:
    global _ENABLED
    _ENABLED = False


class MetricsRegistry:
    """Thread-safe flat metric store. Keys are ``(name, labels)`` with
    ``labels`` a sorted tuple of ``(key, str(value))`` pairs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, dict] = {}

    # ---- emission -------------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple:
        if not labels:
            return (name, ())
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
                     "buckets": [0] * (len(_BUCKET_BOUNDS) + 1)}
                self._hists[key] = h
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            for i, bound in enumerate(_BUCKET_BOUNDS):
                if value <= bound:
                    h["buckets"][i] += 1
                    break
            else:
                h["buckets"][-1] += 1

    # ---- reading --------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get(self._key(name, labels), 0.0)

    def gauge_value(self, name: str, default: float = 0.0, **labels) -> float:
        return self._gauges.get(self._key(name, labels), default)

    def histogram_stats(self, name: str, **labels) -> Optional[dict]:
        h = self._hists.get(self._key(name, labels))
        if h is None:
            return None
        return {"count": h["count"], "sum": h["sum"],
                "mean": h["sum"] / h["count"] if h["count"] else 0.0,
                "min": h["min"], "max": h["max"]}

    def counter_total(self, name: str) -> float:
        """Sum of a counter across every label set."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    @staticmethod
    def _render(key: tuple) -> str:
        name, labels = key
        if not labels:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

    def snapshot(self) -> dict:
        """Flat JSON-able view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{label=value}`` keys."""
        with self._lock:
            return {
                "counters": {self._render(k): v
                             for k, v in sorted(self._counters.items())},
                "gauges": {self._render(k): v
                           for k, v in sorted(self._gauges.items())},
                "histograms": {
                    self._render(k): {
                        "count": h["count"], "sum": h["sum"],
                        "min": h["min"], "max": h["max"],
                        "buckets": list(h["buckets"]),
                    } for k, h in sorted(self._hists.items())},
            }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL


def reset_metrics() -> None:
    _GLOBAL.clear()


# ---------------------------------------------------------------------------
# Gated module-level emitters (the instrumentation surface). Each early-outs
# on the module flag BEFORE touching any argument, so a disabled call does no
# work and allocates nothing beyond the call frame.
# ---------------------------------------------------------------------------

def inc(name: str, value: float = 1.0, **labels) -> None:
    if not _ENABLED:
        return
    _GLOBAL.inc(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    if not _ENABLED:
        return
    _GLOBAL.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if not _ENABLED:
        return
    _GLOBAL.observe(name, value, **labels)


# ---------------------------------------------------------------------------
# Emulated-GEMM call accounting
# ---------------------------------------------------------------------------

def shape_bucket(m: int, k: int, n: int) -> str:
    """Power-of-two shape bucket, e.g. ``m128k256n128`` — keeps the GEMM
    label space bounded while still separating roofline-distinct shapes."""
    b = lambda v: 1 if v <= 1 else 1 << (int(v) - 1).bit_length()
    return f"m{b(m)}k{b(k)}n{b(n)}"


def _gemm_derived(family: str, num_moduli: int, mode: str,
                  m: int, k: int, n: int) -> tuple[float, float]:
    """(mma_ops, residue_bytes) for ONE emulated GEMM call.

    MMA ops: 2·m·k·n per low-precision GEMM × the Table II schedule count
    (N int8 / 3N fp8, +1 bound GEMM in accurate mode). Residue bytes: the
    1-byte split matrices of both operands (``num_split_matrices`` each)
    plus the int32 per-modulus accumulator tiles read back.
    """
    from repro_torch.core.moduli import make_moduli_set

    ms = make_moduli_set(family, num_moduli)
    gemms = (ms.num_lowprec_matmuls_accurate if mode == "accurate"
             else ms.num_lowprec_matmuls_fast)
    mma_ops = 2.0 * m * k * n * gemms
    nsplit = ms.num_split_matrices
    residue_bytes = float(nsplit * (m * k + k * n) + 4 * num_moduli * m * n)
    return mma_ops, residue_bytes


def record_gemm_call(scheme: str, mode: str, family: str, num_moduli: int,
                     m: int, k: int, n: int) -> None:
    """Count one emulated-GEMM call and its derived MMA-op / byte totals.

    Called from the ``ozmm``/``backend_matmul`` entry points (host level,
    once per call; the emulated backward records nothing, as in the
    reference). The disabled path returns before any allocation — the
    hot-path contract.
    """
    if not _ENABLED:
        return
    bucket = shape_bucket(m, k, n)
    _GLOBAL.inc("gemm.calls", 1.0, scheme=scheme, mode=mode,
                num_moduli=num_moduli, shape=bucket)
    mma_ops, residue_bytes = _gemm_derived(family, num_moduli, mode, m, k, n)
    _GLOBAL.inc("gemm.mma_ops", mma_ops, scheme=scheme, mode=mode,
                num_moduli=num_moduli, shape=bucket)
    _GLOBAL.inc("gemm.residue_bytes", residue_bytes, scheme=scheme, mode=mode,
                num_moduli=num_moduli, shape=bucket)
