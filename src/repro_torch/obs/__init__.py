"""repro_torch.obs — tracing, metrics and numerical-health telemetry of the
port (the torch package's copy of ``repro.obs``; host Python, whose only
device work is ``Span.fence``'s synchronize and the health probe's bound
GEMM):

* **Spans** (:mod:`.trace`): ``with span("ozmm") as sp: ...`` context
  manager + decorator, contextvar parent linking, explicit ``sp.fence(x)``
  device fencing (``torch.cuda.synchronize`` of the CUDA devices ``x``
  lives on, before the end timestamp). Spans always time and record into
  the trace buffer only while tracing is enabled.
* **Metrics** (:mod:`.metrics`): counters/gauges/histograms in a flat
  registry; gated module-level emitters (no-ops that allocate nothing when
  disabled — the ``ozmm`` hot-path contract). ``record_gemm_call`` keys
  emulated-GEMM calls by (scheme, mode, num_moduli, shape-bucket) and
  derives the Table-II low-precision MMA-op and residue-byte totals.
* **Exporters** (:mod:`.export`): JSONL event log, Chrome/Perfetto
  ``trace_event`` JSON, flat per-span summaries and the span-coverage check.
* **Health** (:mod:`.health`): sampled accuracy tripwire (bound-GEMM replay
  + calibrated estimator vs the resolved target), exponent-range sketch
  drift with ``resolve_for`` escalation, residue-headroom gauges.

``enable()`` / ``disable()`` toggle tracing+metrics together;
``REPRO_OBS=1`` (or the individual ``REPRO_OBS_TRACE`` /
``REPRO_OBS_METRICS``) enables at import.
"""
from __future__ import annotations

import os as _os

from .export import (span_coverage, summary, write_chrome_trace,  # noqa: F401
                     write_jsonl)
from .health import (AccuracyTripwire, DriftMonitor, DriftReport,  # noqa: F401
                     bound_gemm_probe, residue_headroom)
from .metrics import (MetricsRegistry, disable_metrics,  # noqa: F401
                      enable_metrics, gauge, global_registry, inc,
                      metrics_enabled, observe, record_gemm_call,
                      reset_metrics, shape_bucket)
from .trace import (Span, clear_trace, disable_tracing,  # noqa: F401
                    enable_tracing, span, trace_events, tracing_enabled)

__all__ = [
    "Span", "span", "tracing_enabled", "enable_tracing", "disable_tracing",
    "clear_trace", "trace_events",
    "MetricsRegistry", "global_registry", "metrics_enabled", "enable_metrics",
    "disable_metrics", "reset_metrics", "inc", "gauge", "observe",
    "record_gemm_call", "shape_bucket",
    "write_jsonl", "write_chrome_trace", "summary", "span_coverage",
    "AccuracyTripwire", "DriftMonitor", "DriftReport", "bound_gemm_probe",
    "residue_headroom",
    "enable", "disable", "enabled", "reset",
]


def enable() -> None:
    """Turn on tracing AND metrics."""
    enable_tracing()
    enable_metrics()


def disable() -> None:
    disable_tracing()
    disable_metrics()


def enabled() -> bool:
    return tracing_enabled() or metrics_enabled()


def reset() -> None:
    """Clear the trace buffer and the global metrics registry."""
    clear_trace()
    reset_metrics()


if _os.environ.get("REPRO_OBS", "") not in ("", "0"):
    enable()
