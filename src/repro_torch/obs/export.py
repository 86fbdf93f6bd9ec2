"""Exporters for the obs layer: JSONL event log, Chrome/Perfetto trace JSON,
and a flat summary dict for bench rows (the torch package's copy of
``repro/obs/export.py``).

Formats
-------

**JSONL** (``write_jsonl``): one JSON object per line. Line 1 is a header
``{"kind": "header", "clock": "perf_counter_us", "version": 1}``; every
following line is either a span event (``{"kind": "span", "name", "id",
"parent", "ts_us", "dur_us", "tid", ...}``) or, as the final line, a
metrics snapshot (``{"kind": "metrics", ...}``). Greppable, appendable,
streams.

**Chrome trace** (``write_chrome_trace``): the ``trace_event`` JSON format —
``{"traceEvents": [{"ph": "X", "name", "ts", "dur", "pid", "tid",
"args"}, ...]}`` — loadable in ``chrome://tracing`` / Perfetto. Spans map to
complete ("X") events; counter metrics are appended as one trailing "C"
event per counter so totals show up in the viewer.

**Summary** (``summary``): per-span-name aggregation ``{name: {"count",
"total_s", "max_s"}}`` — the compact form bench harnesses embed in their
result rows.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .metrics import global_registry
from .trace import TRACE_CLOCK, trace_events

__all__ = ["write_jsonl", "write_chrome_trace", "summary",
           "span_coverage", "validate_chrome_trace", "validate_jsonl",
           "JSONL_VERSION"]

JSONL_VERSION = 1


def write_jsonl(path: str, events: Optional[list] = None,
                metrics_snapshot: Optional[dict] = None) -> int:
    """Write the span log (+ optional metrics snapshot) as JSONL; returns the
    number of span lines written. ``events`` defaults to the live recorder,
    ``metrics_snapshot`` to the global registry's snapshot."""
    events = trace_events() if events is None else events
    snap = global_registry().snapshot() if metrics_snapshot is None else metrics_snapshot
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "header", "clock": TRACE_CLOCK,
                            "version": JSONL_VERSION}) + "\n")
        for ev in events:
            f.write(json.dumps({"kind": "span", **ev}) + "\n")
        f.write(json.dumps({"kind": "metrics", **snap}) + "\n")
    return len(events)


def write_chrome_trace(path: str, events: Optional[list] = None,
                       metrics_snapshot: Optional[dict] = None) -> int:
    """Write the span log as Chrome ``trace_event`` JSON; returns the event
    count. Span ``attrs`` plus the span/parent ids land in ``args`` so the
    viewer's detail pane shows the linkage."""
    events = trace_events() if events is None else events
    snap = global_registry().snapshot() if metrics_snapshot is None else metrics_snapshot
    pid = os.getpid()
    out = []
    for ev in events:
        args = dict(ev.get("attrs") or {})
        args["span_id"] = ev["id"]
        if ev.get("parent") is not None:
            args["parent_span_id"] = ev["parent"]
        out.append({"ph": "X", "name": ev["name"], "cat": "repro",
                    "ts": ev["ts_us"], "dur": ev["dur_us"],
                    "pid": pid, "tid": ev["tid"], "args": args})
    # Counter totals as one trailing counter sample at the last timestamp.
    if out and snap.get("counters"):
        t_end = max(e["ts"] + e["dur"] for e in out)
        for name, value in snap["counters"].items():
            out.append({"ph": "C", "name": name, "cat": "repro",
                        "ts": t_end, "pid": pid, "args": {"value": value}})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    return len(out)


def validate_chrome_trace(path: str) -> dict:
    """Assert ``path`` is well-formed Chrome ``trace_event`` JSON; returns
    the parsed document (``chip_smoke.py`` checks the trace it writes)."""
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc or not isinstance(doc["traceEvents"], list):
        raise ValueError(f"{path}: missing traceEvents list")
    for ev in doc["traceEvents"]:
        if ev.get("ph") not in ("X", "C"):
            raise ValueError(f"{path}: unexpected phase {ev.get('ph')!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{path}: event without a string name")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"{path}: event without numeric ts")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"{path}: event without integer pid")
        if ev["ph"] == "X":
            if not (isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0):
                raise ValueError(f"{path}: X event without nonnegative dur")
            if "span_id" not in ev.get("args", {}):
                raise ValueError(f"{path}: X event without args.span_id")
        elif "value" not in ev.get("args", {}):
            raise ValueError(f"{path}: C event without args.value")
    return doc


def validate_jsonl(path: str) -> list:
    """Assert ``path`` is a well-formed obs JSONL log (header line, span
    lines, trailing metrics snapshot); returns the parsed lines."""
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    if not lines or lines[0].get("kind") != "header":
        raise ValueError(f"{path}: first line must be the header")
    if lines[0].get("clock") != TRACE_CLOCK or lines[0].get("version") != JSONL_VERSION:
        raise ValueError(f"{path}: header clock/version mismatch")
    if lines[-1].get("kind") != "metrics":
        raise ValueError(f"{path}: last line must be the metrics snapshot")
    if not {"counters", "gauges", "histograms"} <= set(lines[-1]):
        raise ValueError(f"{path}: metrics snapshot missing sections")
    for ln in lines[1:-1]:
        if ln.get("kind") != "span":
            raise ValueError(f"{path}: interior line is not a span")
        if not {"name", "id", "parent", "ts_us", "dur_us", "tid"} <= set(ln):
            raise ValueError(f"{path}: span line missing fields: {ln}")
    return lines


def summary(events: Optional[list] = None) -> dict:
    """Per-span-name aggregation: ``{name: {count, total_s, max_s}}``."""
    events = trace_events() if events is None else events
    out: dict[str, dict] = {}
    for ev in events:
        agg = out.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
        dur_s = ev["dur_us"] / 1e6
        agg["count"] += 1
        agg["total_s"] += dur_s
        agg["max_s"] = max(agg["max_s"], dur_s)
    return out


def span_coverage(wall_seconds: float, events: Optional[list] = None,
                  prefix: str = "") -> float:
    """Fraction of ``wall_seconds`` covered by TOP-LEVEL spans (no parent,
    optionally name-filtered by ``prefix``). Nested spans are excluded so
    overlap cannot double-count."""
    events = trace_events() if events is None else events
    covered = sum(ev["dur_us"] for ev in events
                  if ev.get("parent") is None and ev["name"].startswith(prefix))
    return (covered / 1e6) / wall_seconds if wall_seconds > 0 else 0.0
