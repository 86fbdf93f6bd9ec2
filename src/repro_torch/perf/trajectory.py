"""Perf-trajectory store and regression report (the perf gate); the torch
package's copy of ``repro/perf/trajectory.py``.

Every run's normalized rows (schema v2, :mod:`repro_torch.perf.rows`) are
appended to an append-only store under ``experiments/trajectory/``: one
JSONL file per (bench, config, backend) key, one line per row per run.
``config`` separates smoke rows from full runs (plus an explicit policy-spec
slug when the run named its policies) and ``backend`` is the fingerprint's
``platform`` (``cuda``/``cpu``), so a card's trajectory never baselines a
CPU run.

Baselines are the MEDIAN OF THE LAST K runs per (key, row-name, metric):
robust to one outlier run, cheap to recompute, no state beyond the store.
:func:`compare_results` checks the current run against them with a
symmetric tolerance band:

* ``wall_seconds``: regression when ``current > baseline * (1 + tol)``
* ``throughput``: regression when ``current < baseline * (1 - tol)``
* ``accuracy``: a HARD gate, not baseline-relative: any row whose
  ``accuracy`` exceeds its recorded ``accuracy_gate`` breaches, baseline or
  not (a slow-but-correct run is a regression; a fast-but-wrong one is
  worse).

A row with no baseline yet reports ``seeded``; a run where NO row has a
baseline reports overall ``baseline-seeded`` and passes: the first run
starts the trajectory with an annotation instead of skipping silently.

CLI (the module is stdlib-only; torch comes in only through the package's
``__init__``)::

    python -m repro_torch.perf.trajectory --compare experiments/bench_results.json
    python -m repro_torch.perf.trajectory --append  experiments/bench_results.json
    # options: --store DIR --tol 0.15 --k 5 --report out.json

Exit 0 on ok/seeded, 1 on any regression or accuracy breach, 2 on a
malformed artifact.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

from . import rows as rowschema

#: Default store location, relative to the repo root.
DEFAULT_STORE = os.path.join("experiments", "trajectory")

#: Baseline window: median of the last K appended runs.
DEFAULT_K = 5

#: Relative tolerance band for the throughput/latency gates (15%).
DEFAULT_TOL = 0.15

#: Metrics compared against baselines, with their regression direction.
#: +1 = higher is worse (latency), -1 = lower is worse (throughput).
TRACKED_METRICS = (("wall_seconds", +1), ("throughput", -1))

REPORT_SCHEMA_VERSION = 1

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _slug(s: str) -> str:
    return _SLUG_RE.sub("-", s).strip("-") or "none"


def store_key(doc: dict, row: dict) -> str:
    """(bench, config, backend) key for one row of a results document."""
    config = "smoke" if doc.get("smoke") else "full"
    specs = doc.get("policy_specs")
    if specs:
        config += "-" + _slug("+".join(specs))
    backend = (doc.get("fingerprint") or {}).get("platform", "unknown")
    return f"{row['bench']}__{config}__{backend}"


def _entry(doc: dict, row: dict) -> dict:
    return {
        "ts": doc.get("timestamp"),
        "commit": doc.get("commit"),
        "bench": row["bench"],
        "name": row["name"],
        "policy": row["policy"],
        "wall_seconds": row["wall_seconds"],
        "throughput": row["throughput"],
        "throughput_unit": row["throughput_unit"],
        "accuracy": row["accuracy"],
        "accuracy_gate": row["accuracy_gate"],
    }


def append_results(doc: dict, store_dir: str = DEFAULT_STORE) -> int:
    """Append every row of a validated results doc to the store; returns
    the number of lines written."""
    rowschema.validate_results(doc)
    os.makedirs(store_dir, exist_ok=True)
    by_file: dict[str, list[dict]] = {}
    for row in doc["results"]:
        by_file.setdefault(store_key(doc, row), []).append(_entry(doc, row))
    n = 0
    for key, entries in by_file.items():
        with open(os.path.join(store_dir, key + ".jsonl"), "a") as f:
            for e in entries:
                f.write(json.dumps(e, sort_keys=True) + "\n")
                n += 1
    return n


def load_series(store_dir: str = DEFAULT_STORE) -> dict:
    """Read the store back: ``{(key, row_name): [entries, append order]}``.
    Unparseable lines are skipped (a truncated append must not wedge the
    gate), missing store -> empty."""
    series: dict[tuple[str, str], list[dict]] = {}
    if not os.path.isdir(store_dir):
        return series
    for fname in sorted(os.listdir(store_dir)):
        if not fname.endswith(".jsonl"):
            continue
        key = fname[:-6]
        with open(os.path.join(store_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(e, dict) and "name" in e:
                    series.setdefault((key, e["name"]), []).append(e)
    return series


def baseline_value(entries: list[dict], metric: str, k: int = DEFAULT_K):
    """Median of the last ``k`` recorded values of ``metric`` (None when
    fewer than one usable value exists)."""
    vals = [e[metric] for e in entries
            if isinstance(e.get(metric), (int, float))]
    if not vals:
        return None
    return statistics.median(vals[-k:])


def compare_results(doc: dict, store_dir: str = DEFAULT_STORE, *,
                    tol: float = DEFAULT_TOL, k: int = DEFAULT_K) -> dict:
    """Compare a current results doc against the store's baselines.

    Returns the machine-readable report (the reference's schema); the
    overall ``status`` is ``"regression"`` if any tracked metric left its
    tolerance band or any accuracy gate was breached, ``"baseline-seeded"``
    if no row had a baseline at all, else ``"ok"``.
    """
    rowschema.validate_results(doc)
    series = load_series(store_dir)
    report_rows: list[dict] = []
    regressions: list[str] = []
    breaches: list[str] = []
    any_baseline = False
    for row in doc["results"]:
        key = store_key(doc, row)
        entries = series.get((key, row["name"]), [])
        for metric, direction in TRACKED_METRICS:
            current = row[metric]
            if current is None:
                continue
            base = baseline_value(entries, metric, k)
            rrow = {"key": key, "name": row["name"], "metric": metric,
                    "current": current, "baseline": base, "ratio": None,
                    "status": "seeded"}
            if base is not None:
                any_baseline = True
                rrow["ratio"] = (current / base) if base else None
                worse = (current > base * (1 + tol) if direction > 0
                         else current < base * (1 - tol))
                better = (current < base * (1 - tol) if direction > 0
                          else current > base * (1 + tol))
                rrow["status"] = ("regression" if worse
                                  else "improved" if better else "ok")
                if worse:
                    regressions.append(f"{row['name']}: {metric} "
                                       f"{current:.6g} vs baseline {base:.6g} "
                                       f"(tol {tol:.0%})")
            report_rows.append(rrow)
        gate = row["accuracy_gate"]
        if gate is not None and row["accuracy"] is not None:
            breached = row["accuracy"] > gate
            report_rows.append({"key": key, "name": row["name"],
                                "metric": "accuracy", "current": row["accuracy"],
                                "baseline": gate, "ratio": None,
                                "status": "breach" if breached else "ok"})
            if breached:
                breaches.append(f"{row['name']}: accuracy {row['accuracy']:.6g} "
                                f"> gate {gate:.6g}")
    if regressions or breaches:
        status = "regression"
    elif not any_baseline:
        status = "baseline-seeded"
    else:
        status = "ok"
    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "status": status,
        "tolerance": tol,
        "baseline_runs_k": k,
        "commit": doc.get("commit"),
        "generated": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "rows": report_rows,
        "regressions": regressions,
        "accuracy_breaches": breaches,
    }


def _print_report(report: dict) -> None:
    counts: dict[str, int] = {}
    for r in report["rows"]:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    summary = ", ".join(f"{v} {k}" for k, v in sorted(counts.items()))
    print(f"perf-trajectory: status={report['status']} ({summary or 'no rows'})")
    for msg in report["regressions"]:
        print(f"::error title=perf regression::{msg}")
    for msg in report["accuracy_breaches"]:
        print(f"::error title=accuracy gate breach::{msg}")
    if report["status"] == "baseline-seeded":
        print("::notice title=perf trajectory::baseline seeded — no prior "
              "runs in the store; this run becomes the baseline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.trajectory",
        description="perf-trajectory store: append bench runs, compare "
                    "against median-of-K baselines (the perf gate)")
    ap.add_argument("--append", metavar="RESULTS", default=None,
                    help="append a bench_results.json to the store")
    ap.add_argument("--compare", metavar="RESULTS", default=None,
                    help="compare a bench_results.json against the store's "
                         "baselines; exits 1 on regression/accuracy breach")
    ap.add_argument("--store", default=DEFAULT_STORE,
                    help=f"trajectory store directory (default {DEFAULT_STORE})")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="relative tolerance band (default 0.15 = 15%%)")
    ap.add_argument("--k", type=int, default=DEFAULT_K,
                    help="baseline window: median of the last K runs")
    ap.add_argument("--report", default=None,
                    help="write the machine-readable comparison report here")
    args = ap.parse_args(argv)
    if not args.append and not args.compare:
        ap.error("nothing to do: pass --append and/or --compare")

    code = 0
    try:
        if args.compare:
            doc = rowschema.load_results(args.compare)
            report = compare_results(doc, args.store, tol=args.tol, k=args.k)
            _print_report(report)
            if args.report:
                os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
                with open(args.report, "w") as f:
                    json.dump(report, f, indent=1)
            if report["status"] == "regression":
                code = 1
        if args.append:
            doc = rowschema.load_results(args.append)
            n = append_results(doc, args.store)
            print(f"perf-trajectory: appended {n} rows to {args.store}")
    except (rowschema.RowSchemaError, OSError, json.JSONDecodeError) as exc:
        print(f"perf-trajectory: bad artifact: {exc}", file=sys.stderr)
        return 2
    return code


if __name__ == "__main__":
    sys.exit(main())
