"""The one bench-result row schema (``schema_version`` = 2); the torch
package's copy of ``repro/perf/rows.py``, so that a row or a results
document is valid here exactly when it is valid in the reference, with the
same ``RowSchemaError`` messages.

Schema v2 (one row = one measured cell):

================  =========================================================
``schema_version``  int, :data:`SCHEMA_VERSION`
``bench``           bench module key (``"hpl_dist"``)
``name``            row key, unique within the bench (``"hpl_dist/2x2/..."``)
``policy``          RESOLVED policy spec string, or None when the cell has
                    no single policy (e.g. aggregate stats rows)
``wall_seconds``    seconds per call/run (>= 0) — lower is better
``throughput``      higher-is-better rate, or None; ``throughput_unit``
                    names it (``"tok/s"``, ``"GFLOP/s"``, ``"TF-equiv"``)
``accuracy``        lower-is-better error metric, or None (HPL scaled
                    residual, normalized rel err); ``accuracy_gate`` is the
                    hard threshold it must stay under, or None
``derived``         legacy free-text detail (kept for human eyes / stdout)
``extra``           dict of bench-specific scalars (phase seconds, bytes)
``obs``             per-row observability attachment (counter-derived
                    roofline fractions; benchmarks/run.py fills it)
================  =========================================================

Legacy ``(name, us_per_call, derived)`` tuples normalize losslessly
(``wall_seconds = us / 1e6``); benches migrate to dict rows to expose the
structured fields. :func:`validate_row` / :func:`validate_results` are the
validators the perf gate (:mod:`repro_torch.perf.trajectory`) reuses
before trusting any artifact.

Stdlib-only on purpose (torch comes in only through the package's
``__init__``).
"""
from __future__ import annotations

import json
import os
import subprocess
import time

SCHEMA_VERSION = 2

#: Keys every row carries after normalization.
ROW_KEYS = ("schema_version", "bench", "name", "policy", "wall_seconds",
            "throughput", "throughput_unit", "accuracy", "accuracy_gate",
            "derived", "extra", "obs")

_NUMERIC_OPTIONAL = ("throughput", "accuracy", "accuracy_gate")


class RowSchemaError(ValueError):
    """A bench row (or results document) violates the v2 schema."""


def make_row(bench: str, name: str, wall_seconds: float, *,
             policy: str | None = None,
             throughput: float | None = None,
             throughput_unit: str | None = None,
             accuracy: float | None = None,
             accuracy_gate: float | None = None,
             derived: str = "",
             obs: dict | None = None,
             **extra) -> dict:
    """Build a schema-v2 row; keyword scalars land in ``extra``."""
    return validate_row({
        "schema_version": SCHEMA_VERSION,
        "bench": bench, "name": name,
        "policy": policy,
        "wall_seconds": float(wall_seconds),
        "throughput": None if throughput is None else float(throughput),
        "throughput_unit": throughput_unit,
        "accuracy": None if accuracy is None else float(accuracy),
        "accuracy_gate": None if accuracy_gate is None else float(accuracy_gate),
        "derived": derived,
        "extra": dict(extra),
        "obs": obs,
    })


def normalize_row(bench: str, row) -> dict:
    """Normalize one bench-emitted row to schema v2.

    Accepts the legacy ``(name, us_per_call, derived)`` tuple every bench
    used to return, or a dict (partial dicts are filled with defaults; the
    legacy ``us_per_call`` key converts to ``wall_seconds``).
    """
    if isinstance(row, (tuple, list)):
        if len(row) != 3:
            raise RowSchemaError(
                f"legacy row must be (name, us_per_call, derived), got "
                f"{len(row)} fields: {row!r}")
        name, us, derived = row
        return make_row(bench, str(name), float(us) / 1e6, derived=str(derived))
    if isinstance(row, dict):
        d = dict(row)
        if "wall_seconds" not in d and "us_per_call" in d:
            d["wall_seconds"] = float(d.pop("us_per_call")) / 1e6
        d.setdefault("schema_version", SCHEMA_VERSION)
        d.setdefault("bench", bench)
        for key in ROW_KEYS:
            if key not in d:
                d[key] = {} if key == "extra" else ("" if key == "derived" else None)
        return validate_row(d)
    raise RowSchemaError(f"row must be a 3-tuple or dict, got {type(row).__name__}")


def validate_row(row: dict) -> dict:
    """Validate one normalized row; returns it (raises :class:`RowSchemaError`)."""
    if not isinstance(row, dict):
        raise RowSchemaError(f"row must be a dict, got {type(row).__name__}")
    unknown = set(row) - set(ROW_KEYS)
    if unknown:
        raise RowSchemaError(f"unknown row keys {sorted(unknown)} in {row.get('name')!r}")
    missing = set(ROW_KEYS) - set(row)
    if missing:
        raise RowSchemaError(f"missing row keys {sorted(missing)} in {row.get('name')!r}")
    if row["schema_version"] != SCHEMA_VERSION:
        raise RowSchemaError(
            f"schema_version {row['schema_version']!r} != {SCHEMA_VERSION} "
            f"in {row.get('name')!r}")
    for key in ("bench", "name"):
        if not isinstance(row[key], str) or not row[key]:
            raise RowSchemaError(f"{key} must be a non-empty string, got {row[key]!r}")
    if not isinstance(row["wall_seconds"], (int, float)) or row["wall_seconds"] < 0:
        raise RowSchemaError(
            f"wall_seconds must be a number >= 0, got {row['wall_seconds']!r} "
            f"in {row['name']!r}")
    for key in _NUMERIC_OPTIONAL:
        v = row[key]
        if v is not None and not isinstance(v, (int, float)):
            raise RowSchemaError(f"{key} must be numeric or None, got {v!r} "
                                 f"in {row['name']!r}")
    for key in ("policy", "throughput_unit"):
        v = row[key]
        if v is not None and not isinstance(v, str):
            raise RowSchemaError(f"{key} must be a string or None, got {v!r}")
    if not isinstance(row["derived"], str):
        raise RowSchemaError(f"derived must be a string, got {row['derived']!r}")
    if not isinstance(row["extra"], dict):
        raise RowSchemaError(f"extra must be a dict, got {row['extra']!r}")
    if row["obs"] is not None and not isinstance(row["obs"], dict):
        raise RowSchemaError(f"obs must be a dict or None, got {row['obs']!r}")
    if row["accuracy_gate"] is not None and row["accuracy"] is None:
        raise RowSchemaError(
            f"accuracy_gate without an accuracy value in {row['name']!r}")
    return row


def current_commit() -> str | None:
    """Best-effort commit id for provenance: CI env, then git, then None."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=os.path.dirname(__file__),
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:  # noqa: BLE001 — no git is fine (installed package)
        pass
    return None


def make_results_doc(results: list[dict], *, policy_specs=None, smoke=False,
                     argv=None, obs=None, device=None) -> dict:
    """Assemble + validate the full ``bench_results.json`` document; the
    fingerprint is the one of calls on ``device`` (None: the default)."""
    from .fingerprint import hardware_fingerprint

    return validate_results({
        "schema_version": SCHEMA_VERSION,
        "policy_specs": policy_specs,
        "smoke": bool(smoke),
        "argv": list(argv or []),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "commit": current_commit(),
        "fingerprint": hardware_fingerprint(device),
        "results": results,
        "obs": obs or {},
    })


def validate_results(doc: dict) -> dict:
    """Validate a whole results document (top-level + every row)."""
    if not isinstance(doc, dict):
        raise RowSchemaError(f"results doc must be a dict, got {type(doc).__name__}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise RowSchemaError(
            f"results doc schema_version {doc.get('schema_version')!r} != "
            f"{SCHEMA_VERSION} (legacy artifact? re-run benchmarks.run)")
    if not isinstance(doc.get("results"), list):
        raise RowSchemaError("results doc needs a 'results' list")
    names = set()
    for row in doc["results"]:
        validate_row(row)
        key = (row["bench"], row["name"])
        if key in names:
            raise RowSchemaError(f"duplicate row name {row['name']!r} in "
                                 f"bench {row['bench']!r}")
        names.add(key)
    if not isinstance(doc.get("fingerprint"), dict):
        raise RowSchemaError("results doc needs a 'fingerprint' dict")
    return doc


def load_results(path: str) -> dict:
    """Read + validate a ``bench_results.json`` artifact."""
    with open(path) as f:
        doc = json.load(f)
    return validate_results(doc)
