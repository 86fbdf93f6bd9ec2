"""Findings baseline: a run fails on *new* findings only (the torch
counterpart of ``repro/analysis/baseline.py``).

The checked-in ``baseline.json`` records the accepted findings of both
analysis layers, keyed by the finding's stable key plus a ``note`` saying
why the finding is accepted rather than fixed (the int32 residue-combine
chains whose < 2^31 bounds are proved, the accurate-mode prescale casts
that are exact by construction, ...). Layout:

    {"version": 1,
     "astlint": [{"key": "...", "note": "..."}, ...],
     "graph":   [{"key": "...", "note": "..."}, ...]}

``astlint`` is empty by policy, as in the reference: a site is fixed or
suppressed inline with its reason. ``graph`` holds the keys of the nine
registry entries traced on the CPU; on the card the same entries must find
nothing outside it (the kernel route's findings are the CPU trace's outside
the kernels' scopes, ``chip_smoke.py`` phase 16).

``python -m repro_torch.analysis --update-baseline`` rewrites the
section(s) of the layer(s) it ran, preserving notes for keys that survive;
the README's port section gives the refresh procedure.
"""
from __future__ import annotations

import json
from pathlib import Path

BASELINE_VERSION = 1
SECTIONS = ("astlint", "graph")

#: The baseline that ships with the package (what a bare run uses).
DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def load_baseline(path: str | Path | None) -> dict:
    path = DEFAULT_BASELINE if path is None else Path(path)
    if not Path(path).exists():
        return {"version": BASELINE_VERSION,
                **{s: [] for s in SECTIONS}}
    data = json.loads(Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {BASELINE_VERSION}")
    for s in SECTIONS:
        data.setdefault(s, [])
    return data


def baseline_keys(data: dict, section: str) -> set[str]:
    return {entry["key"] for entry in data.get(section, [])}


def new_findings(findings, data: dict, section: str):
    """Findings whose key is not baselined (the ones that fail the run)."""
    known = baseline_keys(data, section)
    return [f for f in findings if f.key not in known]


def update_section(data: dict, section: str, findings) -> dict:
    """Replace one section with the current findings, keeping notes."""
    notes = {e["key"]: e.get("note") for e in data.get(section, [])}
    entries = []
    for key in sorted({f.key for f in findings}):
        entry = {"key": key}
        if notes.get(key):
            entry["note"] = notes[key]
        entries.append(entry)
    out = dict(data)
    out[section] = entries
    return out


def save_baseline(data: dict, path: str | Path) -> None:
    Path(path).write_text(json.dumps(data, indent=2, sort_keys=False) + "\n")
