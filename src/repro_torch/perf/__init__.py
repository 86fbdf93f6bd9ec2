"""repro_torch.perf: policy autotuning, frozen perf-model presets, and the
perf trajectory (the torch package's copy of ``repro.perf``).

Layered so the cheap pieces need only the standard library (torch comes
in through the package's ``__init__``):

* :mod:`rows`: the ONE bench-result row schema (``schema_version`` 2), with
  the validator the perf gate reuses.
* :mod:`trajectory`: the append-only perf-trajectory store under
  ``experiments/trajectory/`` keyed by (bench, config, platform),
  per-metric baselines (median of the last K runs), and the
  machine-readable regression report of the perf gate
  (``python -m repro_torch.perf.trajectory --compare``). Stdlib and the row
  schema only.
* :mod:`model`: frozen :class:`~repro_torch.perf.model.PerfModel` presets
  (checked-in JSON under ``presets/``, stamped with commit and hardware
  fingerprint) consulted by :func:`~repro_torch.perf.model.resolve_fastest`
  ("the fastest policy meeting this accuracy tier at this shape on this
  device type"). Its padding-tile reader :func:`~repro_torch.perf.model.
  preset_blocks` is kept for the format; the fused kernels do not consult it.
* :mod:`sweep`: the autotuner that produces preset CANDIDATES: policy specs
  x routes over a shape grid on one device, accuracy measured beside wall
  time, Pareto-filtered per (shape bucket, device type, accuracy tier).
  Presets are only ever refreshed by a reviewed commit.
"""
from . import rows, trajectory
from .fingerprint import fingerprint_fresh, hardware_fingerprint
from .model import PerfModel, PresetEntry, default_model, preset_blocks, resolve_fastest
from .rows import (SCHEMA_VERSION, RowSchemaError, make_results_doc, make_row,
                   normalize_row, validate_results, validate_row)
from .trajectory import append_results, compare_results, load_series

__all__ = [
    "rows", "trajectory",
    "SCHEMA_VERSION", "RowSchemaError", "make_row", "normalize_row",
    "validate_row", "validate_results", "make_results_doc",
    "append_results", "compare_results", "load_series",
    "PerfModel", "PresetEntry", "default_model", "preset_blocks",
    "resolve_fastest",
    "hardware_fingerprint", "fingerprint_fresh",
]
