"""Policy autotuner: sweep policies x routes x shapes on a device, measure
wall time AND accuracy, Pareto-filter to preset candidates (the torch
package's copy of ``repro/perf/sweep.py``).

The sweep grammar (the reference's):

* **specs**: ``PrecisionPolicy`` spec strings, with an optional modulus-range
  suffix: ``"ozaki2-fp8/fast@4..8"`` expands to ``@4 @5 ... @8`` and
  ``"@4..8x2"`` steps by 2 (:func:`expand_specs`).
* **routes**: executor variants appended per spec: ``core`` (``+core``, the
  torch route), ``pallas`` (``+pallas``, the fused kernel K1), ``unfused``
  (``+pallas+unfused``, the phase-split pipeline: K6, K3/K4, K5). The
  reference appends nothing for ``core``, since its bare spec runs its core
  route on the CPU where it sweeps; the port's bare spec takes the kernel
  route on a Hopper card, so ``core`` names it.
* **blocks**: not swept. The reference sweeps the fused kernel's tile; the
  port's tile is compiled in (``KERNEL_TILE``) and ``blocks`` only pads the
  operands to a multiple of it, so a larger one adds zeros and nothing
  else. Every cell records no tile (``blocks`` None), as the preset format
  has it.
* **shapes**: explicit (m, k, n) grid; cells aggregate into
  ``obs.shape_bucket`` buckets, the preset lookup key.

Every cell runs on one device (``device=``: the card by default; ``"cpu"``
runs the kernels' plain versions, the tests' path; without a card and
without ``"cpu"`` the sweep raises). It measures wall seconds (the mean of
``reps`` calls after a warm-up call, the card synchronized before the clock
starts and after the last call: host glue is part of a route's cost), the
normalized error ``max |C - C_ref| / (|A||B|)`` against a float64 numpy
oracle (the resolver's metric) on operands drawn from
``numpy.random.default_rng(0)``, and the emulated-GEMM counter deltas of
:mod:`repro_torch.obs.metrics` (``record_gemm_call``).

Winners, the fastest cell whose MEASURED error meets each accuracy tier at
each (shape bucket, backend), become a preset-candidate
:class:`~repro_torch.perf.model.PerfModel` JSON. Refreshing the checked-in
presets under ``src/repro_torch/perf/presets/`` is a HUMAN step (review and
commit), never automatic.

CLI::

    PYTHONPATH=src python -m repro_torch.perf.sweep --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.perf.sweep --out experiments/perf_sweep  # the card
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from .fingerprint import hardware_fingerprint
from .model import PRESET_FORMAT_VERSION, PerfModel, PresetEntry

#: Accuracy tiers presets are keyed by (target_rel_err values).
DEFAULT_TIERS = (1e-4, 1e-8, 1e-12)

#: Smoke grid: the reference's, sized for the CPU (``--device cpu``).
SMOKE_SHAPES = ((64, 64, 64),)
SMOKE_SPECS = ("ozaki2-fp8/fast@4..6x2", "ozaki2-fp8/accurate@6",
               "ozaki2-int8/fast@6")
SMOKE_ROUTES = ("core", "pallas")

#: Full grid, sized for the card: a square GEMM and qwen2-7b's decode MLP
#: up-projection (4 tokens x d_model 3584 x d_ff 18944). ``resolve_fastest``
#: clamps a preset's modulus count up to the resolver's floor for its
#: family and tier, so each family is swept at its floor for each tier on
#: these operands at both shapes (at 1e-4 / 1e-8 / 1e-12: fp8 fast and
#: Karatsuba 5 / 8 / 11, fp8 accurate 4 / 7 / 10, int8 6 / 9 / 13) and at
#: its default count, fp8 fast at every count from its lowest floor to its
#: default: whatever a preset entry resolves to here was measured.
FULL_SHAPES = ((4096, 4096, 4096), (4, 3584, 18944))
FULL_SPECS = ("ozaki2-fp8/fast@5..12", "ozaki2-fp8/accurate@4..10x3",
              "ozaki2-fp8/accurate@12", "ozaki2-int8/fast@6..9x3",
              "ozaki2-int8/fast@13..14", "ozaki2-karatsuba/fast@5..11x3",
              "ozaki2-karatsuba/fast")
FULL_ROUTES = ("core", "pallas", "unfused")

_ROUTE_SUFFIX = {"core": "+core", "pallas": "+pallas", "unfused": "+pallas+unfused"}

_RANGE_RE = re.compile(r"^(?P<body>.*)@(?P<lo>\d+)\.\.(?P<hi>\d+)(?:x(?P<step>\d+))?$")


def expand_specs(specs) -> list[str]:
    """Expand ``@lo..hi[xstep]`` modulus ranges; plain specs pass through."""
    out: list[str] = []
    for spec in specs:
        m = _RANGE_RE.match(spec)
        if not m:
            out.append(spec)
            continue
        lo, hi = int(m.group("lo")), int(m.group("hi"))
        step = int(m.group("step") or 1)
        if hi < lo or step < 1:
            raise ValueError(f"bad modulus range in {spec!r}")
        out.extend(f"{m.group('body')}@{n}" for n in range(lo, hi + 1, step))
    return out


# ---------------------------------------------------------------------------
# Pareto filtering (pure, deterministic)
# ---------------------------------------------------------------------------
def pareto_front(cells: list[dict], *, time_key: str = "wall_seconds",
                 err_key: str = "rel_err", id_key: str = "spec") -> list[dict]:
    """Non-dominated cells: drop any cell another cell beats-or-ties on BOTH
    wall time and error. Among exact (time, error) ties only the
    lexicographically smallest id survives, so the front is deterministic
    and independent of input order."""
    ordered = sorted(cells, key=lambda c: (c[time_key], c[err_key], c[id_key]))
    front: list[dict] = []
    best_err = float("inf")
    for c in ordered:
        if c[err_key] < best_err:
            front.append(c)
            best_err = c[err_key]
    return front


def select_winners(cells: list[dict], tiers, *, time_key: str = "wall_seconds",
                   err_key: str = "rel_err", id_key: str = "spec") -> dict:
    """Fastest cell whose measured error meets each tier; ties break on
    (time, error, id). Tiers nothing meets are absent from the result."""
    winners: dict[float, dict] = {}
    for tier in tiers:
        feasible = [c for c in cells if c[err_key] <= tier]
        if feasible:
            winners[tier] = min(
                feasible, key=lambda c: (c[time_key], c[err_key], c[id_key]))
    return winners


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------
def draw_operands(m: int, k: int, n: int):
    """A (m, k) and B (k, n), float64 numpy, from ``default_rng(0)``: the
    reference's sweep operands, bit for bit."""
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.standard_normal((m, k)), rng.standard_normal((k, n))


class Operands:
    """One shape's operands and its error oracle, made once and shared by
    every cell of the shape: :func:`draw_operands` on ``device``, with
    ``np.matmul``'s C_ref = A @ B and |A| @ |B| moved there too."""

    def __init__(self, m: int, k: int, n: int, device):
        import numpy as np
        import torch

        a_np, b_np = draw_operands(m, k, n)
        self.shape, self.device = (m, k, n), device
        self.a = torch.from_numpy(a_np).to(device)
        self.b = torch.from_numpy(b_np).to(device)
        self.c_ref = torch.from_numpy(np.matmul(a_np, b_np)).to(device)
        self.denom = torch.from_numpy(np.matmul(np.abs(a_np), np.abs(b_np))).to(device)

    def rel_err(self, out) -> float:
        """max |C - C_ref| / (|A||B|) over the elements where |A||B| > 0:
        the reference's formula, elementwise IEEE f64, so its bits."""
        import torch

        pos = self.denom > 0
        err = (out - self.c_ref).abs()
        ratio = torch.where(pos, err / torch.where(pos, self.denom, 1.0), 0.0)
        return float(ratio.max())


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_cell(spec: str, m: int, k: int, n: int, reps: int = 3, *,
                 device=None, operands: Operands | None = None,
                 keep_output: bool = False):
    """One sweep cell on ``device`` (None: the card): wall seconds (mean of
    ``reps`` after a warm-up call), normalized rel err vs the f64 oracle and
    GEMM counter deltas. ``operands`` (an :class:`Operands` of this shape)
    shares one oracle between cells. Returns the cell, or ``(cell, C)``
    with ``keep_output``."""
    import repro_torch.obs.metrics as metrics
    from repro_torch.core import ozmm
    from repro_torch.core.gemm import resolve_device
    from repro_torch.obs.metrics import shape_bucket

    dev = resolve_device(device)
    ops = operands if operands is not None else Operands(m, k, n, dev)
    if ops.shape != (m, k, n) or ops.device != dev:
        raise ValueError(f"operands of {ops.shape} on {ops.device} for a "
                         f"{(m, k, n)} cell on {dev}")

    was_enabled = metrics.metrics_enabled()
    metrics.enable_metrics()
    before = metrics.global_registry().snapshot()["counters"]
    try:
        out = ozmm(ops.a, ops.b, spec, device=dev)  # build + warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            ozmm(ops.a, ops.b, spec, device=dev)
        _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        after = metrics.global_registry().snapshot()["counters"]
    finally:
        if not was_enabled:
            metrics.disable_metrics()

    rel_err = ops.rel_err(out)
    totals = {"calls": 0.0, "mma_ops": 0.0, "residue_bytes": 0.0}
    for key, value in after.items():
        base = key.split("{", 1)[0]
        if base.startswith("gemm."):
            name = base[len("gemm."):]
            totals[name] = totals.get(name, 0.0) + value - before.get(key, 0.0)

    cell = {
        "spec": spec, "m": m, "k": k, "n": n,
        "shape_bucket": shape_bucket(m, k, n),
        "backend": dev.type,
        "blocks": None,
        "blocks_key": "",
        "wall_seconds": dt,
        "rel_err": rel_err,
        "mma_ops": totals.get("mma_ops", 0.0),
        "residue_bytes": totals.get("residue_bytes", 0.0),
        "mma_ops_per_s": (totals.get("mma_ops", 0.0) / dt) if dt > 0 else 0.0,
    }
    return (cell, out) if keep_output else cell


def run_sweep(shapes, specs, routes, tiers, *, reps: int = 3,
              log=print, device=None, on_cell=None,
              generated_by: str | None = None) -> dict:
    """The full sweep on ``device`` (None: the card): cells -> per-bucket
    Pareto fronts -> tier winners -> preset-candidate dict. Pure output;
    writing files is the CLI's job. ``on_cell(cell, C)`` sees each cell's
    result as it is measured (its C is not kept)."""
    from repro_torch.core.gemm import resolve_device

    dev = resolve_device(device)
    specs = expand_specs(specs)
    cells: list[dict] = []
    for m, k, n in shapes:
        ops = Operands(m, k, n, dev)
        for base_spec in specs:
            for route in routes:
                spec = base_spec + _ROUTE_SUFFIX[route]
                cell, out = measure_cell(spec, m, k, n, reps=reps, device=dev,
                                         operands=ops, keep_output=True)
                cell["route"] = route
                cells.append(cell)
                if on_cell is not None:
                    on_cell(cell, out)
                del out
                log(f"sweep: {spec} @{m}x{k}x{n} "
                    f"-> {cell['wall_seconds'] * 1e3:.2f} ms, "
                    f"rel_err={cell['rel_err']:.2e}")
        del ops

    by_bucket: dict[tuple[str, str], list[dict]] = {}
    for c in cells:
        by_bucket.setdefault((c["shape_bucket"], c["backend"]), []).append(c)

    pareto = {f"{bucket}@{backend}": pareto_front(group)
              for (bucket, backend), group in sorted(by_bucket.items())}
    entries: list[PresetEntry] = []
    dropped: list[str] = []
    for (bucket, backend), group in sorted(by_bucket.items()):
        winners = select_winners(group, tiers)
        for tier in tiers:
            if tier not in winners:
                dropped.append(f"{bucket}@{backend} tier={tier:g}")
                continue
            w = winners[tier]
            entries.append(PresetEntry(
                shape_bucket=bucket, backend=backend, tier=tier,
                spec=w["spec"], wall_seconds=w["wall_seconds"],
                rel_err=w["rel_err"]))
    for miss in dropped:
        # No silent coverage gaps: a tier nothing met is part of the result.
        log(f"sweep: no candidate met {miss}")
    provenance = {
        "commit": _commit(),
        "fingerprint": hardware_fingerprint(dev),
        "generated_by": generated_by or ("python -m repro_torch.perf.sweep "
                                         + " ".join(sys.argv[1:])),
        "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "tiers": list(tiers),
        "note": "CANDIDATE presets: promote to src/repro_torch/perf/presets/ only "
                "by reviewed human commit",
    }
    candidate = PerfModel(entries, provenance)
    return {"cells": cells, "pareto": pareto, "unmet_tiers": dropped,
            "candidate": candidate}


def _commit():
    from .rows import current_commit

    return current_commit()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.sweep",
        description="policy autotuner: throughput x accuracy sweep -> "
                    "Pareto table + perf-model preset candidates")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized grid (one tiny shape, few specs)")
    ap.add_argument("--shapes", nargs="+", default=None, metavar="MxKxN")
    ap.add_argument("--specs", nargs="+", default=None, metavar="SPEC",
                    help="policy specs; '@lo..hi[xstep]' sweeps moduli")
    ap.add_argument("--routes", nargs="+", default=None,
                    choices=sorted(_ROUTE_SUFFIX))
    ap.add_argument("--tiers", nargs="+", type=float, default=None,
                    help=f"accuracy tiers (default {DEFAULT_TIERS})")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="device to sweep on (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default=os.path.join("experiments", "perf_sweep"))
    args = ap.parse_args(argv)

    if args.smoke:
        shapes, specs = SMOKE_SHAPES, SMOKE_SPECS
        routes, reps = SMOKE_ROUTES, 2
    else:
        shapes, specs = FULL_SHAPES, FULL_SPECS
        routes, reps = FULL_ROUTES, 3
    if args.shapes:
        shapes = tuple(tuple(int(v) for v in s.lower().split("x")) for s in args.shapes)
    if args.specs:
        specs = tuple(args.specs)
    if args.routes:
        routes = tuple(args.routes)
    tiers = tuple(args.tiers) if args.tiers else DEFAULT_TIERS
    reps = args.reps if args.reps is not None else reps

    result = run_sweep(shapes, specs, routes, tiers, reps=reps, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    pareto_path = os.path.join(args.out, "pareto.json")
    with open(pareto_path, "w") as f:
        json.dump({"format_version": PRESET_FORMAT_VERSION,
                   "provenance": result["candidate"].provenance,
                   "cells": result["cells"],
                   "pareto": result["pareto"],
                   "unmet_tiers": result["unmet_tiers"]}, f, indent=1)
    candidate_path = os.path.join(args.out, "preset_candidate.json")
    result["candidate"].save(candidate_path)
    print(f"sweep: {len(result['cells'])} cells -> {pareto_path}; "
          f"{len(result['candidate'].entries)} preset entries -> {candidate_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
