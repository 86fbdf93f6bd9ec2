"""Frozen perf-model presets and the fastest-policy resolver (the torch
package's copy of ``repro/perf/model.py``).

A :class:`PerfModel` is a table of measured winners, "the fastest policy
that met accuracy tier T at this shape bucket on this backend", produced by
:mod:`repro_torch.perf.sweep`, Pareto-filtered, and kept as checked-in JSON
under ``src/repro_torch/perf/presets/`` with provenance (commit, hardware
fingerprint, the generating command). Presets are data, not code: a sweep
only writes CANDIDATES; a human reviews and commits a refresh.

:func:`resolve_fastest` composes the accuracy resolver with the perf model:

1. ``resolve_for`` semantics pick the minimal ``num_moduli`` for the base
   policy (the accuracy FLOOR, unchanged behaviour);
2. a fresh preset matching (shape bucket, backend, tier) breaks the
   remaining ties (scheme, fused/unfused route, backend flags) toward the
   measured-fastest policy;
3. the preset can NEVER loosen accuracy: the returned policy's modulus
   count is ``max(preset's count, the resolver floor recomputed under the
   preset's scheme/mode)``;
4. no preset, no matching entry, or a stale hardware fingerprint
   (:mod:`repro_torch.perf.fingerprint`) falls back to exactly the
   ``resolve_for`` result.

The backend of a lookup is a device type (``"cuda"``/``"cpu"``): the
operands' in ``resolve_fastest``, the kernel's in ``select_blocks``, where
the reference reads JAX's process-wide default backend. Freshness is judged
for that device too (the fingerprint module says why).

:func:`preset_blocks` reads a preset's padding tile as the reference's does,
but nothing in the port consults it: the fused kernel's tile is compiled in
and ``blocks`` only pads the operands to a multiple of it, so no tile makes
a call faster and ``kernels.select_blocks`` stays override > env > table.
It is kept so the preset format reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

from .fingerprint import device_platform, fingerprint_fresh, hardware_fingerprint

PRESET_FORMAT_VERSION = 1

#: Directory of checked-in presets (shipped as package data).
PRESETS_DIR = os.path.join(os.path.dirname(__file__), "presets")


class PresetError(ValueError):
    """A preset file violates the format contract."""


@dataclasses.dataclass(frozen=True)
class PresetEntry:
    """One measured winner: fastest policy meeting ``tier`` at
    (``shape_bucket``, ``backend``)."""

    shape_bucket: str      # obs.metrics.shape_bucket key, e.g. "m64k64n64"
    backend: str           # device type the measurement ran on (cuda/cpu)
    tier: float            # accuracy tier GUARANTEED met (measured rel err <= tier)
    spec: str              # winning policy spec (round-trips via parse_policy)
    wall_seconds: float    # measured wall time of the winner
    rel_err: float         # measured normalized rel err of the winner
    blocks: Optional[tuple[int, int, int]] = None  # swept padding tile, if any
    blocks_key: str = ""   # select_blocks device type at sweep time

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["blocks"] = list(self.blocks) if self.blocks is not None else None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PresetEntry":
        try:
            blocks = d.get("blocks")
            return cls(
                shape_bucket=d["shape_bucket"], backend=d["backend"],
                tier=float(d["tier"]), spec=d["spec"],
                wall_seconds=float(d["wall_seconds"]),
                rel_err=float(d["rel_err"]),
                blocks=tuple(int(v) for v in blocks) if blocks else None,
                blocks_key=d.get("blocks_key", ""))
        except (KeyError, TypeError, ValueError) as exc:
            raise PresetError(f"bad preset entry {d!r}: {exc}") from exc


class PerfModel:
    """An immutable set of preset entries plus their provenance."""

    def __init__(self, entries, provenance: dict):
        from repro_torch.precision import parse_policy

        self.entries = tuple(entries)
        self.provenance = dict(provenance)
        for e in self.entries:
            parse_policy(e.spec)  # fail at load, not at lookup
            if not (0.0 < e.tier < 1.0):
                raise PresetError(f"tier must be in (0, 1), got {e.tier} for {e.spec!r}")
            if e.rel_err > e.tier:
                raise PresetError(
                    f"entry {e.spec!r} records rel_err {e.rel_err:.3g} above "
                    f"its claimed tier {e.tier:.3g}")

    def fresh(self, current: Optional[dict] = None) -> bool:
        """Whether this model's fingerprint matches ``current`` (None: the
        default device's)."""
        return fingerprint_fresh(self.provenance.get("fingerprint"), current)

    def lookup(self, m: int, k: int, n: int, backend: str,
               target_rel_err: float) -> Optional[PresetEntry]:
        """Fastest entry meeting ``target_rel_err`` at this shape bucket on
        ``backend`` (an entry meets the target when its guaranteed tier is
        at least as tight). Ties break deterministically on (wall, tier,
        spec) so a re-sweep with identical timings selects identically."""
        from repro_torch.obs.metrics import shape_bucket

        bucket = shape_bucket(m, k, n)
        cands = [e for e in self.entries
                 if e.shape_bucket == bucket and e.backend == backend
                 and e.tier <= target_rel_err]
        if not cands:
            return None
        return min(cands, key=lambda e: (e.wall_seconds, e.tier, e.spec))

    # ---- persistence ----
    def to_dict(self) -> dict:
        return {"format_version": PRESET_FORMAT_VERSION,
                "provenance": self.provenance,
                "entries": [e.to_dict() for e in self.entries]}

    @classmethod
    def from_dict(cls, d: dict) -> "PerfModel":
        if d.get("format_version") != PRESET_FORMAT_VERSION:
            raise PresetError(
                f"preset format_version {d.get('format_version')!r} != "
                f"{PRESET_FORMAT_VERSION}")
        if not isinstance(d.get("provenance"), dict):
            raise PresetError("preset needs a 'provenance' dict "
                              "(commit, fingerprint, generated_by)")
        return cls([PresetEntry.from_dict(e) for e in d.get("entries", [])],
                   d["provenance"])

    @classmethod
    def load(cls, path: str) -> "PerfModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")


# ---------------------------------------------------------------------------
# Default (checked-in) model
# ---------------------------------------------------------------------------
_UNSET = object()
_override = _UNSET
#: (platform, compute capability) -> the merged model of the checked-in
#: presets fresh there.
_scanned: dict = {}


def set_default_model(model: Optional[PerfModel]) -> None:
    """Override the checked-in presets (tests; ``None`` = no presets)."""
    global _override
    _override = model


def clear_default_model() -> None:
    """Drop the override AND the scan cache (re-reads the presets dir)."""
    global _override
    _override = _UNSET
    _scanned.clear()


def default_model(presets_dir: str = PRESETS_DIR, device=None) -> Optional[PerfModel]:
    """All presets fresh for calls on ``device`` (None: the default device)
    merged into one model (entries concatenated; freshness is judged per
    source file, so a stale file's entries drop out of the merge). ``None``
    when no usable preset exists."""
    if _override is not _UNSET:
        return _override
    current = hardware_fingerprint(device)
    key = (current["platform"], str(current.get("compute_capability")))
    if presets_dir == PRESETS_DIR and key in _scanned:
        return _scanned[key]
    entries: list[PresetEntry] = []
    provenance: dict = {}
    for path in sorted(glob.glob(os.path.join(presets_dir, "*.json"))):
        try:
            m = PerfModel.load(path)
        except (PresetError, json.JSONDecodeError, OSError):
            continue  # one corrupt preset must not disable the others
        if not m.fresh(current):
            continue
        entries.extend(m.entries)
        provenance[os.path.basename(path)] = m.provenance
    model = (PerfModel(entries, {"merged": provenance, "fingerprint": current})
             if entries else None)
    if presets_dir == PRESETS_DIR:
        _scanned[key] = model
    return model


def preset_blocks(family: str, num_moduli: int, blocks_key: str,
                  model: Optional[PerfModel] = None) -> Optional[tuple[int, int, int]]:
    """Measured (bm, bn, bk) padding tile for the fused kernel, if a preset
    fresh on the device type ``blocks_key`` swept one for exactly this
    (moduli family, modulus count, device type), else ``None``: the
    reference's reading of the format (the module docstring says why
    ``kernels.select_blocks`` does not consult it)."""
    from repro_torch.precision import parse_policy

    mdl = default_model(device=blocks_key) if model is None else model
    if mdl is None or not mdl.fresh({"platform": blocks_key}):
        return None
    best = None
    for e in mdl.entries:
        if e.blocks is None or e.blocks_key != blocks_key:
            continue
        pol = parse_policy(e.spec)
        if pol.family != family:
            continue
        if (pol.num_moduli or _family_default_moduli(pol)) != num_moduli:
            continue
        if best is None or (e.wall_seconds, e.spec) < (best.wall_seconds, best.spec):
            best = e
    return best.blocks if best is not None else None


def _family_default_moduli(policy) -> Optional[int]:
    from repro_torch.core.moduli import DEFAULT_NUM_MODULI

    return DEFAULT_NUM_MODULI.get(policy.family)


def _operand_mkn(a, b, k: Optional[int]) -> Optional[tuple[int, int, int]]:
    """(m, k, n) when both operands expose 2-D-tail shapes; None otherwise
    (sketch-style calls without arrays skip the preset lookup)."""
    sa = getattr(a, "shape", None)
    sb = getattr(b, "shape", None)
    if not sa or not sb or len(sa) < 2 or len(sb) < 2:
        return None
    return int(sa[-2]), int(k if k is not None else sa[-1]), int(sb[-1])


def _operand_backend(a, b) -> str:
    """The device type a GEMM of ``a`` and ``b`` runs on: the first
    operand's that has one (a tensor or a prepared plan), else the device
    the port's entry points default to (``ozmm`` puts numpy operands on the
    card when one is visible)."""
    for x in (a, b):
        dev = getattr(x, "device", None)
        if dev is not None and hasattr(dev, "type"):
            return dev.type
    return device_platform(None)


def resolve_fastest(a, b, target_rel_err: float, *, policy=None,
                    model: Optional[PerfModel] = None,
                    k: Optional[int] = None,
                    spread_log2: Optional[float] = None):
    """Fastest policy predicted AND measured to meet ``target_rel_err``.

    Accuracy first: the floor is ``resolve_for`` on the base policy (the
    explicit ``policy=``, else the context policy when it is plan-capable,
    else ``ozaki2-fp8/fast``). A fresh preset entry for this (shape bucket,
    operands' device type, tier) then breaks the scheme/route ties toward
    the measured winner, its modulus count clamped up to the resolver floor
    recomputed under the winner's own scheme/mode, so a preset can make the
    result FASTER but never LESS ACCURATE than the resolver promises. With
    no preset (or a stale fingerprint) the result equals
    ``policy.resolve_for(a, b, target_rel_err)``.
    """
    import dataclasses as dc

    from repro_torch.precision import coerce_policy, resolve_policy
    from repro_torch.precision.policy import PrecisionPolicy, parse_policy
    from repro_torch.precision.resolve import resolve_num_moduli

    if policy is not None:
        base = coerce_policy(policy)
    else:
        ctx = resolve_policy(None)
        base = ctx if ctx.supports_plans else PrecisionPolicy(
            scheme="ozaki2-fp8", mode="fast")
    n_base = resolve_num_moduli(base, a, b, target_rel_err, k=k,
                                spread_log2=spread_log2)
    fallback = dc.replace(base, num_moduli=n_base)

    backend = _operand_backend(a, b)
    mdl = default_model(device=backend) if model is None else model
    if mdl is None or not mdl.fresh(hardware_fingerprint(backend)):
        return fallback
    mkn = _operand_mkn(a, b, k)
    if mkn is None:
        return fallback
    entry = mdl.lookup(*mkn, backend=backend, target_rel_err=target_rel_err)
    if entry is None:
        return fallback
    cand = parse_policy(entry.spec)
    try:
        n_floor = resolve_num_moduli(cand, a, b, target_rel_err, k=k,
                                     spread_log2=spread_log2)
    except ValueError:
        # The winner's scheme cannot meet the target on THESE operands
        # (heavier-tailed than the sweep's family): accuracy wins.
        return fallback
    return dc.replace(cand, num_moduli=max(cand.num_moduli or 0, n_floor))
