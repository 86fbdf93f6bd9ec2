"""repro_torch.perf's model and sweep and repro_torch.precision.resolve_fastest
vs the reference on the same inputs: the same preset entries give the same
lookup, preset_blocks and resolve_fastest spec (lognormal operands at 64^3,
each scenario at each tier: no preset, a stale preset, no bucket, a tier too
loose, a tie-break, "never loosens"); one measure_cell on the core route at
64^3 gives the reference's rel_err bit for bit (the same operands and numpy
oracle, the core route bitwise). select_blocks stays override > env > table:
a preset's tile does not enter it, and a padding tile gives the plain K1 the
same bits. Freshness is judged for the device of the call, on the card with
its compute capability. The reference's side runs its core route once per
module; no reference '+pallas' cell runs (interpret-mode compiles)."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import repro.obs as jax_obs
from repro.perf import model as jax_model
from repro.perf import sweep as jax_sweep
from repro_torch import ozmm
from repro_torch.kernels.fused import BLOCKS_ENV, KERNEL_TILE, ozmm_pallas_fused, select_blocks
from repro_torch.obs.metrics import shape_bucket
from repro_torch.perf import model, sweep
from repro_torch.perf.fingerprint import (device_platform, fingerprint_fresh,
                                          hardware_fingerprint)
from repro_torch.precision import parse_policy
from repro_torch.testing import lognormal_matrix

from _torch_threads import one_torch_thread  # noqa: F401

TIERS = (1e-4, 1e-8, 1e-12)
BUCKET = shape_bucket(64, 64, 64)


@pytest.fixture(autouse=True)
def _isolate_default_models():
    """Tests inject models into both packages; always restore the scans."""
    yield
    model.clear_default_model()
    jax_model.clear_default_model()


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return lognormal_matrix(rng, (64, 64), 1.0), lognormal_matrix(rng, (64, 64), 1.0)


def _pair(entries, platform="cpu"):
    """The same entries as a reference and a port model; ``entries`` are
    PresetEntry kwargs, the blocks key given as the port's (the device
    type: "cpu") and mapped to the reference's ("interpret")."""
    ref = [jax_model.PresetEntry(**dict(e, backend="cpu",
                                        blocks_key="interpret" if e.get("blocks_key") else ""))
           for e in entries]
    got = [model.PresetEntry(**dict(e, backend=e.get("backend", "cpu"))) for e in entries]
    return (jax_model.PerfModel(ref, {"fingerprint": {"jax_platform": platform}}),
            model.PerfModel(got, {"fingerprint": {"platform": platform}}))


def _entry(spec, tier, *, wall=1e-3, bucket=BUCKET, **kw):
    return dict(shape_bucket=bucket, tier=tier, spec=spec, wall_seconds=wall,
                rel_err=tier / 100, **kw)


# scenario -> (entries for a target tier, platform, expected: "fallback" or a
# predicate on the port's result)
SCENARIOS = {
    "no_preset": (lambda t: None, "cpu", "fallback"),
    "stale": (lambda t: [_entry("ozaki2-int8/fast@20+pallas", t / 10)], "elsewhere",
              "fallback"),
    "no_bucket": (lambda t: [_entry("ozaki2-int8/fast@20+pallas", t / 10,
                                    bucket=shape_bucket(4096, 4096, 4096))], "cpu", "fallback"),
    "tier_too_loose": (lambda t: [_entry("ozaki2-int8/fast@20+pallas", min(t * 100, 0.5))],
                       "cpu", "fallback"),
    "preset_backed": (lambda t: [_entry("ozaki2-int8/fast@20+pallas+unfused", t / 10)], "cpu",
                      lambda p: p.scheme == "ozaki2-int8" and not p.fused),
    "tie_break": (lambda t: [_entry("ozaki2-int8/fast@20+pallas", t / 10),
                             _entry("ozaki2-karatsuba/fast@20+pallas", t / 10),
                             _entry("ozaki2-fp8/fast@20+pallas", t / 10)], "cpu",
                  lambda p: p.scheme == "ozaki2-fp8"),
    "never_loosens": (lambda t: [_entry("ozaki2-fp8/fast@2+pallas", t / 10)], "cpu",
                      lambda p: p.num_moduli > 2),
}


@pytest.mark.parametrize("tier", TIERS, ids=[f"{t:g}" for t in TIERS])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_resolve_fastest_same_spec_as_reference(operands, scenario, tier):
    a, b = operands
    make, platform, expect = SCENARIOS[scenario]
    entries = make(tier)
    if entries is None:
        jax_model.set_default_model(None)
        model.set_default_model(None)
        ref_mdl = mdl = None
    else:
        ref_mdl, mdl = _pair(entries, platform)
    want = jax_model.resolve_fastest(a, b, tier, model=ref_mdl)
    got = model.resolve_fastest(torch.from_numpy(a), torch.from_numpy(b), tier, model=mdl)
    assert got.spec == want.spec
    floor = parse_policy("ozaki2-fp8/fast").resolve_for(torch.from_numpy(a),
                                                         torch.from_numpy(b), tier)
    if expect == "fallback":
        assert got == floor
    else:
        assert expect(got)
        # never looser than the resolver's floor under the returned scheme
        assert got.num_moduli >= got.resolve_for(torch.from_numpy(a), torch.from_numpy(b),
                                                 tier).num_moduli


def test_resolve_fastest_explicit_policy_and_export(operands):
    from repro_torch.precision import resolve_fastest

    a, b = operands
    ref_mdl, mdl = _pair([_entry("ozaki2-fp8/accurate@20+pallas", 1e-9)])
    for policy in ("ozaki2-int8/accurate", "ozaki2-karatsuba/fast+core"):
        want = jax_model.resolve_fastest(a, b, 1e-8, policy=policy, model=ref_mdl)
        got = resolve_fastest(torch.from_numpy(a), torch.from_numpy(b), 1e-8, policy=policy,
                              model=mdl)
        assert got.spec == want.spec
    model.set_default_model(None)
    assert resolve_fastest(torch.from_numpy(a), torch.from_numpy(b), 1e-8,
                           policy="ozaki2-int8/accurate") == \
        parse_policy("ozaki2-int8/accurate").resolve_for(a, b, 1e-8)


def test_lookup_same_as_reference():
    entries = [_entry("ozaki2-fp8/fast@6", 1e-9, wall=2e-3),
               _entry("ozaki2-int8/fast@8", 1e-9, wall=1e-3),
               _entry("ozaki2-fp8/fast@4", 1e-4, wall=5e-4),
               _entry("ozaki2-fp8/fast@8", 1e-12, wall=1e-3),
               _entry("ozaki2-karatsuba/fast@8", 1e-12, wall=1e-3),
               _entry("ozaki2-int8/fast@14", 1e-13, wall=3e-3, bucket="m128k64n64")]
    ref_mdl, mdl = _pair(entries)
    for mkn in ((64, 64, 64), (33, 64, 50), (128, 64, 64), (4096, 64, 64)):
        for target in (1e-3, 1e-4, 1e-8, 1e-9, 1e-12, 1e-13, 1e-15):
            want = ref_mdl.lookup(*mkn, "cpu", target)
            got = mdl.lookup(*mkn, "cpu", target)
            assert (got and got.spec) == (want and want.spec), (mkn, target)
    assert mdl.lookup(64, 64, 64, "cuda", 1e-4) is None


def test_preset_blocks_same_as_reference():
    entries = [_entry("ozaki2-fp8/fast@4+pallas", 1e-4, wall=2e-3, blocks=(256, 128, 256),
                      blocks_key="cpu"),
               _entry("ozaki2-fp8/accurate@4+pallas", 1e-4, wall=1e-3, blocks=(128, 256, 128),
                      blocks_key="cpu"),
               _entry("ozaki2-int8/fast+pallas", 1e-8, blocks=(384, 128, 128),
                      blocks_key="cpu"),
               _entry("ozaki2-karatsuba/fast@6+pallas", 1e-8, blocks=None)]
    ref_mdl, mdl = _pair(entries)
    for family, n in (("fp8-hybrid", 4), ("fp8-hybrid", 6), ("int8", 14), ("int8", 4),
                      ("fp8-karatsuba", 6)):
        assert model.preset_blocks(family, n, "cpu", mdl) == \
            jax_model.preset_blocks(family, n, "interpret", ref_mdl), (family, n)
        assert model.preset_blocks(family, n, "cuda", mdl) is None
    stale_ref, stale = _pair(entries, "elsewhere")
    assert model.preset_blocks("fp8-hybrid", 4, "cpu", stale) is \
        jax_model.preset_blocks("fp8-hybrid", 4, "interpret", stale_ref) is None


class _Exploding:
    @property
    def entries(self):
        raise RuntimeError("corrupt")

    def fresh(self, *_):
        return True


def test_select_blocks_precedence(monkeypatch):
    """override > env > table, with or without a fresh preset naming a tile
    (a broken one included): the tile is compiled in, so no preset enters."""
    monkeypatch.delenv(BLOCKS_ENV, raising=False)
    tile = (256, 128, 256)
    preset = [_entry("ozaki2-fp8/fast@4+pallas", 1e-4, blocks=tile, blocks_key="cpu")]
    for mdl in (None, _pair(preset)[1], _Exploding()):
        model.set_default_model(mdl)
        assert select_blocks("cpu") == select_blocks("cuda") == KERNEL_TILE
        monkeypatch.setenv(BLOCKS_ENV, "384,128,128")
        assert select_blocks("cpu") == (384, 128, 128)
        assert select_blocks("cpu", (128, 384, 128)) == (128, 384, 128)
        monkeypatch.delenv(BLOCKS_ENV)
    assert model.preset_blocks("fp8-hybrid", 4, "cpu", _pair(preset)[1]) == tile


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_preset_tile_gives_the_same_bits(mode, monkeypatch):
    """A fresh preset naming a tile leaves C as it was, and that tile given
    to the plain K1 as its padding tile gives the same bits too."""
    monkeypatch.delenv(BLOCKS_ENV, raising=False)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(lognormal_matrix(rng, (100, 90), 0.5))
    b = torch.from_numpy(lognormal_matrix(rng, (90, 70), 0.5))
    model.set_default_model(None)
    ref = ozmm_pallas_fused(a, b, family="fp8-hybrid", num_moduli=4, mode=mode)
    entries = [_entry(f"ozaki2-fp8/{mode}@4+pallas", 1e-4, blocks=(256, 128, 256),
                      blocks_key="cpu")]
    model.set_default_model(_pair(entries)[1])
    tile = model.preset_blocks("fp8-hybrid", 4, "cpu")
    assert tile == (256, 128, 256)
    assert torch.equal(ozmm_pallas_fused(a, b, family="fp8-hybrid", num_moduli=4, mode=mode),
                       ref)
    got = ozmm_pallas_fused(a, b, family="fp8-hybrid", num_moduli=4, mode=mode, blocks=tile)
    assert torch.equal(got, ref)
    assert torch.equal(got, ozmm(a, b, f"ozaki2-fp8/{mode}@4+core", device="cpu"))


# ---------------------------------------------------------------------------
# fingerprints and presets
# ---------------------------------------------------------------------------
def test_fingerprint_is_judged_for_the_device_of_the_call():
    fp = hardware_fingerprint("cpu")
    assert fp["platform"] == "cpu" and fp["device_name"] is None
    assert fp["torch_version"] == torch.__version__
    assert device_platform(torch.device("cpu")) == "cpu"
    assert device_platform("cuda:1") == "cuda"
    assert device_platform(None) == ("cuda" if torch.cuda.is_available() else "cpu")
    for recorded, current, fresh in ((None, {"platform": "cpu"}, False),
                                     ({"system": "Linux"}, {"platform": "cpu"}, False),
                                     ({"platform": "cpu"}, {"platform": "cpu"}, True),
                                     ({"platform": "cuda"}, {"platform": "cpu"}, False)):
        assert fingerprint_fresh(recorded, current) is fresh
        ref_recorded = recorded and {("jax_platform" if k == "platform" else k): v
                                     for k, v in recorded.items()}
        assert jax_model.fingerprint_fresh(
            ref_recorded, {"jax_platform": current["platform"]}) is fresh


def test_card_freshness_needs_the_same_compute_capability():
    """Past the reference's platform test: a card preset is fresh only on a
    card of the compute capability it recorded (its routes are built for
    sm_90a); where no card is visible the platform alone decides."""
    h100 = {"platform": "cuda", "compute_capability": [9, 0]}
    for recorded, current, fresh in ((h100, h100, True),
                                     (h100, dict(h100, compute_capability=(9, 0)), True),
                                     (h100, dict(h100, compute_capability=[8, 0]), False),
                                     (h100, {"platform": "cuda"}, True),
                                     ({"platform": "cuda"}, h100, False),
                                     ({"platform": "cuda"}, {"platform": "cuda"}, False),
                                     ({"platform": "cpu"}, {"platform": "cpu",
                                                            "compute_capability": None}, True)):
        assert fingerprint_fresh(recorded, current) is fresh, (recorded, current)
    mdl = model.PerfModel([model.PresetEntry(**_entry("ozaki2-int8/fast@9", 1e-8),
                                             backend="cuda")], {"fingerprint": h100})
    ampere = dict(h100, compute_capability=[8, 0])
    assert mdl.fresh(h100) and not mdl.fresh(ampere)


PRESETS = sorted(glob.glob(os.path.join(model.PRESETS_DIR, "*.json")))


def test_both_presets_are_shipped():
    assert {os.path.basename(p) for p in PRESETS} >= {"cpu-smoke.json", "h100-sm90.json"}


@pytest.mark.parametrize("path", PRESETS, ids=[os.path.basename(p) for p in PRESETS])
def test_shipped_preset_valid(path):
    mdl = model.PerfModel.load(path)
    assert mdl.entries
    prov = mdl.provenance
    assert {"commit", "fingerprint", "generated_by"} <= set(prov)
    platform = prov["fingerprint"]["platform"]
    assert {e.backend for e in mdl.entries} == {platform}
    assert all(e.blocks is None for e in mdl.entries)  # no preset names a tile
    assert mdl.fresh(hardware_fingerprint(platform))
    other = "cpu" if platform == "cuda" else "cuda"
    assert not mdl.fresh(hardware_fingerprint(other))
    assert json.load(open(path))["format_version"] == model.PRESET_FORMAT_VERSION


def test_default_model_keeps_each_device_to_its_own_presets(tmp_path):
    for platform in ("cpu", "cuda"):
        mdl = model.default_model(device=platform)
        assert mdl is not None and {e.backend for e in mdl.entries} == {platform}
    d = str(tmp_path)
    model.PerfModel([model.PresetEntry(**_entry("ozaki2-fp8/fast@6", 1e-8), backend="cpu")],
                    {"fingerprint": hardware_fingerprint("cpu")}).save(os.path.join(d, "a.json"))
    model.PerfModel([model.PresetEntry(**_entry("ozaki2-int8/fast@8", 1e-8), backend="cuda")],
                    {"fingerprint": {"platform": "cuda", "compute_capability": [9, 0]}}
                    ).save(os.path.join(d, "b.json"))
    model.PerfModel([model.PresetEntry(**_entry("ozaki2-int8/fast@9", 1e-8), backend="cuda")],
                    {"fingerprint": {"platform": "cuda"}}).save(os.path.join(d, "c.json"))
    with open(os.path.join(d, "corrupt.json"), "w") as f:
        f.write("{not json")
    cpu = model.default_model(d, device="cpu")
    assert [e.spec for e in cpu.entries] == ["ozaki2-fp8/fast@6"]
    assert list(cpu.provenance["merged"]) == ["a.json"]
    assert [e.spec for e in model.default_model(d, device="cuda").entries] == \
        ["ozaki2-int8/fast@8"]
    assert model.default_model(str(tmp_path / "empty")) is None


def test_smoke_shape_resolves_preset_backed_on_the_cpu():
    """The shipped CPU preset steers a CPU call at its bucket, and the
    resolved policy meets the tier it was asked for."""
    rng = np.random.default_rng(0)
    a_np, b_np = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    mdl = model.default_model(device="cpu")
    for tier in sorted({e.tier for e in mdl.entries}):
        got = model.resolve_fastest(a, b, tier)
        entry = mdl.lookup(64, 64, 64, "cpu", tier)
        want = parse_policy(entry.spec)
        assert (got.scheme, got.backend, got.fused) == (want.scheme, want.backend, want.fused)
        assert got.num_moduli >= want.num_moduli
        c = ozmm(a, b, got, device="cpu").numpy()
        err = np.abs(c - a_np @ b_np) / (np.abs(a_np) @ np.abs(b_np))
        assert err.max() <= tier


@pytest.mark.parametrize("case", ["rel_err_above_tier", "tier_zero", "tier_one",
                                  "bad_spec", "format_version", "no_provenance",
                                  "bad_entry"])
def test_model_validation_same_as_reference(case):
    def build(mod):
        e = dict(shape_bucket=BUCKET, backend="cpu", tier=1e-8, spec="ozaki2-fp8/fast@6",
                 wall_seconds=1e-3, rel_err=1e-10)
        if case == "rel_err_above_tier":
            return mod.PerfModel([mod.PresetEntry(**dict(e, rel_err=1e-4))], {})
        if case in ("tier_zero", "tier_one"):
            t = 0.0 if case == "tier_zero" else 1.0
            return mod.PerfModel([mod.PresetEntry(**dict(e, tier=t, rel_err=0.0))], {})
        if case == "bad_spec":
            return mod.PerfModel([mod.PresetEntry(**dict(e, spec="not-a-policy/x"))], {})
        if case == "format_version":
            return mod.PerfModel.from_dict({"format_version": 99, "provenance": {},
                                            "entries": []})
        if case == "no_provenance":
            return mod.PerfModel.from_dict({"format_version": 1, "entries": []})
        return mod.PresetEntry.from_dict({"spec": "x"})

    outcomes = []
    for mod in (jax_model, model):
        with pytest.raises(ValueError) as exc:
            build(mod)
        outcomes.append((type(exc.value).__name__, str(exc.value)))
    assert outcomes[1] == outcomes[0]


def test_round_trip_and_stable_json(tmp_path):
    mdl = model.PerfModel(
        [model.PresetEntry(**_entry("ozaki2-fp8/fast@6+pallas", 1e-8), backend="cpu",
                           blocks=(256, 128, 128), blocks_key="cpu"),
         model.PresetEntry(**_entry("ozaki2-int8/fast@8", 1e-4), backend="cpu")],
        {"fingerprint": hardware_fingerprint("cpu"), "commit": "abc"})
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    mdl.save(p1)
    loaded = model.PerfModel.load(p1)
    assert loaded.entries == mdl.entries and loaded.provenance == mdl.provenance
    loaded.save(p2)
    assert open(p1).read() == open(p2).read()
    # the reference reads the port's preset file, entry by entry
    ref = jax_model.PerfModel.from_dict(json.load(open(p1)))
    assert [e.to_dict() for e in ref.entries] == [e.to_dict() for e in loaded.entries]


# ---------------------------------------------------------------------------
# the sweep on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_core_cell():
    """The reference's measure_cell on its core route at 64^3, its obs state
    and trace buffer restored afterwards."""
    tracing, metrics = jax_obs.tracing_enabled(), jax_obs.metrics_enabled()
    try:
        return jax_sweep.measure_cell("ozaki2-fp8/fast@6", 64, 64, 64, reps=2)
    finally:
        jax_obs.reset()
        if not tracing:
            jax_obs.disable_tracing()
        if not metrics:
            jax_obs.disable_metrics()


def test_measure_cell_core_matches_reference(reference_core_cell):
    import repro_torch.obs.metrics as metrics

    assert not metrics.metrics_enabled()
    cell, c = sweep.measure_cell("ozaki2-fp8/fast@6+core", 64, 64, 64, reps=2, device="cpu",
                                 keep_output=True)
    assert not metrics.metrics_enabled()  # the obs state is restored
    want = reference_core_cell
    assert cell["rel_err"] == want["rel_err"]
    for key in ("m", "k", "n", "shape_bucket", "backend", "blocks", "blocks_key",
                "mma_ops", "residue_bytes"):
        assert cell[key] == want[key], key
    assert set(cell) == set(want)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 64)), rng.standard_normal((64, 64))
    assert torch.equal(c, ozmm(a, b, "ozaki2-fp8/fast@6+core", device="cpu"))


def test_measure_cell_routes_agree_and_record_no_tile():
    ops = sweep.Operands(64, 64, 64, torch.device("cpu"))
    outs = {}
    for suffix in ("+core", "+pallas", "+pallas+unfused"):
        cell, outs[suffix] = sweep.measure_cell(
            "ozaki2-int8/fast@6" + suffix, 64, 64, 64, reps=1, device="cpu",
            operands=ops, keep_output=True)
        assert cell["blocks"] is None and cell["blocks_key"] == ""
    assert all(torch.equal(c, outs["+core"]) for c in outs.values())
    with pytest.raises(ValueError, match="operands of"):
        sweep.measure_cell("ozaki2-int8/fast@6+pallas", 64, 64, 32, device="cpu",
                           operands=ops)


def test_run_sweep_on_the_cpu(tmp_path):
    seen = []
    result = sweep.run_sweep(((64, 64, 64), (60, 64, 50)), ["ozaki2-fp8/fast@4..6x2"],
                             ("core", "pallas"), (1e-4, 1e-8, 1e-12), reps=1, device="cpu",
                             on_cell=lambda cell, c: seen.append((cell["spec"], c.shape)),
                             log=lambda *_: None)
    cells = result["cells"]
    assert [s for s, _ in seen] == [c["spec"] for c in cells] and len(cells) == 8
    assert {c["shape_bucket"] for c in cells} == {"m64k64n64"}  # (60, 64, 50) buckets in
    assert result["pareto"] == {"m64k64n64@cpu": jax_sweep.pareto_front(cells)}
    cand = result["candidate"]
    winners = jax_sweep.select_winners(cells, (1e-4, 1e-8, 1e-12))
    assert [(e.tier, e.spec) for e in cand.entries] == [(t, w["spec"]) for t, w in
                                                        winners.items()]
    assert result["unmet_tiers"] == [f"m64k64n64@cpu tier={t:g}" for t in (1e-4, 1e-8, 1e-12)
                                     if t not in winners]
    assert cand.provenance["fingerprint"]["platform"] == "cpu"
    assert all(e.backend == "cpu" and e.blocks is None for e in cand.entries)
    path = str(tmp_path / "candidate.json")
    cand.save(path)
    assert model.PerfModel.load(path).entries == cand.entries


def test_sweep_cli_device_rule(tmp_path):
    out = str(tmp_path / "sweep")
    assert sweep.main(["--smoke", "--device", "cpu", "--specs", "ozaki2-fp8/fast@4",
                       "--reps", "1", "--out", out]) == 0
    doc = json.load(open(os.path.join(out, "pareto.json")))
    assert [c["spec"] for c in doc["cells"]] == ["ozaki2-fp8/fast@4+core",
                                                 "ozaki2-fp8/fast@4+pallas"]
    assert model.PerfModel.load(os.path.join(out, "preset_candidate.json")).entries
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.main(["--smoke", "--specs", "ozaki2-fp8/fast@4", "--out", out])
