"""repro_torch.perf's stdlib layers and repro_torch.testing vs the reference:
the schema-v2 row validator (the same rows and documents pass, or fail
with the same message), the trajectory store and its regression report
(the same report on the same store contents, the platform field named as
each package names it), the sweep's pure functions (expand_specs,
pareto_front, select_winners, in shuffled orders too) and the test-matrix
generators (bitwise for one seed). Pure Python and numpy: no kernel runs."""
import copy
import json
import os
import random

import numpy as np
import pytest

import repro.testing as jax_testing
from repro.perf import rows as jax_rows
from repro.perf import sweep as jax_sweep
from repro.perf import trajectory as jax_traj
from repro_torch import testing
from repro_torch.perf import rows, sweep, trajectory

# ---------------------------------------------------------------------------
# test-matrix generators
# ---------------------------------------------------------------------------
GENERATORS = [
    ("lognormal_matrix", ((7, 5), 1.5)),
    ("well_conditioned_matrix", (12,)),
    ("graded_matrix", (12, 6.0)),
    ("spd_matrix", (12, 3.0)),
]


@pytest.mark.parametrize("name,args", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_bitwise_equal_to_reference(name, args):
    want = getattr(jax_testing, name)(np.random.default_rng(11), *args)
    got = getattr(testing, name)(np.random.default_rng(11), *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the row schema
# ---------------------------------------------------------------------------
def _row(mod, **patch):
    row = mod.make_row("fig456_throughput", "fig456/cell", 0.25,
                       policy="ozaki2-fp8/fast@8", throughput=1.5,
                       throughput_unit="TF-equiv", accuracy=1e-9,
                       accuracy_gate=1e-8, derived="d", wire_bytes=100)
    row.update(patch)
    return row


ROW_PATCHES = [
    {}, {"schema_version": 1}, {"name": ""}, {"bench": None}, {"wall_seconds": -1.0},
    {"wall_seconds": "x"}, {"throughput": "fast"}, {"accuracy_gate": []},
    {"policy": 3}, {"throughput_unit": 1.0}, {"derived": None}, {"extra": []},
    {"obs": "x"}, {"obs": {"roofline": 0.5}}, {"bogus": 1},
    {"accuracy": None}, {"accuracy": None, "accuracy_gate": None},
]


def _outcome(fn, *args):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as exc:  # noqa: BLE001 — the comparison is the point
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("patch", ROW_PATCHES, ids=[",".join(p) or "valid" for p in ROW_PATCHES])
def test_validate_row_same_verdict_and_message(patch):
    ref = _outcome(jax_rows.validate_row, _row(jax_rows, **patch))
    got = _outcome(rows.validate_row, _row(rows, **patch))
    assert got == ref


def test_missing_key_and_non_dict_rows():
    r_ref, r_got = _row(jax_rows), _row(rows)
    del r_ref["policy"], r_got["policy"]
    assert _outcome(rows.validate_row, r_got) == _outcome(jax_rows.validate_row, r_ref)
    assert _outcome(rows.validate_row, [1]) == _outcome(jax_rows.validate_row, [1])


LEGACY = [("fig3/x", 1234.5, "0.1 TF"), ["x", 0.0, "d"], ("x", 1.0),
          {"name": "linalg/lu", "wall_seconds": 0.5}, {"name": "x", "us_per_call": 2e6},
          {"name": "x", "us_per_call": 5.0, "policy": "native", "extra": {"k": 1}}, 42]


@pytest.mark.parametrize("row", LEGACY, ids=[str(i) for i in range(len(LEGACY))])
def test_normalize_row_matches_reference(row):
    assert _outcome(rows.normalize_row, "b", copy.deepcopy(row)) == \
        _outcome(jax_rows.normalize_row, "b", copy.deepcopy(row))


def _doc(mod, results, **top):
    doc = {"schema_version": 2, "policy_specs": None, "smoke": True, "argv": [],
           "timestamp": "2026-01-01T00:00:00", "commit": "abc",
           "fingerprint": {"system": "Linux"}, "results": results, "obs": {}}
    doc.update(top)
    return doc


DOC_CASES = {
    "valid": lambda m: _doc(m, [_row(m), _row(m, name="other")]),
    "legacy_version": lambda m: _doc(m, [], schema_version=1),
    "not_a_dict": lambda m: [],
    "no_results": lambda m: _doc(m, None),
    "duplicate_name": lambda m: _doc(m, [_row(m), _row(m)]),
    "bad_row": lambda m: _doc(m, [_row(m, wall_seconds=-2.0)]),
    "no_fingerprint": lambda m: _doc(m, [_row(m)], fingerprint=None),
}


@pytest.mark.parametrize("case", sorted(DOC_CASES))
def test_validate_results_same_verdict_and_message(case):
    assert _outcome(rows.validate_results, DOC_CASES[case](rows)) == \
        _outcome(jax_rows.validate_results, DOC_CASES[case](jax_rows))


def test_make_results_doc_and_load(tmp_path):
    doc = rows.make_results_doc([_row(rows)], policy_specs=["ozaki2-fp8/fast@8"],
                                smoke=True, argv=["--smoke"], device="cpu")
    assert doc["fingerprint"]["platform"] == "cpu"
    assert set(doc) == set(jax_rows.make_results_doc([_row(jax_rows)]))
    path = tmp_path / "bench_results.json"
    path.write_text(json.dumps(doc))
    assert rows.load_results(str(path)) == doc
    # a port document is a valid reference document, and back
    assert jax_rows.validate_results(json.loads(path.read_text()))


# ---------------------------------------------------------------------------
# the trajectory store and its report
# ---------------------------------------------------------------------------
def _traj_doc(platform_key, wall, throughput, accuracy=None, gate=None, specs=None,
              commit="c0"):
    rs = [jax_rows.make_row("fig456_throughput", "fig456/core", wall,
                            policy="ozaki2-fp8/fast@8", throughput=throughput,
                            throughput_unit="TF-equiv", accuracy=accuracy,
                            accuracy_gate=gate),
          jax_rows.make_row("fig456_throughput", "fig456/k1", wall / 2,
                            throughput=throughput * 2, throughput_unit="TF-equiv"),
          jax_rows.make_row("linalg", "linalg/lu", wall * 3)]
    return _doc(jax_rows, rs, fingerprint={platform_key: "cpu", "system": "Linux"},
                policy_specs=specs, commit=commit)


HISTORY = [(0.10, 100.0), (0.11, 95.0), (0.09, 104.0), (0.10, 99.0), (0.12, 90.0),
           (0.10, 101.0)]
CURRENT = {
    "seeded": dict(wall=0.10, throughput=100.0),
    "ok": dict(wall=0.105, throughput=98.0),
    "slower": dict(wall=0.2, throughput=100.0),
    "faster": dict(wall=0.05, throughput=180.0),
    "throughput_drop": dict(wall=0.1, throughput=50.0),
    "accuracy_breach": dict(wall=0.1, throughput=100.0, accuracy=1e-6, gate=1e-8),
    "accuracy_ok": dict(wall=0.1, throughput=100.0, accuracy=1e-9, gate=1e-8),
    "other_config": dict(wall=0.2, throughput=50.0, specs=["ozaki2-int8/fast@8"]),
}


@pytest.mark.parametrize("case", sorted(CURRENT))
def test_compare_results_same_report_on_same_store(tmp_path, case):
    reports, codes = {}, {}
    for name, mod, key in (("ref", jax_traj, "jax_platform"), ("port", trajectory, "platform")):
        (tmp_path / name).mkdir()
        store = tmp_path / name / "traj"
        if case != "seeded":
            for i, (wall, thr) in enumerate(HISTORY):
                assert mod.append_results(_traj_doc(key, wall, thr, commit=f"c{i}"),
                                          str(store)) == 3
        kw = dict(CURRENT[case])
        doc = _traj_doc(key, kw.pop("wall"), kw.pop("throughput"), **kw)
        report = mod.compare_results(doc, str(store), tol=0.15, k=5)
        report.pop("generated")
        reports[name] = report
        path = tmp_path / name / "current.json"
        path.write_text(json.dumps(doc))
        codes[name] = mod.main(["--compare", str(path), "--store", str(store),
                                "--report", str(tmp_path / name / "report.json")])
    assert reports["port"] == reports["ref"]
    assert codes["port"] == codes["ref"]
    if case != "seeded":
        assert os.listdir(tmp_path / "port" / "traj") == os.listdir(tmp_path / "ref" / "traj")


def test_trajectory_store_round_trip_and_garbage(tmp_path):
    """append_results / load_series / baseline_value read a store the way the
    reference does, truncated and foreign lines included."""
    store = tmp_path / "traj"
    for wall, thr in HISTORY:
        trajectory.append_results(_traj_doc("platform", wall, thr), str(store))
    (store / "junk.jsonl").write_text('not json\n{"name": "x", "wall_seconds": 1.0}\n[1]\n')
    got, want = trajectory.load_series(str(store)), jax_traj.load_series(str(store))
    assert got == want
    key = ("fig456_throughput__smoke__cpu", "fig456/core")
    assert trajectory.baseline_value(got[key], "wall_seconds", 3) == \
        jax_traj.baseline_value(want[key], "wall_seconds", 3)
    assert trajectory.load_series(str(tmp_path / "none")) == {}


def test_store_key_reads_the_port_platform_field():
    doc = _traj_doc("platform", 0.1, 1.0, specs=["ozaki2-fp8/fast@8+pallas"])
    ref_doc = _traj_doc("jax_platform", 0.1, 1.0, specs=["ozaki2-fp8/fast@8+pallas"])
    for row, ref_row in zip(doc["results"], ref_doc["results"]):
        assert trajectory.store_key(doc, row) == jax_traj.store_key(ref_doc, ref_row)
    assert trajectory.store_key(dict(doc, fingerprint={"platform": "cuda"}),
                                doc["results"][0]).endswith("__cuda")


def test_trajectory_cli_rejects_a_malformed_artifact(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"schema_version": 1, "results": []}))
    args = ["--compare", str(path), "--store", str(tmp_path / "traj")]
    assert trajectory.main(args) == jax_traj.main(args) == 2


# ---------------------------------------------------------------------------
# the sweep's pure functions
# ---------------------------------------------------------------------------
SPEC_LISTS = [
    ["ozaki2-fp8/fast@4..8"], ["ozaki2-fp8/fast@4..10x2", "ozaki2-int8/fast@6..14x4"],
    ["ozaki2-karatsuba/fast", "ozaki2-fp8/accurate@12", "native"],
    ["ozaki2-fp8/fast@8..12x2+pallas"], ["ozaki2-fp8/fast@5..5"],
    ["ozaki2-fp8/fast@8..4"], ["ozaki2-fp8/fast@4..8x0"],
]


@pytest.mark.parametrize("specs", SPEC_LISTS, ids=[str(i) for i in range(len(SPEC_LISTS))])
def test_expand_specs_matches_reference(specs):
    assert _outcome(sweep.expand_specs, specs) == _outcome(jax_sweep.expand_specs, specs)


def _cells(seed: int, n: int = 40) -> list[dict]:
    """Cells with ties in time, in error and in both (the front's and the
    winners' tie-breaks)."""
    rng = random.Random(seed)
    cells = []
    for i in range(n):
        cells.append({"spec": f"ozaki2-fp8/fast@{rng.randint(2, 14)}+{rng.choice('ab')}{i % 7}",
                      "wall_seconds": rng.choice([1e-3, 2e-3, 3e-3, rng.random() * 1e-2]),
                      "rel_err": rng.choice([1e-4, 1e-9, 1e-13, 10.0 ** -rng.uniform(2, 15)])})
    cells.append(dict(cells[0], spec="a-duplicate"))
    return cells


@pytest.mark.parametrize("seed", range(4))
def test_pareto_front_and_winners_match_reference_in_any_order(seed):
    cells = _cells(seed)
    tiers = (1e-4, 1e-8, 1e-12, 1e-16)
    want_front = jax_sweep.pareto_front(cells)
    want_win = jax_sweep.select_winners(cells, tiers)
    for shuffle in range(3):
        order = list(cells)
        random.Random(100 * seed + shuffle).shuffle(order)
        assert sweep.pareto_front(order) == want_front
        assert sweep.select_winners(order, tiers) == want_win
        # the keyword form the sweep's callers use
        assert sweep.pareto_front(order, time_key="wall_seconds", err_key="rel_err",
                                  id_key="spec") == want_front


def test_sweep_grammar_constants_match_reference():
    assert sweep.DEFAULT_TIERS == jax_sweep.DEFAULT_TIERS
    assert sweep.SMOKE_SHAPES == jax_sweep.SMOKE_SHAPES
    assert sweep.SMOKE_SPECS == jax_sweep.SMOKE_SPECS
    assert sweep.SMOKE_ROUTES == jax_sweep.SMOKE_ROUTES
    assert set(sweep._ROUTE_SUFFIX) == set(jax_sweep._ROUTE_SUFFIX)
    # the port's "core" route names +core: a bare spec takes the kernel route
    # on a Hopper card, where the reference's sweeps its core route on the CPU
    assert sweep._ROUTE_SUFFIX["core"] == "+core"
    assert {r: sweep._ROUTE_SUFFIX[r] for r in ("pallas", "unfused")} == \
        {r: jax_sweep._ROUTE_SUFFIX[r] for r in ("pallas", "unfused")}


def test_full_grid_holds_each_familys_floor():
    """resolve_fastest clamps a preset's count up to the resolver's floor, so
    the full grid sweeps each family at its floor for every tier at both of
    its contractions (standard-normal operands, whose summed log2 spread a
    2^20-element draw gives), and names no spec twice."""
    from repro_torch.precision import parse_policy
    from repro_torch.precision.resolve import operand_spread_log2

    specs = sweep.expand_specs(sweep.FULL_SPECS)
    assert len(set(specs)) == len(specs)
    swept = set()
    for spec in specs:
        pol = parse_policy(spec)
        swept.add((pol.scheme, pol.mode, pol.moduli_set().n))
    spread = 2 * operand_spread_log2(np.random.default_rng(0).standard_normal(1 << 20))
    for _, k, _ in sweep.FULL_SHAPES:
        for scheme, mode in {key[:2] for key in swept}:
            base = parse_policy(f"{scheme}/{mode}")
            for tier in sweep.DEFAULT_TIERS:
                n = base.resolve_for(None, None, tier, k=k, spread_log2=spread).num_moduli
                assert (scheme, mode, n) in swept, (scheme, mode, k, tier, n)

