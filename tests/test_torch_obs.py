"""repro_torch.obs vs repro.obs: after the same calls (forward GEMMs of
three families, a batched call, a prepared pairing, and a forward+backward
whose emulated backward records nothing) the metric snapshots are equal;
spans nest and export as the reference's validators require; the
bound-GEMM probe agrees to 1e-12; the drift monitor and the tripwire act
alike; the disabled path allocates nothing; and a fence synchronizes every
CUDA device it finds, and only those."""
import json
import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.gemm import ozmm as jax_ozmm
from repro.core.gemm import prepare_operand as jax_prepare_operand
from repro.obs import health as jhealth
from repro.obs import metrics as jmetrics
from repro.precision import PrecisionPolicy as JaxPolicy
from repro.testing import lognormal_matrix
from repro_torch import obs, ozmm, prepare_operand
from repro_torch.obs import export, health, metrics, trace
from repro_torch.precision import PrecisionPolicy

from _torch_parity import FakeCudaTensor
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def both_metrics_on():
    was = (metrics.metrics_enabled(), jmetrics.metrics_enabled())
    for m in (metrics, jmetrics):
        m.enable_metrics()
        m.reset_metrics()
    yield
    for m, on in zip((metrics, jmetrics), was):
        m.reset_metrics()
        if not on:
            m.disable_metrics()


@pytest.fixture
def tracing_on():
    was = trace.tracing_enabled()
    trace.enable_tracing()
    trace.clear_trace()
    yield
    trace.clear_trace()
    if not was:
        trace.disable_tracing()


def test_gemm_metric_snapshot_equals_reference(both_metrics_on):
    """The reference records a GEMM call at host level, once a trace
    (repro/obs/metrics.py, record_gemm_call), so its calls run under
    jax.eval_shape: the same records, no compile."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((8, 16)), rng.standard_normal((16, 8))
    a3, b3 = rng.standard_normal((2, 8, 16)), rng.standard_normal((2, 16, 8))
    for spec in ("ozaki2-fp8/fast@6", "ozaki2-int8/accurate@8", "ozaki2-karatsuba/fast@5",
                 "native", "ozaki1-fp8/fast@4"):
        jax.eval_shape(lambda x, y: jax_ozmm(x, y, spec), a, b)
        ozmm(a, b, spec, device="cpu")
    jax.eval_shape(lambda x, y: jax_ozmm(x, y, "ozaki2-fp8/accurate@6"), a3, b3)
    ozmm(a3, b3, "ozaki2-fp8/accurate@6", device="cpu")
    jax.eval_shape(lambda x, y: jax_ozmm(jax_prepare_operand(x, "lhs", "ozaki2-fp8/fast@6"), y,
                                         "ozaki2-fp8/fast@6"), a, b)
    ozmm(prepare_operand(a, "lhs", "ozaki2-fp8/fast@6", device="cpu"), b, "ozaki2-fp8/fast@6")
    # forward + backward: the call counts once, the backward records nothing
    jax.eval_shape(jax.grad(lambda x, y: jnp.sum(jax_ozmm(x, y, "ozaki2-fp8/accurate@7")),
                            argnums=(0, 1)), jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    ozmm(ta, tb, "ozaki2-fp8/accurate@7", device="cpu").sum().backward()
    assert ta.grad is not None
    got, want = metrics.global_registry().snapshot(), jmetrics.global_registry().snapshot()
    assert got == want
    assert got["counters"]["gemm.calls{mode=accurate,num_moduli=7,scheme=ozaki2-fp8,"
                           "shape=m8k16n8}"] == 1.0
    assert metrics.global_registry().counter_total("gemm.calls") == 6.0


def test_registry_emitters_and_gemm_derived_equal_reference(both_metrics_on):
    for m in (metrics, jmetrics):
        m.inc("unit.calls", 2.0, kind="a")
        m.gauge("unit.level", 3.5)
        for v in (1e-7, 0.3, 9.0, 5e6):
            m.observe("unit.seconds", v, phase="x")
    for args in (("fp8-hybrid", 12, "accurate", 64, 32, 16),
                 ("int8", 14, "fast", 8192, 8192, 8192),
                 ("fp8-karatsuba", 9, "fast", 3, 5, 7)):
        assert metrics._gemm_derived(*args) == jmetrics._gemm_derived(*args)
        assert metrics.shape_bucket(*args[3:]) == jmetrics.shape_bucket(*args[3:])
    assert metrics.global_registry().snapshot() == jmetrics.global_registry().snapshot()


def test_disabled_path_allocates_and_records_nothing():
    metrics.disable_metrics()
    metrics.reset_metrics()
    metrics.record_gemm_call("ozaki2-fp8", "fast", "fp8-hybrid", 8, 8, 8, 8)
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    for _ in range(1000):
        metrics.record_gemm_call("ozaki2-fp8", "fast", "fp8-hybrid", 8, 8, 8, 8)
    now, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert now - base < 4096
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((8, 8)), rng.standard_normal((8, 8))
    np.testing.assert_allclose(ozmm(a, b, "ozaki2-fp8/fast@8", device="cpu").numpy(),
                               a @ b, rtol=1e-9, atol=1e-9)
    assert metrics.global_registry().snapshot()["counters"] == {}
    trace.disable_tracing()
    trace.clear_trace()
    with trace.span("off") as sp:
        pass
    assert sp.elapsed >= 0.0 and trace.trace_events() == []


def test_spans_nest_and_export_validates(tracing_on, tmp_path):
    @trace.span("unit.fn", kind="decorated")
    def work(x):
        return x + 1

    with trace.span("outer", n=4) as outer:
        with trace.span("inner") as inner:
            inner.set_attrs(size=3)
        assert work(1) == 2
    with pytest.raises(KeyError):
        with trace.span("fails"):
            raise KeyError("x")
    events = {ev["name"]: ev for ev in trace.trace_events()}
    assert events["outer"]["parent"] is None
    assert events["inner"]["parent"] == events["unit.fn"]["parent"] == events["outer"]["id"]
    assert events["inner"]["attrs"] == {"size": 3}
    assert events["fails"]["error"] == "KeyError"
    assert outer.elapsed >= inner.elapsed >= 0
    assert trace.TRACE_CLOCK == "perf_counter_us"
    path = tmp_path / "trace.json"
    n = export.write_chrome_trace(str(path), metrics_snapshot={"counters": {"c": 1.0}})
    doc = export.validate_chrome_trace(str(path))
    assert n == len(doc["traceEvents"]) == 5
    lines = export.validate_jsonl(export.write_jsonl(str(tmp_path / "e.jsonl")) and
                                  str(tmp_path / "e.jsonl"))
    assert len(lines) == 6
    summ = export.summary()
    assert summ["inner"]["count"] == 1 and summ["outer"]["total_s"] >= summ["inner"]["total_s"]
    assert 0 < export.span_coverage(outer.elapsed, prefix="outer") <= 1.0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    with pytest.raises(ValueError, match="phase"):
        export.validate_chrome_trace(str(bad))


def test_fence_synchronizes_each_cuda_device_it_finds(monkeypatch, tracing_on):
    """The port's fence (the reference blocks on its arrays): every CUDA
    tensor found in a tensor, tuple/list/dict or plan is synchronized by
    device; CPU tensors need none. FakeCudaTensor stands in for the card."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    cpu = torch.zeros(2)
    fake = cpu.as_subclass(FakeCudaTensor)
    plan = prepare_operand(np.ones((4, 4)), "lhs", "ozaki2-fp8/fast@4", device="cpu")
    with trace.span("cpu") as sp:
        assert sp.fence((cpu, [cpu], {"q": plan})) [0] is cpu
    assert synced == []
    with trace.span("card") as sp:
        sp.fence({"a": [cpu, (fake,)], "b": fake})
    assert synced == [torch.device("cuda", 0)]


def test_bound_gemm_probe_matches_reference():
    rng = np.random.default_rng(0)
    for phi in (0.5, 1.0):  # spreads where the bound GEMM's f32 sums are exact
        a = lognormal_matrix(rng, (16, 24), phi)
        b = lognormal_matrix(rng, (24, 16), phi)
        got = health.bound_gemm_probe(a, b, device="cpu")
        want = jhealth.bound_gemm_probe(a, b)
        assert abs(got - want) <= 1e-12
        assert got >= np.log2(np.max(np.abs(a @ b)))
        # tensors stay on their device; arrays go to the card unless asked
        assert health.bound_gemm_probe(torch.from_numpy(a), torch.from_numpy(b)) == got
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                health.bound_gemm_probe(a, b)


def test_tripwire_and_drift_monitor_act_as_reference():
    rng = np.random.default_rng(1)
    a = lognormal_matrix(rng, (16, 16), 3.0)
    b = lognormal_matrix(rng, (16, 16), 3.0)
    runs = []
    for h, m, pol in ((health, metrics, PrecisionPolicy),
                      (jhealth, jmetrics, JaxPolicy)):
        reg, trips, esc = m.MetricsRegistry(), [], []
        on_cpu = {"device": "cpu"} if h is health else {}
        tw = h.AccuracyTripwire(pol(scheme="ozaki2-fp8", mode="fast"), 1e-300, sample_every=2,
                                on_trip=lambda est, tgt: trips.append(est), registry=reg,
                                **on_cpu)
        ests = [tw.observe(a, b) for _ in range(4)]
        mon = h.DriftMonitor(pol(scheme="ozaki2-fp8", mode="fast", num_moduli=8), 2.0, 1e-10,
                             k=64, on_escalate=esc.append, registry=reg, name="unit")
        reports = [tuple(mon.check(x)) for x in (2.25, 22.0, a)]
        runs.append((ests, trips, tw.trips, reports, esc, mon.escalations,
                     reg.snapshot()["counters"], reg.snapshot()["gauges"]))
    (ests, trips, n, reports, esc, nesc, counters, gauges), ref = runs
    assert ests[0] is None and ests[1] is not None and n == 2 == len(trips)
    assert reports[1][0] and esc[0] == reports[1][3] and nesc == len(esc)
    assert (ests, trips, n, reports, esc, nesc, counters) == ref[:7]
    assert gauges.keys() == ref[7].keys()
    for key, value in gauges.items():
        # the bound GEMM's f32 sums of e4m3 products are inexact at phi = 3
        # and torch and XLA sum in different orders: Cbar may differ by an
        # f32 ulp, its log2 by ~2^-24 / ln 2 (ROADMAP Queue C)
        tol = 1e-6 if key == "health.tripwire.bound_max_log2" else 1e-12
        assert abs(value - ref[7][key]) <= tol, key


def test_residue_headroom_matches_reference():
    rng = np.random.default_rng(2)
    a = lognormal_matrix(rng, (12, 20), 1.0)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for spec in ("ozaki2-fp8/fast@6", "ozaki2-karatsuba/fast@5", "ozaki2-int8/fast@8"):
        got = health.residue_headroom(prepare_operand(a, "lhs", spec, device="cpu"), reg)
        want = jhealth.residue_headroom(jax_prepare_operand(a, "lhs", spec), jreg)
        assert got == want
    with pytest.raises(ValueError, match="fast-mode plan"):
        health.residue_headroom(prepare_operand(a, "lhs", "ozaki2-fp8/accurate@6",
                                                device="cpu"))
    assert obs.enabled() in (True, False) and set(obs.__all__) >= {"span", "summary"}
