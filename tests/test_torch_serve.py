"""repro_torch.serve against repro.serve on the qwen2-7b smoke config with
the same weights: the weight-residue cache (the same leaves, per-layer
plans equal to the reference's stacked plans sliced at the layer: parts
and scale frames bitwise, f64 sums of squares to rtol 1e-15,
the same nbytes, the same sketches and accuracy-class modulus counts), the
host-side pieces (PageAllocator, Scheduler, Request) on the same call
sequences, and the engines: BatchingEngine and ServeEngine greedy tokens
equal to the reference's under native, the same bucket (trace) counts, KV
pools updated in place, and, within the port, a fast-mode paged batch
bitwise equal to each request run alone."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.precision import resolve_for_sketches as ref_resolve_for_sketches
from repro.serve import BatchingEngine as RefBatchingEngine
from repro.serve import PageAllocator as RefPageAllocator
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import WeightResidueCache as RefWeightResidueCache
from repro.serve import collect_weight_sketches as ref_collect_weight_sketches
from repro.serve import quantize_params as ref_quantize_params
from repro.serve.batching import resolve_accuracy_target as ref_resolve_accuracy_target
from repro_torch.precision import parse_policy, resolve_for_sketches
from repro_torch.serve import (ACCURACY_CLASSES, BatchingEngine, PageAllocator, Request,
                               RequestStatus, Scheduler, ServeEngine, WeightResidueCache,
                               collect_weight_sketches, quantize_params)
from repro_torch.serve.batching import resolve_accuracy_target

from _torch_models_parity import one_torch_thread, smoke_pair  # noqa: F401

FAST = "ozaki2-fp8/fast"


def _prompts(rng, n, lo=4, hi=8):
    return [[int(t) for t in rng.integers(1, 512, int(rng.integers(lo, hi + 1)))]
            for _ in range(n)]


def _as_bytes(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def _ref_bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _ref_path(port_path: str) -> tuple[str, int | None]:
    """A port leaf path as the reference's and the layer it holds:
    'stages.0.1.attn.wq' -> ("['stages'][0]['attn']['wq']", 1); a
    stage-level sketch path 'stages.0.attn.wq' -> (..., None)."""
    parts = port_path.split(".")
    if parts[0] != "stages":
        return "".join(f"['{p}']" for p in parts), None
    layer = int(parts[2]) if parts[2].isdigit() else None
    rest = "".join(f"['{p}']" for p in parts[2 + (layer is not None):])
    return f"['stages'][{parts[1]}]{rest}", layer


@pytest.fixture(scope="module")
def fast_cached():
    """Both packages' fast-mode weight caches of the same smoke weights."""
    ref_model, ref_params, model, params = smoke_pair()
    ref_cache = RefWeightResidueCache(FAST)
    ref_serve = ref_quantize_params(ref_params, FAST, ref_cache)
    cache = WeightResidueCache(FAST)
    serve = quantize_params(params, FAST, cache)
    return ref_params, ref_serve, ref_cache, params, serve, cache


def test_weight_cache_selects_reference_leaves(fast_cached):
    ref_params, ref_serve, ref_cache, params, serve, cache = fast_cached
    ref_paths = {p for p, _, _ in ref_cache._cache}
    ports = [p for p, _, _ in cache._cache]
    assert {_ref_path(p)[0] for p in ports} == ref_paths
    assert len(ports) == 7 * 2 + 1
    # non-weight leaves pass through; the raw params stay as they were
    assert serve.embed is params.embed and serve.stages[0][0].attn.bq is params.stages[0][0].attn.bq
    assert isinstance(params.stages[0][0].attn.wq, torch.nn.Parameter)
    assert quantize_params(params, "native") is params


def test_per_layer_plans_equal_reference_slices(fast_cached):
    """Each per-layer plan equals the reference's vmapped stacked plan at
    that layer: residue parts, lscale frames and the abs-max sketches
    bitwise, the f64 source dropped in fast mode, the sums of squares to a
    few ulps (rtol 1e-15, XLA's summation order against torch's)."""
    ref_params, ref_serve, ref_cache, params, serve, cache = fast_cached
    for (path, role, _), plan in cache._cache.items():
        ref_path, layer = _ref_path(path)
        (ref_plan,) = [q for (p, r, _), q in ref_cache._cache.items() if p == ref_path]
        pick = (lambda a: np.asarray(a)) if layer is None else (lambda a: np.asarray(a)[layer])
        assert plan.x is None and ref_plan.x is None and plan.role == ref_plan.role == role
        np.testing.assert_array_equal(plan.lscale.numpy(), pick(ref_plan.lscale), err_msg=path)
        for f in ("row_max", "col_max"):
            np.testing.assert_array_equal(getattr(plan.stats, f).numpy(),
                                          pick(getattr(ref_plan.stats, f)), err_msg=path)
        # the f64 sums of squares (up to 512 terms) are summed in XLA's
        # order there and in torch's here: equal to a few ulps (the scaling
        # reads them through a floor of log2 with a guard, so lscale above
        # is equal bitwise)
        for f in ("row_sq", "col_sq"):
            np.testing.assert_allclose(getattr(plan.stats, f).numpy(),
                                       pick(getattr(ref_plan.stats, f)), rtol=1e-15, atol=0,
                                       err_msg=path)
        assert [len(p) for p in plan.parts] == [len(p) for p in ref_plan.parts]
        for mine, ref in zip(plan.parts, ref_plan.parts):
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(_as_bytes(a), _ref_bytes(pick(b)), err_msg=path)


def test_cache_nbytes_equal(fast_cached):
    ref_params, ref_serve, ref_cache, params, serve, cache = fast_cached
    assert cache.nbytes() == ref_cache.nbytes() > 0
    assert len(cache) == 15 and quantize_params(params, FAST, cache) is not serve
    assert len(cache) == 15  # a second pass hits every plan


def test_sketches_and_accuracy_classes_match(fast_cached):
    ref_params, ref_serve, ref_cache, params, serve, cache = fast_cached
    ref_sk = ref_collect_weight_sketches(ref_params)
    sk = collect_weight_sketches(params)
    assert ({(_ref_path(s.path)[0], s.contract_dim, s.spread_log2) for s in sk}
            == {(s.path, s.contract_dim, s.spread_log2) for s in ref_sk})
    from repro.precision import parse_policy as ref_parse_policy

    for name, target in ACCURACY_CLASSES.items():
        assert resolve_accuracy_target(name) == ref_resolve_accuracy_target(name) == target
        assert (resolve_for_sketches(parse_policy(FAST), sk, target)
                == ref_resolve_for_sketches(ref_parse_policy(FAST), ref_sk, target)), name


def test_page_allocator_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = PageAllocator(12, 4), RefPageAllocator(12, 4)
    held_ours, held_ref = [], []
    for _ in range(200):
        if held_ours and rng.random() < 0.45:
            i = int(rng.integers(len(held_ours)))
            ours.release(held_ours.pop(i))
            ref.release(held_ref.pop(i))
        else:
            n = int(rng.integers(1, 5))
            assert ours.can_alloc(n) == ref.can_alloc(n)
            if ours.can_alloc(n):
                held_ours.append(ours.alloc(n))
                held_ref.append(ref.alloc(n))
                assert held_ours[-1] == held_ref[-1]
            else:
                with pytest.raises(MemoryError):
                    ours.alloc(n)
        assert ours.num_free == ref.num_free
    assert ours.pages_needed(9) == ref.pages_needed(9) == 3
    np.testing.assert_array_equal(ours.block_table_row([3, 5], 4), ref.block_table_row([3, 5], 4))
    with pytest.raises(ValueError, match="double free"):
        ours.release([99])


@pytest.mark.parametrize("mode", ["fifo", "priority"])
def test_scheduler_and_requests_match_reference(mode):
    """The same submits, deadlines and capacity verdicts give the same
    admitted / expired / rejected order in both schedulers."""
    rng = np.random.default_rng(3)
    ours, ref = Scheduler(mode), RefScheduler(mode)
    index_ours, index_ref = {}, {}
    for i in range(30):
        kw = dict(tokens=(1, 2, 3)[: int(rng.integers(1, 4))],
                  max_new_tokens=int(rng.integers(1, 5)), priority=int(rng.integers(0, 3)),
                  deadline=float(rng.choice([np.inf, 0.5, 2.0])))
        a, b = Request(**kw), RefRequest(**kw)
        assert a.total_len == b.total_len
        index_ours[a.request_id], index_ref[b.request_id] = i, i
        ours.submit(a)
        ref.submit(b)
    for now in (0.0, 1.0, 3.0):
        budget = [6]

        def can_admit(req, budget=budget):
            if req.max_new_tokens == 4:
                return "reject"
            if budget[0] == 0:
                return "defer"
            budget[0] -= 1
            return "admit"

        got = ours.drain(now, can_admit)
        budget[0] = 6
        want = ref.drain(now, can_admit)
        assert ([[index_ours[r.request_id] for r in xs] for xs in got]
                == [[index_ref[r.request_id] for r in xs] for xs in want])
        assert len(ours) == len(ref)
    with pytest.raises(ValueError, match="empty prompt"):
        Request(tokens=(), max_new_tokens=1)
    with pytest.raises(ValueError, match="unknown accuracy class"):
        Request(tokens=(1,), max_new_tokens=1, accuracy="best")


@pytest.fixture(scope="module")
def native_runs():
    """One workload through both packages' BatchingEngine (paged) and
    ServeEngine under native, on the same weights."""
    ref_model, ref_params, model, params = smoke_pair()
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, 5, lo=3, hi=9)
    budgets = [int(b) for b in rng.integers(1, 5, 5)]
    out = {}
    for name, (Engine, mdl, prm) in {"ref": (RefBatchingEngine, ref_model, ref_params),
                                     "port": (BatchingEngine, model, params)}.items():
        eng = Engine(mdl, prm, max_len=16, max_slots=4, page_size=4)
        rids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        res = eng.run()
        g = eng._base_group
        out[name] = ([res[r].tokens for r in rids], [res[r].status.name for r in rids],
                     (g.prefill_traces, g.decode_traces), eng.stats()["decode_tokens"])
    batch = np.random.default_rng(1).integers(1, 512, (2, 6))
    out["ref_serve"] = np.asarray(RefServeEngine(ref_model, ref_params, max_len=12).generate(
        {"tokens": jnp.asarray(batch)}, steps=3))
    out["port_serve"] = ServeEngine(model, params, max_len=12).generate(
        {"tokens": torch.from_numpy(batch)}, steps=3).numpy()
    return out


def test_batching_engine_tokens_match_reference(native_runs):
    assert native_runs["port"][0] == native_runs["ref"][0]
    assert native_runs["port"][1] == native_runs["ref"][1]
    assert native_runs["port"][3] == native_runs["ref"][3]


def test_bucket_counts_match_reference_traces(native_runs):
    """prefill_traces/decode_traces (distinct bucket shapes run) equal the
    reference's jit trace counts for the same requests."""
    assert native_runs["port"][2] == native_runs["ref"][2]


def test_serve_engine_tokens_match_reference(native_runs):
    np.testing.assert_array_equal(native_runs["port_serve"], native_runs["ref_serve"])
    assert native_runs["port_serve"].shape == (2, 3)


def test_fast_paged_batch_equals_single_requests():
    """Fast mode, within the port: each request of a crowded paged batch
    (3 requests, 2 slots) gets the tokens and the logits of its run alone
    through ServeEngine, bitwise."""
    _, _, model, params = smoke_pair()
    model = type(model)(dataclasses.replace(model.cfg, gemm=FAST), device="cpu")
    prompts = _prompts(np.random.default_rng(2), 3)

    def recorded(engine):
        rows = {}
        emit = engine._emit

        def record(slot, row):
            rows.setdefault(slot.req.request_id, []).append(row.clone())
            return emit(slot, row)

        engine._emit = record
        return rows

    eng = BatchingEngine(model, params, max_len=12, max_slots=2, page_size=4)
    assert eng.paged
    rows = recorded(eng)
    rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
    results = eng.run()
    alone = ServeEngine(model, params, max_len=12)
    alone_rows = recorded(alone._engine_for(1))
    for rid, p in zip(rids, prompts):
        before = set(alone_rows)
        toks = alone.generate({"tokens": torch.tensor([p])}, steps=3)
        (new,) = set(alone_rows) - before
        assert results[rid].status is RequestStatus.FINISHED
        assert toks[0].tolist() == results[rid].tokens
        for a, b in zip(alone_rows[new], rows[rid]):
            assert torch.equal(a, b)


def test_kv_pools_updated_in_place():
    """Across a pure decode step the pools keep their storage (the
    reference donates them to its jitted step)."""
    _, _, model, params = smoke_pair()
    eng = BatchingEngine(model, params, max_len=16, max_slots=2, page_size=4)
    eng.submit([5, 6, 7, 8], max_new_tokens=6)
    eng.step()
    ptrs = [t.data_ptr() for stage in eng._base_group.cache["stages"] for layer in stage
            for t in layer.values()]
    eng.step()
    assert [t.data_ptr() for stage in eng._base_group.cache["stages"] for layer in stage
            for t in layer.values()] == ptrs


def test_accuracy_classes_form_policy_groups():
    _, _, model, params = smoke_pair()
    eng = BatchingEngine(model, params, max_len=12, max_slots=4, page_size=4, policy=FAST)
    r_base = eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
    r_relaxed = eng.submit([6, 7, 8, 9, 10], max_new_tokens=2, accuracy="relaxed")
    results = eng.run()
    assert len(eng._groups) == 2
    assert results[r_base].policy_spec == FAST
    assert results[r_relaxed].policy_spec.startswith(FAST + "@")
    st = eng.stats()
    assert st["weight_cache_nbytes"] == sum(g["weight_cache_nbytes"]
                                            for g in st["groups"].values()) > 0
    with pytest.raises(ValueError, match="accuracy classes require"):
        BatchingEngine(model, params, max_len=12).submit([1], max_new_tokens=1,
                                                         accuracy="relaxed")


def test_sampling_greedy_seeded_and_keyless():
    """Greedy is the argmax; temperature draws are reproducible for an int
    key and differ across keys; without a key they warn and fall back to
    seed 0 (the reference's contract, not its jax.random stream)."""
    from repro_torch.serve import sample_tokens

    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 64)).astype(np.float32))
    np.testing.assert_array_equal(sample_tokens(logits, 0.0, None, 0).numpy(),
                                  logits.argmax(-1).numpy())
    draws = [sample_tokens(logits, 2.0, key, i) for key in (1, 2) for i in range(4)]
    assert torch.equal(draws[0], sample_tokens(logits, 2.0, 1, 0))
    assert draws[0].dtype == torch.int32 and len({tuple(d.tolist()) for d in draws}) > 1
    with pytest.warns(UserWarning, match="no key"):
        keyless = sample_tokens(logits, 2.0, None, 3)
    assert torch.equal(keyless, sample_tokens(logits, 2.0, 0, 3))


def test_serve_engine_temperature_end_to_end():
    _, _, model, params = smoke_pair()
    eng = ServeEngine(model, params, max_len=12)
    batch = {"tokens": torch.tensor([[5, 6, 7], [8, 9, 10]])}
    a = eng.generate(batch, steps=3, temperature=0.8, key=11)
    assert a.shape == (2, 3) and torch.equal(a, eng.generate(batch, steps=3, temperature=0.8,
                                                             key=11))
