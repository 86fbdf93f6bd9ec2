"""repro_torch's training substrates against the JAX reference's on the
CPU: the synthetic data pipeline (bitwise, dense / vlm / encdec, and the
prefetch loader's order), blockwise 8-bit states (round trip bitwise), the
AdamW schedule, global norm and update (f32 and 8-bit moments, each leaf
to 1e-6 of its max|value|: XLA contracts some of the update's products and
sums into FMAs, which torch does not, and an ulp of ``lr * upd`` shows
relative to a parameter that the step nearly cancels), the fault-tolerance
runtime, and the checkpoint manager (round
trip of f32, int, bf16 and Q8 leaves and a module's parameters; retention,
async save, idempotent re-save). And the no-fallback rule: a contraction
past K1's 2^16 raises on the kernel route rather than rerouting."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.runtime import fault as ref_fault
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import gemm
from repro_torch.data import DataConfig, PrefetchingLoader, synth_batch
from repro_torch.models.layers import matmul
from repro_torch.runtime import StragglerWatchdog, elastic_mesh_shape, retry, retry_jitter

DATA_ARCHS = ("qwen2-7b", "internvl2-26b", "seamless-m4t-medium")  # dense, vlm, encdec
RTOL = 1e-6


def assert_leaf_close(got, want, what: str = "") -> None:
    """max|got - want| <= RTOL * max|want| (and equal shapes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= RTOL * np.abs(want).max(initial=0.0), f"{what}: max |diff| {err}"


@pytest.mark.parametrize("arch", DATA_ARCHS)
def test_synth_batch_bitwise(arch):
    kw = dict(seed=3, batch=3, seq_len=40, vocab_size=300, mean_doc_len=9)
    for step in (0, 7):
        want = ref_synth_batch(RefDataConfig(**kw), ref_get_config(arch, "smoke"), step)
        got = synth_batch(DataConfig(**kw), get_config(arch, "smoke"), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_order_and_batches():
    cfg, mcfg = DataConfig(batch=2, seq_len=16, vocab_size=64), get_config("qwen2-7b", "smoke")
    loader = PrefetchingLoader(cfg, mcfg, start_step=5)
    try:
        got = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    assert [s for s, _ in got] == [5, 6, 7]
    for step, batch in got:
        want = ref_synth_batch(RefDataConfig(batch=2, seq_len=16, vocab_size=64),
                               ref_get_config("qwen2-7b", "smoke"), step)
        np.testing.assert_array_equal(batch["tokens"], want["tokens"])


@pytest.mark.parametrize("signed", [True, False])
def test_q8_round_trip_bitwise(signed):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(700) * np.exp(rng.standard_normal(700))).astype(np.float32)
    x[256:512] = 0.0  # an all-zero block: scale 1
    x = np.abs(x) if not signed else x
    x = x.reshape(7, 100)
    jq = ref_optim.quantize(jnp.asarray(x), signed=signed)
    q = optim.quantize(torch.from_numpy(x), signed=signed)
    assert q.shape == jq.shape == (7, 100)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(optim.dequantize(q, signed=signed).numpy(),
                                  np.asarray(ref_optim.dequantize(jq, signed=signed)))


def test_schedule_and_global_norm():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    rcfg = ref_optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        got = float(optim.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_optim.schedule(rcfg, jnp.int32(s)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), s
    rng = np.random.default_rng(2)
    tree = {k: rng.standard_normal(sh).astype(np.float32)
            for k, sh in (("a", (30, 7)), ("b", (5,)), ("c", (2, 3, 4)))}
    got = float(optim.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    want = float(ref_optim.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    assert got == pytest.approx(want, rel=RTOL)


def _port_state(ref_state, eightbit: bool) -> optim.OptState:
    """The reference's optimizer state (one unstacked leaf each) as the port's."""
    def leaf(x):
        if eightbit:
            return optim.Q8(torch.from_numpy(np.array(x.q)), torch.from_numpy(np.array(x.scale)),
                            x.shape)
        return torch.from_numpy(np.array(x))

    return optim.OptState(torch.tensor(int(ref_state.step), dtype=torch.int32),
                          {k: leaf(v) for k, v in ref_state.m.items()},
                          {k: leaf(v) for k, v in ref_state.v.items()})


def _moment(x, signed: bool) -> np.ndarray:
    if isinstance(x, (optim.Q8, ref_optim.Q8)):
        x = (optim.dequantize(x, signed) if isinstance(x, optim.Q8)
             else ref_optim.dequantize(x, signed))
    return np.asarray(x)


@pytest.mark.parametrize("eightbit", [False, True])
def test_adamw_update_as_reference(eightbit):
    """Two updates from zero moments (the second from the first's state,
    carried across): params, m, v (dequantized) and the metrics, each to
    RTOL of its max|value|; the step count equal."""
    rng = np.random.default_rng(3)
    shapes = {"w": (8, 520), "b": (3,), "emb": (40, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    kw = dict(lr=0.05, warmup_steps=1, total_steps=10, grad_clip=0.5, eightbit=eightbit)
    rcfg, cfg = ref_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = ref_optim.init(rcfg, rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = optim.init(cfg, pp)
    for i, g in enumerate(grads):
        rp, rstate, rm = ref_optim.update(rcfg, {k: jnp.asarray(v) for k, v in g.items()},
                                          rstate, rp)
        if i == 0:  # carry the reference's state across, as a resume would
            pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
            pstate = _port_state(rstate, eightbit)
            continue
        pp, pstate, pm = optim.update(cfg, {k: torch.from_numpy(v) for k, v in g.items()},
                                      pstate, pp)
    assert int(pstate.step) == int(rstate.step) == 2
    for k in shapes:
        assert_leaf_close(pp[k].numpy(), rp[k], k)
        for signed, got, want in ((True, pstate.m[k], rstate.m[k]),
                                  (False, pstate.v[k], rstate.v[k])):
            assert_leaf_close(_moment(got, signed), _moment(want, signed), k)
    for k in ("grad_norm", "lr"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=RTOL)


def test_retry_jitter_and_retry_as_reference():
    for e in (RuntimeError("transient"), OSError(5, "io"), ValueError("")):
        for i in range(4):
            assert retry_jitter(e, i) == ref_fault.retry_jitter(e, i)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42

    assert retry(flaky, attempts=4, base_delay=0.001) == 42
    with pytest.raises(ValueError):
        retry(lambda: (_ for _ in ()).throw(ValueError("fatal")), attempts=2,
              base_delay=0.001, retriable=(RuntimeError,))


def test_watchdog_and_elastic_mesh_as_reference():
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 4.0, 0.2]
    ours, ref = StragglerWatchdog(), ref_fault.StragglerWatchdog()
    assert ([ours.observe(i, t) for i, t in enumerate(times)]
            == [ref.observe(i, t) for i, t in enumerate(times)])
    assert (ours.ewma, ours.flagged) == (ref.ewma, ref.flagged) and ours.flagged == 2
    for n, mp in ((8, 2), (256, 16), (6, 3)):
        assert elastic_mesh_shape(n, mp) == ref_fault.elastic_mesh_shape(n, mp)
    with pytest.raises(ValueError):
        elastic_mesh_shape(10, 4)


def _tree(seed: int) -> dict:
    g = torch.Generator()
    g.manual_seed(seed)
    lin = torch.nn.Linear(3, 4)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return {"a": torch.randn((4, 6), generator=g),
            "nested": {"b": torch.randint(0, 5, (3,), generator=g, dtype=torch.int32)},
            "step": torch.tensor(7 + seed, dtype=torch.int32),
            "bf": torch.randn((5, 2), generator=g).to(torch.bfloat16),
            "q8": optim.quantize(torch.randn((300,), generator=g)),
            "module": lin}


def _leaves(tree: dict) -> list:
    q8 = tree["q8"]
    return [tree["a"], tree["nested"]["b"], tree["step"], tree["bf"], q8.q, q8.scale,
            *tree["module"].parameters()]


def _assert_tree_equal(got: dict, want: dict) -> None:
    for x, y in zip(_leaves(got), _leaves(want), strict=True):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_checkpoint_round_trip_bf16_q8_and_module(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(5, _tree(0))
    target = _tree(1)
    step, restored = mgr.restore(target)
    assert step == 5 and restored is target
    _assert_tree_equal(restored, _tree(0))
    manifest = json.loads((tmp_path / "step_0000000005" / "manifest.json").read_text())
    assert manifest["format"] == 1
    dtypes = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    assert dtypes["['bf']"] == "bfloat16" and dtypes["['q8'].q"] == "int8"
    assert dtypes["['module'].weight"] == "float32"


def test_checkpoint_retention_and_restore_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    step, restored = mgr.restore(_tree(0), step=3)
    assert step == 3
    _assert_tree_equal(restored, _tree(3))
    with pytest.raises(ValueError, match="leaf count"):
        mgr.restore({"a": torch.zeros(4, 6)})


def test_checkpoint_async_save_copies_now_and_idempotent_resave(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree(2)
    mgr.save(9, t)
    t["a"].add_(1.0)  # an in-place step right after the save does not leak into it
    mgr.wait()
    _, restored = mgr.restore(_tree(0))
    _assert_tree_equal(restored, _tree(2))
    mgr.save(9, _tree(3))  # the same step again: kept as first written
    mgr.wait()
    assert mgr.all_steps() == [9]
    _assert_tree_equal(mgr.restore(_tree(0))[1], _tree(2))


def test_contraction_past_max_k_raises_on_the_kernel_route(monkeypatch):
    """An lm_head past 2^16 vocabulary rows: its input gradient contracts
    over the vocabulary, and K1 refuses it rather than rerouting."""
    monkeypatch.setattr(gemm, "_resolve_backend", lambda pol, dev: "pallas")
    core_calls = []
    monkeypatch.setattr(gemm, "ozmm_ozaki2", lambda *a, **k: core_calls.append(1))
    k = 2 ** 16 + 128
    g = torch.ones((2, k), dtype=torch.float64)
    w_t = torch.ones((k, 3), dtype=torch.float64)  # lm_head^T: dA = dlogits @ W^T
    with pytest.raises(ValueError, match=f"k = {k} exceeds 65536"):
        matmul(g, w_t, "ozaki2-fp8/fast")
    assert core_calls == []
