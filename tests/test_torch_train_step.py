"""repro_torch's train step and Trainer on the CPU: one ``make_train_step``
step with two microbatches from a reference TrainState carried across by
``train_state_from_reference``, against the reference's jitted step on the
same state and batch (the metrics to rtol 1e-6; per leaf, normwise, the
params to 1e-6 and m and v to 1e-5: the moments carry the gradient's own
deviation, ~1e-6 from the f32 islands, tests/test_torch_train_model.py); the carrying of 8-bit moments; the Trainer's checkpoint resume
(4 steps straight == 2 steps, a restore, 2 more: losses and parameters
bitwise); and the remat modes ("full" and "dots" give "none"'s loss and
gradients bitwise, and "dots" replays the forward's emulated products).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as ref_optim
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.train import TrainState as RefTrainState
from repro.train import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import gemm
from repro_torch.data import DataConfig
from repro_torch.models import Model
from repro_torch.models.convert import (reference_path, reference_leaves,
                                        train_state_from_reference)
from repro_torch.train import Trainer, TrainerConfig, loss_fn, make_train_step

from _torch_families_parity import family_pair
from _torch_models_parity import one_torch_thread  # noqa: F401

RTOL = 1e-6
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=20, grad_clip=1.0)


def assert_normwise(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= tol, f"{what}: normwise {err}"


def _ref_leaf(tree, name: str):
    path, layer = reference_path(name)
    for k in path:
        tree = tree[k]
    return tree, layer


def test_train_step_two_microbatches_as_reference():
    """The reference takes a first step from zero moments; its state is
    carried across, and both take the second step (two microbatches of 2)."""
    ref_model, ref_params, model, _ = family_pair("moonshot-v1-16b-a3b")  # MoE: the aux loss
    data = RefDataConfig(seed=9, batch=4, seq_len=8, vocab_size=512, mean_doc_len=5)
    batches = [ref_synth_batch(data, ref_model.cfg, s) for s in (0, 1)]
    rcfg = ref_optim.AdamWConfig(**OPT)
    _, ref_step = ref_make_train_step(ref_model, rcfg, microbatches=2)
    ref_step = jax.jit(ref_step)
    state = RefTrainState(ref_params, ref_optim.init(rcfg, ref_params))
    for i, batch in enumerate(batches):
        state, ref_metrics = ref_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        if i == 0:
            carried = train_state_from_reference(model, jax.tree.map(np.asarray, state))
    _, step = make_train_step(model, optim.AdamWConfig(**OPT), microbatches=2)
    new, metrics = step(carried, batches[1])
    assert int(new.opt.step) == int(state.opt.step) == 2
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=RTOL, abs=1e-9), k
    leaves = reference_leaves(new.params)
    assert list(new.opt.m) == list(leaves)
    for name, p in leaves.items():
        for got, tree, tol in ((p, state.params, RTOL), (new.opt.m[name], state.opt.m, 1e-5),
                               (new.opt.v[name], state.opt.v, 1e-5)):
            want, layer = _ref_leaf(tree, name)
            want = np.asarray(want)
            assert_normwise(got.detach().numpy(), want if layer is None else want[layer], tol,
                            name)


def test_q8_moments_carried_from_reference():
    """8-bit moments: a layer's reference blocks where they hold that layer
    alone (bitwise), else its dequantized values quantized again (within
    half a quantization step of the reference's value)."""
    ref_model, ref_params, model, _ = family_pair("qwen2-7b")
    rng = np.random.default_rng(4)

    def q8(p, signed):
        """The reference's Q8 of a random moment (built by the port's
        quantize, which test_torch_train_optim_data holds bitwise to the
        reference's: its eager JAX ops compile per leaf shape)."""
        x = rng.standard_normal(p.shape).astype(np.float32)
        q = optim.quantize(torch.from_numpy(x if signed else np.abs(x)), signed=signed)
        return ref_optim.Q8(q.q.numpy(), q.scale.numpy(), q.shape)

    def ref_values(rq, signed):
        return optim.dequantize(optim.Q8(torch.from_numpy(rq.q), torch.from_numpy(rq.scale),
                                         rq.shape), signed).numpy()

    opt = ref_optim.OptState(np.int32(3), jax.tree.map(lambda p: q8(p, True), ref_params),
                             jax.tree.map(lambda p: q8(p, False), ref_params))
    carried = train_state_from_reference(
        model, RefTrainState(jax.tree.map(np.asarray, ref_params), opt))
    assert int(carried.opt.step) == 3
    kinds = set()
    for name, p in reference_leaves(carried.params).items():
        for signed, mom, tree in ((True, carried.opt.m, opt.m), (False, carried.opt.v, opt.v)):
            got = mom[name]
            assert isinstance(got, optim.Q8) and got.shape == tuple(p.shape)
            rq, layer = _ref_leaf(tree, name)
            want = ref_values(rq, signed)
            want = want if layer is None else want[layer]
            deq = optim.dequantize(got, signed).numpy()
            if layer is None or p.numel() % optim.BLOCK == 0:
                kinds.add("blocks")
                np.testing.assert_array_equal(deq, want, err_msg=name)
            else:
                kinds.add("requantized")
                step = np.abs(want).max() / (127 if signed else 255)
                assert np.abs(deq - want).max() <= 0.5 * step * (1 + 1e-6), name
    assert kinds == {"blocks", "requantized"}


def _trainer(tmp_path, name: str, steps: int) -> Trainer:
    cfg = get_config("qwen2-7b", "smoke")
    tcfg = TrainerConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / name),
                         microbatches=2, seed=3)
    return Trainer(Model(cfg, device="cpu"), optim.AdamWConfig(**OPT),
                   DataConfig(batch=4, seq_len=8, vocab_size=cfg.vocab_size), tcfg)


def test_trainer_resume_bitwise(tmp_path):
    straight, sink = _trainer(tmp_path, "straight", 4), []
    want = straight.run(sink)
    first, sink2 = _trainer(tmp_path, "resumed", 2), []
    first.run(sink2)
    assert first.ckpt.all_steps() == [2]
    resumed = _trainer(tmp_path, "resumed", 4)
    assert resumed.init_or_restore()[0] == 2
    got = resumed.run(sink2)
    assert [m["step"] for m in sink2] == [m["step"] for m in sink] == [0, 1, 2, 3]
    assert [m["loss"] for m in sink2] == [m["loss"] for m in sink]
    assert all(torch.equal(a, b) for a, b in zip(got.params.parameters(),
                                                 want.params.parameters()))
    for k in ("m", "v"):
        assert all(torch.equal(getattr(got.opt, k)[n], getattr(want.opt, k)[n])
                   for n in getattr(want.opt, k))
    assert resumed.ckpt.all_steps() == [2, 4]


def _loss_and_grads(model, params, batch):
    leaves = reference_leaves(params)
    loss, _ = loss_fn(model, params, batch)
    return loss, torch.autograd.grad(loss, list(leaves.values()))


@pytest.mark.parametrize("arch,spec", [("zamba2-1.2b", None), ("qwen2-7b", "ozaki2-fp8/fast")])
def test_remat_modes_same_values(arch, spec, monkeypatch):
    """zamba2 (a shared block woven into a stage) on native, qwen2 on the
    emulated core: "full" and "dots" give "none"'s loss and gradients
    bitwise; counting the core's products, "full" runs each layer's GEMMs
    again but its last (w_down: the recompute stops at the last tensor the
    layer's backward reads, and the core route's VJP keeps its plans on its
    node), "dots" none."""
    cfg = get_config(arch, "smoke", gemm=spec)
    model = Model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    params = model.init(gen).requires_grad_(True)
    batch = ref_synth_batch(RefDataConfig(batch=2, seq_len=8, vocab_size=512), cfg, 0)
    products = []
    real = gemm.ozmm_prepared
    monkeypatch.setattr(gemm, "ozmm_prepared", lambda *a: products.append(1) or real(*a))
    runs = {}
    for remat in ("none", "full", "dots"):
        products.clear()
        model.cfg = dataclasses.replace(cfg, remat=remat)
        runs[remat] = (*_loss_and_grads(model, params, batch), len(products))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], runs["none"][1])), remat
    if spec is not None:  # forward F products + backward 2F; "full" recomputes the layers'
        gemms = 7  # wq, wk, wv, wo, w_gate, w_up, w_down
        assert runs["none"][2] == 3 * (cfg.num_layers * gemms + 1)
        assert (runs["full"][2], runs["dots"][2]) == (
            runs["none"][2] + cfg.num_layers * (gemms - 1), runs["none"][2])
