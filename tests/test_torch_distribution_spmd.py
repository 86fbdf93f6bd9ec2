"""repro_torch.distribution's sharded training step, pipeline, cost counter
and the dry run on the CPU, on single-controller meshes of the CPU (or of
``meta``):

* the sharded step, tensor-parallel over "model" (qwen2-7b smoke at
  d_model 128, 4 heads, a batch of 8 x 32: tests/distribution/
  test_sharded_train.py's config): under ozaki2-fp8/fast, where the split
  GEMMs are exact, on a (1, 4) mesh bitwise equal to the port's
  single-device step (tests/test_torch_train_step.py holds that against the
  reference), and on (2, 4) bitwise equal to the same function run on one
  device (each data rank's gradient, summed in rank order and divided, then
  AdamW), 8-bit moments too (and native on (2, 1), where "model" splits
  no GEMM); under the native policy, whose row-parallel partials are
  summed in f32 (GSPMD's all-reduce), the (1, 4) and (2, 4) states held
  to the single-device step's, and (2, 4) to (1, 4)'s (the whole batch
  through the same program), by one rule for every leaf (``assert_near``):
  the loss within the reference test's 1e-4, the moments within the AdamW
  tolerance of tests/test_torch_train_step.py (normwise 1e-5), the params
  within its 1e-6 normwise where AdamW's first step is well conditioned
  (|g| >= 100 eps), and elsewhere the gradient equal to rounding and the
  params apart by what the step makes of it (the key bias' low-frequency
  RoPE columns, whose gradient is ~1e-9); one torch thread, so the CPU's
  accumulating backward ops run in one order;
* ``CheckpointManager.restore(shardings=)``: a state saved from (2, 2)
  restored onto (4, 1) and onto no mesh, bit for bit;
* ``pipeline_apply`` on examples/check_pipeline.py's shapes and weights
  (S 4, M 6, mb 8, D 32): bitwise equal to the sequential stack, and within
  1e-6 of the reference's sequential stack (the reference's
  ``pipeline_apply`` needs 4 devices, so a subprocess; its example shows
  it equal to that stack);
* ``op_cost.analyze`` on tests/distribution/test_hlo_cost.py's workload
  (L 7, B 32, D 256, F 512) as rank 0's tensor-parallel program
  (``models.layers.matmul`` on the split leaves) on an (8, 1) and a (2, 4)
  mesh: the reference test's own numbers, 2 * 2 * B * D * F * L / 8 dot
  FLOPs a rank and on (2, 4) an all-reduce of (B / 2) * D * 4 * L bytes
  (none on (8, 1), where "model" splits nothing), no all-gather, the same
  counts on ``meta`` as on the CPU;
* ``dryrun_cell``: smoke-config train, prefill and decode cells on a
  (2, 2) mesh of ``meta``: status ok, the reference's keys, FLOPs equal to
  the tensor-parallel ``model_flops``.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import collectives
from repro_torch.core.collectives import reduce_ranks
from repro_torch.data import DataConfig, synth_batch
from repro_torch.distribution import named, param_specs
from repro_torch.distribution.op_cost import analyze, collective_bytes, flops_and_bytes
from repro_torch.distribution.pipeline import pipeline_apply
from repro_torch.distribution.sharding import NamedSharding, P, Placed, place
from repro_torch.distribution.spmd import make_sharded_train_step, sharded_programs
from repro_torch.launch import make_host_mesh, make_mesh
from repro_torch.launch.dryrun import dryrun_cell, model_flops
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.models.layers import blockwise, matmul
from repro_torch.models.tensor_parallel import ModelSplit
from repro_torch.optim import AdamWConfig, update
from repro_torch.train import make_train_step
from repro_torch.train.step import batch_grads

from _torch_models_parity import one_torch_thread  # noqa: F401

OPT = AdamWConfig(lr=1e-3)
LOSS_TOL, PARAM_TOL, MOMENT_TOL = 1e-4, 1e-6, 1e-5


FAST = "ozaki2-fp8/fast"


def make_setup(gemm: str, opt=OPT):
    """(model, fresh state maker, batch, the single-device step's state and
    metrics) of the reference test's config under ``gemm``."""
    cfg = dataclasses.replace(get_config("qwen2-7b", "smoke"), num_heads=4, num_kv_heads=4,
                              d_model=128, gemm=gemm)
    model = Model(cfg, device="cpu")
    init, step = make_train_step(model, opt)
    batch = synth_batch(DataConfig(batch=8, seq_len=32, vocab_size=cfg.vocab_size), cfg, 0)

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init(gen)

    single, metrics = step(fresh(), batch)
    return model, fresh, batch, single, metrics


@pytest.fixture(scope="module")
def setup(one_torch_thread):  # noqa: F811
    return make_setup("native")


@pytest.fixture(scope="module")
def setup_fast(one_torch_thread):  # noqa: F811
    return make_setup(FAST)


def leaves_of(state) -> list:
    """(name, what, tensor) over params and moments, the reference's order."""
    out = []
    for k, p in reference_leaves(state.params).items():
        out += [(k, "param", p.detach()), (k, "m", state.opt.m[k]), (k, "v", state.opt.v[k])]
    return out


def sharded_run(setup, shape):
    model, fresh, batch, _, _ = setup
    mesh = make_host_mesh(*shape, devices="cpu")
    shard_state, step, unshard_state = make_sharded_train_step(model, OPT, mesh)
    sharded, metrics = step(shard_state(fresh()), batch)
    return mesh, sharded, metrics, unshard_state


def test_sharded_step_one_data_rank_bitwise(setup_fast):
    """Under ozaki2-fp8/fast every split GEMM is exact: (1, 4) gives the
    single-device step's bits."""
    _, _, _, single, want = setup_fast
    _, sharded, metrics, unshard_state = sharded_run(setup_fast, (1, 4))
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in want.items()}
    got = unshard_state(sharded)
    assert torch.equal(got.opt.step, single.opt.step)
    for (k, what, g), (_, _, w) in zip(leaves_of(got), leaves_of(single)):
        assert torch.equal(g, w), (k, what)
    # each rank holds its block of the "model"-split leaves, not the leaf
    wq = sharded.params["stages.0.0.attn.wq"]
    assert tuple(wq.sharding.spec) == ("data", "model")
    assert [b.shape[1] for b in wq.blocks] == [32] * 4


#: AdamW's first step moves a param by lr * g / (|g| + eps) (m-hat = g,
#: sqrt(v-hat) = |g|): its response to a relative error d of g is
#: d * eps / (|g| + eps), at most d / 100 where |g| >= WELL * eps
WELL = 100
#: below that, a gradient element is held to the rounding of the leaf's
#: sums: within NOISE f32 units (2^-24) of the leaf's largest |g|
NOISE = 32


def first_step_gradient(state, k: str) -> torch.Tensor:
    """Leaf k's clipped gradient of a state one step from zero moments."""
    return state.opt.m[k].double() / (1 - OPT.b1)


def assert_near(metrics, want, got, ref, lr: float) -> None:
    """Two states one AdamW step from the same state: the loss within the
    reference's bound, and per leaf (the same rule for every leaf) the
    moments within MOMENT_TOL normwise; the params within PARAM_TOL
    normwise where AdamW's first step is well conditioned (|g| >= WELL *
    eps in both); elsewhere the gradients equal to rounding (NOISE) and the
    params apart by no more than AdamW's step makes of that. The key bias'
    low-frequency RoPE columns land there: one vector added to every key
    shifts each score by about the same amount, which softmax ignores, so
    their gradient is ~1e-9 against the leaf's ~1e-3."""
    assert abs(float(metrics["loss"]) - float(want["loss"])) < LOSS_TOL
    for (k, what, g), (_, _, w) in zip(leaves_of(got), leaves_of(ref)):
        g, w = g.double(), w.double()
        if what != "param":
            err = float(torch.linalg.norm(g - w) / max(float(torch.linalg.norm(w)), 1e-300))
            assert err <= MOMENT_TOL, (k, what, err)
            continue
        ga, gw = first_step_gradient(got, k), first_step_gradient(ref, k)
        well = (ga.abs() >= WELL * OPT.eps) & (gw.abs() >= WELL * OPT.eps)
        err = float(torch.linalg.norm((g - w)[well])
                    / max(float(torch.linalg.norm(w[well])), 1e-300))
        assert err <= PARAM_TOL, (k, what, err)
        ill = ~well
        noise = NOISE * 2.0 ** -24 * float(gw.abs().max())
        assert bool(((ga - gw)[ill].abs() <= noise).all()), (k, "gradient")
        step = lambda x: x / (x.abs() + OPT.eps)  # noqa: E731
        # what the step makes of the gradients, and the f32 rounding of p - lr * update
        moved = (lr * (step(ga) - step(gw))[ill].abs() * (1 + 2.0 ** -10)
                 + 2.0 ** -22 * w[ill].abs() + lr * 2.0 ** -20)
        assert bool(((g - w)[ill].abs() <= moved).all()), (k, "param")


def test_sharded_step_one_data_rank_native_near_single(setup):
    """The native policy sums the row-parallel partials in f32 (GSPMD's
    all-reduce): (1, 4) within the reference's bounds."""
    _, _, _, single, want = setup
    _, sharded, metrics, unshard_state = sharded_run(setup, (1, 4))
    assert_near(metrics, want, unshard_state(sharded), single, float(metrics["lr"]))


def dp_oracle_step(model, state, batch, n_data: int, opt=OPT) -> float:
    """The sharded step's function from the single-device pieces: each data
    rank's gradient (``batch_grads`` on its rows), summed in rank order and
    divided, then ``optim.update`` on whole leaves. Returns the loss."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    leaves = reference_leaves(state.params)
    rows = batch["tokens"].shape[0] // n_data
    grads, losses = [], []
    for d in range(n_data):
        g, m = batch_grads(model, state.params, leaves,
                           {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
        grads.append(g)
        losses.append(m["loss"])
    mean = {k: reduce_ranks([g[k] for g in grads], torch.add, "cpu").div_(n_data)
            for k in leaves}
    update(opt, mean, state.opt, leaves)
    return float(reduce_ranks(losses, torch.add, "cpu") / n_data)


def test_sharded_step_two_data_ranks_near_single(setup, setup_fast):
    """Native (2, 4): within the reference's loss bound and ``assert_near``'s
    per-leaf rule of the single-device step, and of the whole batch through
    the same program ((1, 4)). ozaki2-fp8/fast (2, 4): bitwise equal to the
    one-device oracle (the native row-parallel sums are not the single
    device's)."""
    _, _, _, single, want = setup
    _, sharded, metrics, unshard_state = sharded_run(setup, (2, 4))
    got = unshard_state(sharded)
    lr = float(metrics["lr"])
    assert_near(metrics, want, got, single, lr)
    _, whole, whole_metrics, _ = sharded_run(setup, (1, 4))
    assert_near(metrics, whole_metrics, got, unshard_state(whole), lr)
    model, fresh, batch, _, _ = setup_fast
    _, sharded, metrics, unshard_state = sharded_run(setup_fast, (2, 4))
    got = unshard_state(sharded)
    oracle = fresh()
    assert dp_oracle_step(model, oracle, batch, 2) == float(metrics["loss"])
    for (k, what, g), (_, _, w) in zip(leaves_of(got), leaves_of(oracle)):
        assert torch.equal(g, w), (k, what)


@pytest.mark.parametrize("policy,shape", [("native", (2, 1)), (FAST, (2, 2))],
                         ids=["native-2x1", "fast-2x2"])
def test_sharded_step_eightbit_moments_as_the_oracle(policy, shape, setup, setup_fast):
    """Q8 moments (replicated, blocked over the flattened leaf) are updated
    on the gathered leaf: a step bitwise equal to the one-device oracle's,
    blocks and replicas alike. Native on (2, 1), where "model" splits no
    GEMM; ozaki2-fp8/fast on (2, 2), tensor-parallel (a native step sums
    its row-parallel partials in f32 and is not the oracle's)."""
    model, _, batch, _, _ = setup if policy == "native" else setup_fast
    opt8 = dataclasses.replace(OPT, eightbit=True)
    init, _ = make_train_step(model, opt8)

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init(gen)

    mesh = make_host_mesh(*shape, devices="cpu")
    shard_state, step, unshard_state = make_sharded_train_step(model, opt8, mesh)
    sharded, metrics = step(shard_state(fresh()), batch)
    got = unshard_state(sharded)
    oracle = fresh()
    assert dp_oracle_step(model, oracle, batch, 2, opt8) == float(metrics["loss"])
    params = reference_leaves(got.params)
    for k, p in reference_leaves(oracle.params).items():
        assert torch.equal(params[k], p), k
        for tree, want in ((sharded.opt.m, oracle.opt.m), (sharded.opt.v, oracle.opt.v)):
            for blocks, w in ((tree[k].q.blocks, want[k].q), (tree[k].scale.blocks, want[k].scale)):
                assert all(torch.equal(b, w) for b in blocks), k


def test_restore_onto_another_mesh_and_onto_none(setup):
    model, fresh, _, _, _ = setup
    _, sharded, _, unshard_state = sharded_run(setup, (2, 2))
    want = unshard_state(sharded)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(1, sharded)
        mesh = make_host_mesh(4, 1, devices="cpu")
        step, placed = mgr.restore(sharded, shardings=named(mesh, param_specs(want)))
        assert step == 1
        assert all(isinstance(v, Placed) and v.sharding.mesh is mesh
                   for v in placed.params.values())
        _, _, unshard41 = make_sharded_train_step(model, OPT, mesh)
        for (k, what, g), (_, _, w) in zip(leaves_of(unshard41(placed)), leaves_of(want)):
            assert torch.equal(g, w), (k, what)
        target = fresh()
        _, back = mgr.restore(target)  # no mesh: the leaves in place
        assert back is target
        for (k, what, g), (_, _, w) in zip(leaves_of(back), leaves_of(want)):
            assert torch.equal(g, w), (k, what)


def test_pipeline_bitwise_to_the_sequential_stack():
    s, m, mb, d = 4, 6, 8, 32
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    mesh = make_mesh((s,), ("stage",), devices="cpu")

    def stage(w, h):
        return torch.tanh(h @ w)

    with analyze_counts() as c:
        out = pipeline_apply(stage, torch.from_numpy(ws), torch.from_numpy(x), mesh)
    assert c.coll_counts == {"collective-permute": (s - 1) * m}
    seq = torch.from_numpy(x)
    for i in range(s):
        seq = torch.tanh(seq @ torch.from_numpy(ws[i]))
    assert torch.equal(out, seq)
    ref = jnp.asarray(x)
    for i in range(s):  # the reference's sequential stack (examples/check_pipeline.py)
        ref = jnp.tanh(ref @ jnp.asarray(ws[i]))
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < 1e-6


def analyze_counts():
    from repro_torch.distribution.op_cost import CostCounter
    return CostCounter()


L, B, D, F = 7, 32, 256, 512


def cost_workload(mesh, device):
    """The reference test's scan of tanh(x @ wa) @ wb over L layers, as
    rank 0's tensor-parallel program: weights split over "model" (column-
    then row-parallel, ``models.layers.matmul``), the batch over "data"."""
    gen = torch.Generator()
    gen.manual_seed(1)

    def make(*shape):
        t = torch.randn(shape, generator=gen, dtype=torch.float32)
        return t.to(device) if device != "meta" else torch.empty(shape, device="meta")

    params = {"ws": place(make(L, D, F), NamedSharding(mesh, P(None, None, "model"))),
              "w2": place(make(L, F, D), NamedSharding(mesh, P(None, "model", None)))}
    batch = {"x": make(B, D)}
    split = frozenset(params) if mesh.axis_size("model") > 1 else frozenset()

    def layer(w, i):
        if isinstance(w, ModelSplit):
            return ModelSplit([b[i] for b in w.blocks], w.dim - 1, w.shape[1:], w.axis)
        return w[i]

    def fn(leaves, block):
        x = block["x"]
        for i in range(L):
            h = blockwise(torch.tanh, matmul(x, layer(leaves["ws"], i), "native"))
            x = matmul(h, layer(leaves["w2"], i), "native")
        return x

    return analyze(lambda: [fn(leaves, block) for _, _, leaves, block in
                            sharded_programs(mesh, params, batch, ranks=[0], split=split)])


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_op_cost_counts_rank_zero(shape):
    costs = {}
    for device in ("cpu", "meta"):
        mesh = make_host_mesh(*shape, devices=device)
        cost = cost_workload(mesh, device)
        out = cost.pop("result")
        assert len(out) == 1 and tuple(out[0].shape) == (B // shape[0], D)
        assert out[0].device.type == device
        costs[device] = cost
    cost = costs["cpu"]
    assert costs["meta"] == cost
    assert cost["dot_flops"] == 2 * 2 * B * D * F * L / 8  # the reference test's formula
    # the reference's per-layer psum of the (B/2, D) f32 partials over "model"
    reduced = (B // shape[0]) * D * 4 * L if shape[1] > 1 else 0
    assert cost["collective_bytes"].get("all-reduce", 0) == reduced
    assert "all-gather" not in cost["collective_bytes"]
    assert cost["collective_total"] == reduced
    flops, byts = flops_and_bytes(cost)
    assert flops == cost["dot_flops"] and byts == cost["bytes_written"] > 0
    assert collective_bytes(cost)["total_bytes"] == reduced


def test_collectives_record_and_hide_their_ops():
    """A psum's adds belong to the collective: counted as its bytes, not as
    the program's ops."""
    parts = [torch.ones(4, 8) * i for i in range(3)]
    cost = analyze(collectives.reduce_ranks, parts, torch.add, "cpu")
    assert torch.equal(cost["result"], torch.full((4, 8), 3.0))
    assert cost["ops"] == 0 and cost["collective_bytes"] == {"all-reduce": 4 * 8 * 4}


REF_KEYS = {"status", "arch", "shape", "mesh", "gemm_backend", "num_devices", "entry_flops",
            "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "collective_total_per_device", "memory", "model_params", "model_active_params"}


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_cell_smoke_on_meta(shape_name):
    mesh = make_host_mesh(2, 2, devices="meta")
    rec = dryrun_cell("qwen2-7b", shape_name, False, variant="smoke", mesh=mesh)
    assert rec["status"] == "ok", rec
    assert set(rec) == REF_KEYS | {"trace_s", "clip_norm_gather_bytes_per_device",
                                   "clip_norm_largest_gather_bytes"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    shape = SHAPES[shape_name]
    want = model_flops(get_config("qwen2-7b", "smoke"), shape.kind, shape.global_batch // 2,
                       shape.seq_len, shape.seq_len + 8, model=2)
    assert rec["flops_per_device"] == want
    assert rec["mesh"] == "2x2" and rec["num_devices"] == 4
    assert rec["collective_bytes_per_device"]["all-gather"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
