"""repro_torch.models.tensor_parallel on the CPU: GSPMD's split of
each GEMM over "model" for the dense family, against the reference and the
port's single-device functions.

* (a) ``op_cost.analyze`` on tests/distribution/test_hlo_cost.py's workload
  (L 7, B 32, D 256, F 512) on a (2, 4) mesh, on ``cpu`` and ``meta``,
  written as rank 0's program with an explicit psum over "model": the
  reference test's numbers, 2 * 2 * B * D * F * L / 8 dot FLOPs
  (14,680,064) and an all-reduce of (B / 2) * D * 4 * L bytes (114,688),
  no all-gather;
* (b) the column- and row-parallel products and both cotangents under
  ozaki2-fp8/fast, on the core route and on the kernel route's plain
  versions (``core.gemm._resolve_backend`` forced to "pallas", as
  tests/test_torch_autograd_routes.py forces it), bitwise equal to the
  single-device ``models.layers.matmul`` and its gradients: at four head
  blocks of 32 columns on 4 ranks (head-local) and at three heads on 4
  ranks, 24 columns a rank (the gather path: the blocks all-gathered, the
  row-parallel input scattered from a whole activation);
* (c) the sharded step, tensor-parallel, under ozaki2-fp8/fast on a
  config whose attention takes the gather path on 4 model ranks (qwen2-7b
  smoke, 1 layer, 8 query and 2 kv heads of 64; every bias block a
  multiple of 32 columns: torch's CPU sum over a block 16 or 48 columns
  wide adds in another order than over the whole) and on gemma2-27b smoke
  (2 layers, a local and a global one; tied embeddings, softcaps,
  post-norms) on 2, a batch of 4 x 32: on (1, m)
  bitwise equal to the single-device step, on (2, m) bitwise equal to
  ``dp_oracle_step`` (tests/test_torch_distribution_spmd.py);
* (d) the native (2, 4) step from a reference TrainState carried across by
  ``train_state_from_reference`` (tests/distribution/test_sharded_train.py's
  config): its loss within that test's 1e-4 of the reference's jitted
  single-device step on the same state and batch, and every leaf's params
  and moments within tests/test_torch_train_step.py's AdamW tolerances
  (normwise: params 1e-6, moments 1e-5);
* (e) ``dryrun_cell`` for qwen2-7b and gemma2-27b smoke train, prefill and
  decode on a (2, 2) ``meta`` mesh: status ok, FLOPs a rank equal to the
  tensor-parallel ``model_flops``, and every leaf the rules split over
  "model" handed to the program as its model rank's block, never
  all-gathered over "model"; the clipping norm's gathers reported on their
  own, each split leaf's whole gradient once; train under remat "full"
  too, its FLOPs ``model_flops``';
* (g) remat "full" on (1, 2): each layer's o projection recomputed, its
  MLP down projection not (a row-parallel product packs its operands
  before it runs), counted as split contractions; the step bitwise;
* (f) prefill and two greedy decode steps of qwen2-7b smoke under
  ozaki2-fp8/fast, tensor-parallel on (1, 2) (head-local, a kv head a
  rank's cache block) and on (1, 4) (the gather path: the cache's blocks
  gathered, written, written back): every step's logits bitwise equal to
  the single-device model's.
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
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import gemm
from repro_torch.core.collectives import psum
from repro_torch.data import DataConfig, synth_batch
from repro_torch.distribution import param_specs
from repro_torch.distribution.op_cost import analyze
from repro_torch.distribution.sharding import NamedSharding, P, model_split, place
from repro_torch.distribution.spmd import (bind, make_sharded_train_step, rank_leaf,
                                           sharded_programs)
from repro_torch.launch import make_host_mesh
from repro_torch.launch.dryrun import BIG_ARCHS, dryrun_cell, model_flops
from repro_torch.models import Model
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.convert import reference_leaves, reference_path, train_state_from_reference
from repro_torch.models.layers import matmul
from repro_torch.models.tensor_parallel import (ModelAxis, ModelSplit, block_sizes,
                                                column_parallel, gather, row_parallel, scatter,
                                                split_cache)
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step

from _torch_families_parity import family_pair
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_distribution_spmd import dp_oracle_step

FAST = "ozaki2-fp8/fast"
LOSS_TOL, PARAM_TOL, MOMENT_TOL = 1e-4, 1e-6, 1e-5


# ------------------------------------------------------------------ (a)
L, B, D, F = 7, 32, 256, 512


def rank_program_cost(device: str) -> dict:
    """The reference test's scan of tanh(x @ wa) @ wb, as rank 0's program
    on (2, 4): its blocks of ws (columns over "model") and w2 (rows over
    "model"), its rows of x, a psum over "model" a layer."""
    mesh = make_host_mesh(2, 4, devices=device)
    gen = torch.Generator()
    gen.manual_seed(1)

    def make(*shape):
        t = torch.randn(shape, generator=gen, dtype=torch.float32)
        return t if device == "cpu" else torch.empty(shape, device="meta")

    params = {"ws": place(make(L, D, F), NamedSharding(mesh, P(None, None, "model"))),
              "w2": place(make(L, F, D), NamedSharding(mesh, P(None, "model", None)))}
    batch = {"x": make(B, D)}

    def program():
        outs = []
        for _, axis, leaves, block in sharded_programs(mesh, params, batch, ranks=[0],
                                                       split=frozenset(params)):
            x = block["x"]
            for i in range(L):
                x = psum([torch.tanh(x @ ws[i]) @ w2[i]
                          for ws, w2 in zip(leaves["ws"].blocks, leaves["w2"].blocks)],
                         axis.device, axis.size)
            outs.append(x)
        return outs

    return analyze(program)


def test_rank_program_cost_is_the_reference_tests():
    costs = {d: rank_program_cost(d) for d in ("cpu", "meta")}
    for d, cost in costs.items():
        (out,) = cost.pop("result")
        assert tuple(out.shape) == (B // 2, D) and out.device.type == d
    assert costs["cpu"] == costs["meta"]
    cost = costs["cpu"]
    assert cost["dot_flops"] == 2 * 2 * B * D * F * L / 8 == 14_680_064
    assert cost["collective_bytes"] == {"all-reduce": B // 2 * D * 4 * L}
    assert cost["collective_bytes"]["all-reduce"] == 114_688
    assert cost["collective_counts"] == {"all-reduce": L}


# ------------------------------------------------------------------ (b)
ROWS, D_MODEL, HD = 64, 128, 32
CASES = {"head-local": 4 * HD, "gather": 3 * HD}  # columns on 4 model ranks


@pytest.fixture(params=["core", "kernel"])
def route(request, monkeypatch):
    if request.param == "kernel":  # the kernel route's plain versions on the CPU
        monkeypatch.setattr(gemm, "_resolve_backend", lambda pol, dev: "pallas")
    return request.param


def leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def split_leaf(w: torch.Tensor, dim: int, axis: ModelAxis) -> ModelSplit:
    sizes = block_sizes(w.shape[dim], axis.size)
    return ModelSplit([leaf(b) for b in torch.split(w, sizes, dim)], dim, w.shape, axis)


@pytest.mark.parametrize("case", list(CASES))
def test_products_and_cotangents_bitwise(route, case):
    cols = CASES[case]
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, w, gy = t(ROWS, D_MODEL), t(D_MODEL, cols) * 0.1, t(ROWS, cols)
    h, w2, gz = t(ROWS, cols), t(cols, D_MODEL) * 0.1, t(ROWS, D_MODEL)
    axis = ModelAxis(4, (0, 1, 2, 3), (torch.device("cpu"),) * 4)
    sizes = block_sizes(cols, 4)

    # column-parallel: the ranks' column blocks, all-gathered
    xs, ws = leaf(x), split_leaf(w, 1, axis)
    y = gather(column_parallel(xs, ws, FAST), axis, sizes)
    (y * gy).sum().backward()
    x1, w1 = leaf(x), leaf(w)
    y1 = matmul(x1, w1, FAST)
    (y1 * gy).sum().backward()
    assert torch.equal(y, y1)
    assert torch.equal(xs.grad, x1.grad)  # a contraction split over "model"
    assert torch.equal(torch.cat([b.grad for b in ws.blocks], 1), w1.grad)

    # row-parallel: the ranks' column blocks of a whole activation (the
    # gather path's attention output) @ their row blocks, summed
    hs, w2s = leaf(h), split_leaf(w2, 0, axis)
    z = row_parallel(scatter(hs, axis, sizes), w2s, FAST)
    (z * gz).sum().backward()
    h1, w21 = leaf(h), leaf(w2)
    z1 = matmul(h1, w21, FAST)
    (z1 * gz).sum().backward()
    assert torch.equal(z, z1)  # a contraction split over "model"
    assert torch.equal(hs.grad, h1.grad)
    assert torch.equal(torch.cat([b.grad for b in w2s.blocks], 0), w21.grad)


# ------------------------------------------------------------------ (c)
OPT = AdamWConfig(lr=1e-3)
STEP_CASES = {"qwen2-7b": (dict(num_layers=1, num_heads=8, num_kv_heads=2, head_dim=64), 4),
              "gemma2-27b": (dict(num_layers=2), 2)}  # a local and a global layer


def leaves_of(state) -> list:
    out = []
    for k, p in reference_leaves(state.params).items():
        out += [(k, "param", p.detach()), (k, "m", state.opt.m[k]), (k, "v", state.opt.v[k])]
    return out


@pytest.mark.parametrize("arch", list(STEP_CASES))
def test_sharded_step_bitwise(arch, one_torch_thread):  # noqa: F811
    overrides, model_ranks = STEP_CASES[arch]
    cfg = dataclasses.replace(get_config(arch, "smoke"), gemm=FAST, **overrides)
    model = Model(cfg, device="cpu")
    init, step = make_train_step(model, OPT)
    batch = synth_batch(DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size), cfg, 0)

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init(gen)

    single, want = step(fresh(), batch)
    for data, oracle in ((1, single), (2, None)):
        mesh = make_host_mesh(data, model_ranks, devices="cpu")
        shard_state, sstep, unshard_state = make_sharded_train_step(model, OPT, mesh)
        sharded, metrics = sstep(shard_state(fresh()), batch)
        if oracle is None:
            oracle = fresh()
            want = {"loss": dp_oracle_step(model, oracle, batch, data)}
        for k, v in want.items():
            assert float(metrics[k]) == float(v), (arch, data, k)
        got = unshard_state(sharded)
        for (k, what, g), (_, _, w) in zip(leaves_of(got), leaves_of(oracle)):
            assert torch.equal(g, w), (arch, data, k, what)


# ------------------------------------------------------------------ (d)
REF_OPT = dict(lr=1e-3)


def _ref_leaf(tree, name: str):
    path, layer = reference_path(name)
    for k in path:
        tree = tree[k]
    tree = np.asarray(tree)
    return tree if layer is None else tree[layer]


def test_native_step_near_the_reference(one_torch_thread):  # noqa: F811
    over = dict(num_heads=4, num_kv_heads=4, d_model=128)
    ref_model, ref_params, model, _ = family_pair("qwen2-7b", **over)
    data = RefDataConfig(batch=8, seq_len=32, vocab_size=ref_model.cfg.vocab_size)
    batch = ref_synth_batch(data, ref_model.cfg, 0)
    rcfg = ref_optim.AdamWConfig(**REF_OPT)
    _, ref_step = ref_make_train_step(ref_model, rcfg)
    state = RefTrainState(ref_params, ref_optim.init(rcfg, ref_params))
    carried = train_state_from_reference(model, jax.tree.map(np.asarray, state))
    new, ref_metrics = jax.jit(ref_step)(state, {k: jnp.asarray(v) for k, v in batch.items()})

    mesh = make_host_mesh(2, 4, devices="cpu")
    shard_state, step, unshard_state = make_sharded_train_step(model, AdamWConfig(**REF_OPT),
                                                               mesh)
    sharded, metrics = step(shard_state(carried), batch)
    assert abs(float(metrics["loss"]) - float(ref_metrics["loss"])) < LOSS_TOL
    got = unshard_state(sharded)
    for k, p in reference_leaves(got.params).items():
        for mine, tree, tol in ((p.detach(), new.params, PARAM_TOL),
                                (got.opt.m[k], new.opt.m, MOMENT_TOL),
                                (got.opt.v[k], new.opt.v, MOMENT_TOL)):
            mine, want = mine.double().numpy(), _ref_leaf(tree, k).astype(np.float64)
            err = np.linalg.norm(mine - want) / np.linalg.norm(want)
            assert err <= tol, (k, err)


# ------------------------------------------------------------------ (e)
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-27b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_cell_tensor_parallel(arch, shape_name, monkeypatch):
    from repro_torch.distribution import spmd

    handed = {}
    programs = spmd.sharded_programs

    def recording(*args, **kwargs):
        for d, axis, leaves, block in programs(*args, **kwargs):
            handed.update({k: type(v) for k, v in leaves.items()})
            yield d, axis, leaves, block

    monkeypatch.setattr(spmd, "sharded_programs", recording)
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "sharded_programs", recording)
    mesh = make_host_mesh(2, 2, devices="meta")
    rec = dryrun_cell(arch, shape_name, False, variant="smoke", mesh=mesh)
    assert rec["status"] == "ok", rec
    shape = SHAPES[shape_name]
    want = model_flops(get_config(arch, "smoke"), shape.kind, shape.global_batch // 2,
                       shape.seq_len, shape.seq_len + 8, model=2)
    assert rec["flops_per_device"] == want
    skeleton = Model(get_config(arch, "smoke"), device="meta").init()
    split = model_split(param_specs(skeleton), get_config(arch, "smoke"), mesh)
    assert split and {k for k, v in handed.items() if v is ModelSplit} == split
    # the clipping norm's gathers: each split leaf's whole gradient, once,
    # in the dry run's parameter dtype
    as_run = Model(get_config(arch, "smoke", **BIG_ARCHS.get(arch, {})), device="meta").init()
    grads = [p.numel() * p.element_size() for k, p in reference_leaves(as_run).items()
             if k in split] if shape.kind == "train" else [0]
    assert rec["clip_norm_gather_bytes_per_device"] == sum(grads)
    assert rec["clip_norm_largest_gather_bytes"] == max(grads)
    assert rec["collective_bytes_per_device"].get("all-gather", 0) >= sum(grads)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-27b"])
def test_dryrun_train_remat_full_flops(arch):
    """Under remat "full" the recompute skips each layer's MLP down
    projection (``tensor_parallel._RowOperands``), but after gemma2's
    post-norm: the dry run's train FLOPs equal ``model_flops``'."""
    mesh = make_host_mesh(2, 2, devices="meta")
    rec = dryrun_cell(arch, "train_4k", False, variant="smoke", mesh=mesh,
                      overrides={"remat": "full"})
    assert rec["status"] == "ok", rec
    shape = SHAPES["train_4k"]
    cfg = dataclasses.replace(get_config(arch, "smoke"), remat="full")
    assert rec["flops_per_device"] == model_flops(cfg, "train", shape.global_batch // 2,
                                                  shape.seq_len, model=2)


# ------------------------------------------------------------------ (g)
def test_remat_full_recompute_stops_before_the_down_projection(monkeypatch,
                                                               one_torch_thread):  # noqa: F811
    """A row-parallel product packs its operands before it runs, so remat
    "full" recomputes each layer's o projection but not its MLP down
    projection (the last product), as on one device; the step stays
    bitwise. Split contractions a step: forward o and down, o again, dX of
    the five column-parallel projections, and the lm_head's dX."""
    cfg = dataclasses.replace(get_config("qwen2-7b", "smoke"), gemm=FAST, remat="full")
    model = Model(cfg, device="cpu")
    init, step = make_train_step(model, OPT)
    batch = synth_batch(DataConfig(batch=2, seq_len=32, vocab_size=cfg.vocab_size), cfg, 0)

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        return init(gen)

    single, want = step(fresh(), batch)
    calls = []
    k_product = tp._Products.k
    monkeypatch.setattr(tp._Products, "k", lambda self, *a: calls.append(a[-1])
                        or k_product(self, *a))
    mesh = make_host_mesh(1, 2, devices="cpu")
    shard_state, sstep, unshard_state = make_sharded_train_step(model, OPT, mesh)
    sharded, metrics = sstep(shard_state(fresh()), batch)
    assert len(calls) == cfg.num_layers * (2 + 1 + 5) + 1
    assert float(metrics["loss"]) == float(want["loss"])
    for (k, what, g), (_, _, w) in zip(leaves_of(unshard_state(sharded)), leaves_of(single)):
        assert torch.equal(g, w), (k, what)


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("model_ranks", [2, 4])
def test_prefill_decode_bitwise(model_ranks, one_torch_thread):  # noqa: F811
    cfg = dataclasses.replace(get_config("qwen2-7b", "smoke"), gemm=FAST)
    model = Model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    params = model.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)}

    def serve(params, cache):
        logits, cache = model.prefill(params, batch, cache)
        out = [logits]
        for _ in range(2):
            logits, cache = model.decode_step(params, out[-1].argmax(-1), cache)
            out.append(logits)
        return out

    with torch.no_grad():
        want = serve(params, model.init_cache(params, batch, 12))
        mesh = make_host_mesh(1, model_ranks, devices="cpu")
        specs = param_specs(params)
        placed = {k: place(p.detach(), NamedSharding(mesh, specs[k]))
                  for k, p in reference_leaves(params).items()}
        (_, axis, leaves, _), = sharded_programs(mesh, placed, batch,
                                                 split=model_split(specs, cfg, mesh))
        skeleton = Model(cfg, device="meta").init()
        bind(skeleton, {k: rank_leaf(t, False) for k, t in leaves.items()})
        got = serve(skeleton, split_cache(model.init_cache(params, batch, 12), axis))
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (model_ranks, i)
