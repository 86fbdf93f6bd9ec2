"""repro_torch.distribution.sharding and repro_torch.configs.shapes against
the reference on the CPU: the PartitionSpecs of every leaf, for all ten
configs, equal to the reference's (``param_specs`` at the full config with
fsdp on and off, single and multi-pod, and moonshot's and deepseek-v3's
expert modes; the AdamW state, deepseek-v3's with Q8 moments;
``batch_specs``; ``cache_specs`` on a smoke config's cache). The reference
runs on ``jax.eval_shape``, each config traced once a module; the port on
``meta`` tensors. The reference stacks a stage's layers on a leading axis
and prepends ``None`` for it: a port leaf of such a stage is held to the
reference spec without that entry. Also ``NamedSharding.shard`` /
``unshard`` round-tripping a training state bitwise on a 2 x 4 CPU mesh,
and ``input_specs`` / ``applicable`` for every config x shape.
"""
import functools

import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable as ref_applicable
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.distribution import batch_specs as ref_batch_specs
from repro.distribution import cache_specs as ref_cache_specs
from repro.distribution import param_specs as ref_param_specs
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, input_specs
from repro_torch.distribution import batch_specs, cache_specs, named, param_specs
from repro_torch.distribution.sharding import P, _keystr
from repro_torch.launch import make_host_mesh
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves, reference_path
from repro_torch.optim import AdamWConfig, Q8
from repro_torch.optim import init as opt_init
from repro_torch.train import TrainState

from _torch_threads import one_torch_thread  # noqa: F401

EIGHTBIT = "deepseek-v3-671b"
EXPERT_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
#: the cache batch, divisible by the data axis
CACHE_BATCH, CACHE_LEN = 6, 16


class FakeMesh:
    """What the reference's ``cache_specs`` reads of a mesh: its shape."""
    shape = {"data": 2, "model": 4}


@functools.lru_cache(maxsize=None)
def reference_state(arch: str):
    """The reference's TrainState at the full config, as shape structs."""
    init_fn, _ = ref_make_train_step(RefModel(ref_get_config(arch, "full")),
                                     RefAdamWConfig(eightbit=arch == EIGHTBIT))
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_state(arch: str) -> TrainState:
    params = Model(get_config(arch, "full"), device="meta").init()
    return TrainState(params, opt_init(AdamWConfig(eightbit=arch == EIGHTBIT),
                                       reference_leaves(params)))


def ref_spec_table(tree, specs) -> dict:
    """keystr -> (spec as a tuple, ndim) over the reference's leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    assert len(leaves) == len(spec_leaves)
    return {jax.tree_util.keystr(p): (tuple(s), len(x.shape))
            for (p, x), (_, s) in zip(leaves, spec_leaves)}


def assert_leaf(table: dict, seen: set, path: tuple, spec: P, ndim: int) -> None:
    """The port's spec of a leaf at reference ``path`` is the reference's,
    without the stacked layer axis where the port leaf lacks it."""
    key = _keystr(path)
    assert key in table, key
    seen.add(key)
    want, ref_ndim = table[key]
    assert isinstance(spec, P), key
    if want == ():
        assert tuple(spec) == (), key
        return
    drop = ref_ndim - ndim
    assert drop in (0, 1), key
    assert all(a is None for a in want[:drop]), key
    assert tuple(spec) == want[drop:], key


def check_module(table, seen, specs: dict, params, prefix: tuple) -> None:
    leaves = reference_leaves(params)
    assert list(specs) == list(leaves)
    for name, p in leaves.items():
        assert_leaf(table, seen, prefix + reference_path(name)[0], specs[name], p.dim())


def param_cases():
    for arch in ARCHS:
        modes = ("fsdp", "ep") if arch in EXPERT_ARCHS else ("fsdp",)
        yield pytest.param(arch, modes, id=arch)


@pytest.mark.parametrize("arch,modes", list(param_cases()))
def test_param_specs_equal_reference(arch, modes):
    ref_params = reference_state(arch).params
    params = port_state(arch).params
    for fsdp in (True, False):
        for multi_pod in (False, True):
            for mode in modes:
                kw = dict(fsdp=fsdp, multi_pod=multi_pod, expert_mode=mode)
                table = ref_spec_table(ref_params, ref_param_specs(ref_params, **kw))
                seen: set = set()
                check_module(table, seen, param_specs(params, **kw), params, ())
                assert seen == set(table), (arch, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_equal_reference(arch):
    """params, step and the AdamW moments (Q8 blocks for deepseek-v3)."""
    ref, state = reference_state(arch), port_state(arch)
    table = ref_spec_table(ref, ref_param_specs(ref))
    specs = param_specs(state)
    seen: set = set()
    check_module(table, seen, specs.params, state.params, (("attr", "params"),))
    assert_leaf(table, seen, (("attr", "opt"), ("attr", "step")), specs.opt.step, 0)
    for f in ("m", "v"):
        moments, mspecs = getattr(state.opt, f), getattr(specs.opt, f)
        for name, x in moments.items():
            path = (("attr", "opt"), ("attr", f)) + reference_path(name)[0]
            if isinstance(x, Q8):
                assert arch == EIGHTBIT and isinstance(mspecs[name], Q8)
                for i, (t, s) in enumerate(zip((x.q, x.scale), mspecs[name][:2])):
                    assert_leaf(table, seen, path + (("flat", i),), s, t.dim())
            else:
                assert_leaf(table, seen, path, mspecs[name], x.dim())
    assert seen == set(table)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_specs_equal_reference(multi_pod):
    for arch in ("qwen2-7b", "internvl2-26b", "seamless-m4t-medium"):
        ref_cfg, cfg = ref_get_config(arch, "smoke"), get_config(arch, "smoke")
        want = ref_batch_specs(ref_input_specs(ref_cfg, REF_SHAPES["train_4k"]), multi_pod)
        got = batch_specs(input_specs(cfg, SHAPES["train_4k"]), multi_pod)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def _cache_batch(cfg, empty):
    batch = {"tokens": empty((CACHE_BATCH, CACHE_LEN), "int32")}
    if cfg.family == "encdec":
        batch["frames"] = empty((CACHE_BATCH, CACHE_LEN, cfg.frontend_dim), "float32")
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    ref_model = RefModel(ref_get_config(arch, "smoke"))
    ref_params = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    ref_batch = _cache_batch(ref_model.cfg, lambda s, d: jax.ShapeDtypeStruct(s, d))
    ref_cache = jax.eval_shape(lambda p, b: ref_model.init_cache(p, b, CACHE_LEN),
                               ref_params, ref_batch)
    for multi_pod in (False, True):
        mesh = FakeMesh()
        if multi_pod:
            mesh.shape = {"pod": 1, "data": 2, "model": 4}
        want = ref_cache_specs(ref_cache, ref_model.cfg, mesh, multi_pod)
        model = Model(get_config(arch, "smoke"), device="meta")
        batch = _cache_batch(model.cfg, lambda s, d: torch.empty(
            s, dtype=getattr(torch, d), device="meta"))
        cache = model.init_cache(model.init(), batch, CACHE_LEN)
        got = cache_specs(cache, model.cfg, mesh, multi_pod)
        assert tuple(got["pos"]) == tuple(want["pos"]) == ()
        if "enc_memory" in cache:
            assert tuple(got["enc_memory"]) == tuple(want["enc_memory"])
        assert len(got["stages"]) == len(want["stages"])
        for entry, stage, ref_stage in zip(model.stages, got["stages"], want["stages"]):
            for layer in stage:
                for name, spec in layer.items():
                    ref = tuple(ref_stage[name])
                    assert tuple(spec) == (ref if entry.spec.shared_attn else ref[1:]), \
                        (arch, name)


def test_shard_unshard_round_trip_bitwise():
    """Every leaf of a training state (8-bit moments included) cut into the
    blocks of a 2 x 4 CPU mesh and gathered back, bit for bit; each rank's
    block is its own tensor, of the block shape."""
    model = Model(get_config("deepseek-v3-671b", "smoke"), device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    state = TrainState(params, opt_init(AdamWConfig(eightbit=True), reference_leaves(params)))
    for x in state.opt.m.values():
        x.scale.uniform_(0.5, 2.0, generator=gen)
    mesh = make_host_mesh(2, 4, devices="cpu")
    specs = param_specs(state)
    shard = named(mesh, specs)
    split = 0
    leaves = [(p, shard.params[k]) for k, p in reference_leaves(params).items()]
    leaves += [(t, s) for k, x in state.opt.m.items()
               for t, s in ((x.q, shard.opt.m[k].q), (x.scale, shard.opt.m[k].scale))]
    for t, sh in leaves:
        blocks = sh.shard(t)
        assert len(blocks) == 8
        assert len({b.data_ptr() for b in blocks if b.numel()}) == sum(
            1 for b in blocks if b.numel())
        for r, b in enumerate(blocks):
            assert b.shape == sh.block(t, r).shape
        split += sh.is_split(t.dim())
        assert torch.equal(sh.unshard(blocks), t.detach())
    assert split > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_applicable_equal_reference(arch):
    ref_cfg, cfg = ref_get_config(arch, "full"), get_config(arch, "full")
    for name, shape in SHAPES.items():
        assert applicable(cfg, shape) == ref_applicable(ref_cfg, REF_SHAPES[name])
        for override in (None, 3):
            want = ref_input_specs(ref_cfg, REF_SHAPES[name], override)
            got = input_specs(cfg, shape, override)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (name, k)
                assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), (name, k)
