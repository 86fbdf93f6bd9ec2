"""repro_torch.models' MoE and MLA families against repro.models on the same
numpy weights (moonshot-v1-16b-a3b and deepseek-v3-671b smoke configs):
prefill + decode_step over the aligned cache, the ragged paged
prefill_slots + decode_slots (MLA's latent page pools), and decode_slots
on a dense slot cache, under native f32, logits to LOGIT_RTOL of
max|logit| with equal greedy tokens; moe_apply's capacity dispatch given
the reference's own router logits (top-k indices, queue positions and the
keep mask bitwise, y to rtol 1e-6); the router's and shared expert's
fast-mode weight plans bitwise against the reference's stacked plans; the
weight cache's leaves and sketches for every new family; and, within the
port, dropless MoE and MLA requests served alone equal to the batch."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as ref_moe
from repro.serve import collect_weight_sketches as ref_collect_weight_sketches
from repro.serve import quantize_params as ref_quantize_params
from repro.serve import weight_cache as ref_weight_cache
from repro_torch.core.plan import QuantizedMatrix
from repro_torch.models import moe
from repro_torch.serve import WeightResidueCache, collect_weight_sketches, quantize_params

from _torch_families_parity import (check_aligned, check_batch_equals_alone, check_paged,
                                    check_slots, family_pair, port_path_as_ref, ref_aligned,
                                    ref_paged, ref_slots)
from _torch_models_parity import one_torch_thread  # noqa: F401

FAST = "ozaki2-fp8/fast"
ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
NEW_FAMILIES = ARCHS + ("mamba2-2.7b", "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b")
TOKS = np.random.default_rng(7).integers(1, 512, (2, 7))
LENGTHS = np.array([7, 4], np.int32)
BT = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
MAX_LEN = 12


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """The pair of one arch and the reference's logits on its three paths."""
    ref_model, ref_params, model, params = family_pair(request.param)
    return {"model": model, "params": params, "ref_model": ref_model,
            "ref_params": ref_params,
            "aligned": ref_aligned(ref_model, ref_params, {"tokens": TOKS}, MAX_LEN),
            "paged": ref_paged(ref_model, ref_params, TOKS, LENGTHS, BT, 7, 4),
            "slots": ref_slots(ref_model, ref_params, TOKS, MAX_LEN)}


def test_prefill_and_decode_step_aligned_cache(runs):
    check_aligned(runs["model"], runs["params"], {"tokens": TOKS}, MAX_LEN, runs["aligned"])


def test_paged_prefill_and_decode_slots(runs):
    """MoE layers over a ragged bucket; MLA's ckv/krope page pools."""
    check_paged(runs["model"], runs["params"], TOKS, LENGTHS, BT, 7, 4, runs["paged"])


def test_dense_slot_cache_decode(runs):
    check_slots(runs["model"], runs["params"], TOKS, MAX_LEN, runs["slots"])


def test_capacity_dispatch_given_reference_router_logits(runs, monkeypatch):
    """One MoE layer on clustered tokens (so that experts overflow their
    capacity): the port's dispatch of the reference's router logits gives
    the reference's top-k experts and each choice's queue slot (its
    position, or the capacity where dropped) bitwise; moe_apply on the same
    logits gives y to rtol 1e-6 of max|y| and the aux loss to 1e-7."""
    model, ref_model = runs["model"], runs["ref_model"]
    cfg = model.cfg
    rng = np.random.default_rng(11)
    protos = rng.standard_normal((3, cfg.d_model))
    x = (protos[rng.integers(0, 3, (2, 40))] + 0.05 * rng.standard_normal((2, 40, cfg.d_model)))
    x = x.astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], runs["ref_params"]["stages"][1]["moe"])
    seen = {"logits": [], "one_hot": []}
    ref_matmul, one_hot = ref_moe.matmul, jax.nn.one_hot

    def record_matmul(*a, **kw):  # moe.py's own matmul is the router's alone
        seen["logits"].append(ref_matmul(*a, **kw))
        return seen["logits"][-1]

    def record_one_hot(idx, *a, **kw):
        seen["one_hot"].append(np.asarray(idx))
        return one_hot(idx, *a, **kw)

    monkeypatch.setattr(ref_moe, "matmul", record_matmul)
    monkeypatch.setattr(jax.nn, "one_hot", record_one_hot)
    want = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_model.cfg)
    monkeypatch.undo()
    (logits,) = seen["logits"]
    top_idx, _, slot = seen["one_hot"]  # top-k, its weighted copy, where(keep, pos, cap)
    cap = moe.capacity(40, cfg)
    assert (slot == cap).any() and (slot < cap).any()  # some choices dropped, some kept

    logits = torch.from_numpy(np.array(logits))
    probs = torch.softmax(logits, dim=-1)
    _, got_idx, pos, keep = moe.dispatch(probs, cfg.experts_per_token, cap)
    np.testing.assert_array_equal(got_idx.numpy(), top_idx)
    np.testing.assert_array_equal(torch.where(keep, pos, cap).numpy(), slot)

    monkeypatch.setattr(moe, "matmul", lambda *a, **kw: logits)
    got = moe.moe_apply(runs["params"].stages[1][0].moe, torch.from_numpy(x), cfg)
    y = np.asarray(want.y)
    assert np.abs(got.y.numpy() - y).max() <= 1e-6 * np.abs(y).max()
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss), rtol=1e-7)


def test_router_and_shared_expert_plans_equal_reference(runs):
    """The fast-mode plans of the MoE stage's router and shared expert,
    layer by layer, equal the reference's vmapped stacked plans sliced at
    the layer: parts, lscale frames and abs-max sketches bitwise, the f64
    sums of squares to rtol 1e-15 (XLA's summation order against torch's)."""
    ref_moe_p = runs["ref_params"]["stages"][1]["moe"]
    ref_plans = ref_quantize_params({"router": ref_moe_p["router"],
                                     "shared": ref_moe_p["shared"]}, FAST)
    serve = quantize_params(runs["params"], FAST)
    for i, block in enumerate(serve.stages[1]):
        pairs = [(block.moe.router, ref_plans["router"])]
        pairs += [(getattr(block.moe.shared, n), ref_plans["shared"][n])
                  for n in ("w_gate", "w_up", "w_down")]
        for plan, ref in pairs:
            assert isinstance(plan, QuantizedMatrix) and plan.x is None
            np.testing.assert_array_equal(plan.lscale.numpy(), np.asarray(ref.lscale)[i])
            for f in ("row_max", "col_max"):
                np.testing.assert_array_equal(getattr(plan.stats, f).numpy(),
                                              np.asarray(getattr(ref.stats, f))[i])
            for f in ("row_sq", "col_sq"):
                np.testing.assert_allclose(getattr(plan.stats, f).numpy(),
                                           np.asarray(getattr(ref.stats, f))[i], rtol=1e-15)
            for mine, theirs in zip(plan.parts, ref.parts):
                for a, b in zip(mine, theirs):
                    b = np.asarray(b)[i]
                    np.testing.assert_array_equal(
                        a.view(torch.uint8).numpy() if a.dtype == torch.float8_e4m3fn else a.numpy(),
                        b.view(np.uint8) if b.dtype.name == "float8_e4m3fn" else b)
        assert block.moe.w_gate is runs["params"].stages[1][i].moe.w_gate  # experts stay raw


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_weight_cache_covers_reference_leaves(arch):
    """The port's cache plans exactly the reference's matmul-weight leaves
    (router, in_proj/out_proj, MLA's w_dq/w_uq/w_dkv, the encoder's and
    cross-attention's weights, frontend_proj, mtp's proj, zamba2's shared
    block as one plan), one per layer of a stacked leaf; MLA's w_uk/w_uv,
    the expert stacks, embeddings and norms stay raw; the sketches are the
    reference's paths (a stage's layers together)."""
    ref_model, ref_params, model, params = family_pair(arch)
    leaves, _ = jax.tree_util.tree_flatten_with_path(ref_params)
    want = {jax.tree_util.keystr(p): (leaf.shape[0] if leaf.ndim == 3 else None)
            for p, leaf in leaves if ref_weight_cache._is_matmul_weight(p, leaf)}
    cache = WeightResidueCache(FAST)
    serve = quantize_params(params, FAST, cache)
    got = {}
    for path, _, _ in cache._cache:
        ref_path, layer = port_path_as_ref(path)
        got.setdefault(ref_path, []).append(layer)
    assert {p: (len(ls) if ls != [None] else None) for p, ls in got.items()} == want
    for name, _ in params.named_parameters():
        planned = any(k[0] == name for k in cache._cache)
        leaf = serve.get_parameter(name) if not planned else None
        assert planned or isinstance(leaf, torch.nn.Parameter), name
    assert {port_path_as_ref(s.path)[0] for s in collect_weight_sketches(params)} == {
        s.path for s in ref_collect_weight_sketches(ref_params)}


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_engine_batch_equals_alone(arch):
    """Dropless MoE (deepseek's with MLA) through the paged BatchingEngine:
    each request alone gives its tokens in the batch. Capacity dispatch is
    not batch-invariant by design: capacity follows the bucket's length."""
    _, _, model, params = family_pair(arch, moe_dropless=True)
    prompts = [[int(t) for t in row] for row in np.random.default_rng(8).integers(1, 512, (3, 6))]
    prompts[1] = prompts[1][:4]
    check_batch_equals_alone(model, params, prompts, 3, max_len=12, max_slots=3, page_size=4)
