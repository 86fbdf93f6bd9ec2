"""repro_torch.models' Mamba2 (SSM) and zamba2 (hybrid) families against
repro.models on the same numpy weights (mamba2-2.7b and zamba2-1.2b smoke
configs): prefill + decode_step over the aligned cache and decode_slots on
the dense slot cache (the engine's, as these caches are not pageable),
under native f32, logits to LOGIT_RTOL of max|logit| with equal greedy
tokens; ssd_chunked, the padded chunked prefill and the one-step
recurrence of mamba2_apply at a length that is not a multiple of the
chunk, outputs and states to rtol 1e-5; stage_apply's zamba2 weave (the
shared block after each layer, its cache under "shared"); and, within the
port, a mamba2 request served alone equal to the batch (tokens)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as ref_attention
from repro.models import blocks as ref_blocks
from repro.models import ssm as ref_ssm
from repro_torch.models import attention, blocks, ssm

from _torch_families_parity import (check_aligned, check_batch_equals_alone, check_slots,
                                    family_pair, ref_aligned, ref_slots)
from _torch_models_parity import one_torch_thread  # noqa: F401

ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
#: 21 prompt tokens: the smoke chunk is 16, so prefill pads to 32.
TOKS = np.random.default_rng(9).integers(1, 512, (2, 21))
MAX_LEN = 24


def close(got: torch.Tensor, want, what: str, rtol: float = 1e-5) -> None:
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), f"{what}: max |port - ref| {err}"


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    ref_model, ref_params, model, params = family_pair(request.param)
    return {"model": model, "params": params, "ref_model": ref_model, "ref_params": ref_params,
            "aligned": ref_aligned(ref_model, ref_params, {"tokens": TOKS}, MAX_LEN),
            "slots": ref_slots(ref_model, ref_params, TOKS, MAX_LEN)}


def test_prefill_and_decode_step_aligned_cache(runs):
    check_aligned(runs["model"], runs["params"], {"tokens": TOKS}, MAX_LEN, runs["aligned"])


def test_dense_slot_cache_decode(runs):
    check_slots(runs["model"], runs["params"], TOKS, MAX_LEN, runs["slots"])


def test_ssd_and_recurrence_match_reference():
    """mamba2's first mixer: ssd_chunked, mamba2_apply's chunked prefill
    from a zero state at 21 steps (output, conv state and f32 SSD state)
    and two one-step decodes from that state."""
    ref_model, ref_params, model, params = family_pair("mamba2-2.7b")
    cfg, ref_cfg = model.cfg, ref_model.cfg
    mixer = params.stages[0][0].mixer
    ref_p = jax.tree.map(lambda a: a[0], ref_params["stages"][0]["mixer"])
    rng = np.random.default_rng(12)
    b, s, h, p, n = 2, 32, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    y_ref, st_ref = jax.jit(ref_ssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (xs, dt, a, bm, cm)), cfg.ssm_chunk)
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, (xs, dt, a, bm, cm)), cfg.ssm_chunk)
    close(y, y_ref, "ssd_chunked y")
    close(st, st_ref, "ssd_chunked final state")

    x = rng.standard_normal((b, 21, cfg.d_model)).astype(np.float32)
    ref_state = ref_ssm.init_ssm_state(ref_cfg, b, jnp.float32)
    state = ssm.init_ssm_state(cfg, b, torch.float32, "cpu")
    ref_apply = jax.jit(ref_ssm.mamba2_apply, static_argnums=2)
    want, ref_state = ref_apply(ref_p, jnp.asarray(x), ref_cfg, ref_state)
    got, state = ssm.mamba2_apply(mixer, torch.from_numpy(x), cfg, state)
    for step in range(3):
        close(got, want, f"mamba2_apply step {step}")
        close(state.conv, ref_state.conv, f"conv state {step}")
        close(state.ssd, ref_state.ssd, f"ssd state {step}")
        x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, ref_state = ref_apply(ref_p, jnp.asarray(x1), ref_cfg, ref_state)
        got, state = ssm.mamba2_apply(mixer, torch.from_numpy(x1), cfg, state)


def test_stage_weave_of_the_shared_block():
    """stage_apply with zamba2's shared_attn_params on its first mamba stage
    over a dense cache: the shared block after each layer, its KV under
    "shared"."""
    ref_model, ref_params, model, params = family_pair("zamba2-1.2b")
    cfg, ref_cfg = model.cfg, ref_model.cfg
    n = model.stages[0].spec.num_layers
    x = np.random.default_rng(13).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    ref_cache = jax.tree.map(lambda a: a, ref_model._stage_caches(2, 8)[0])
    ref_cache["shared"] = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape),
                                       ref_model._stage_caches(2, 8)[1])
    ref_stage = jax.jit(ref_blocks.stage_apply, static_argnums=(2, 6, 7))
    want, ref_new, _ = ref_stage(
        ref_params["stages"][0], jnp.asarray(x), ref_cfg,
        ref_attention.AttnTemporal(jnp.asarray(pos), 5, None), jnp.full((n,), 2 ** 30),
        ref_cache, "mamba", False, ref_params["shared_attn"])
    cache = [dict(c, shared=model._stage_caches(2, 8)[1][0]) for c in model._stage_caches(2, 8)[0]]
    got, new, _ = blocks.stage_apply(
        params.stages[0], torch.from_numpy(x), cfg,
        attention.AttnTemporal(torch.from_numpy(pos.copy()), 5, None), [2 ** 30] * n, cache,
        "mamba", shared_attn_params=params.shared_attn)
    close(got, want, "weave output")
    for i in range(n):
        close(new[i]["ssd"], ref_new["ssd"][i], f"layer {i} ssd state")
        close(new[i]["shared"]["k"], ref_new["shared"]["k"][i], f"layer {i} shared k")


def test_engine_request_alone_equals_batch(runs):
    """The slot-pooled BatchingEngine (exact-length B=1 prefills scattered
    into the pool, full-slot decode): each request alone gives its tokens
    in the batch."""
    prompts = [[int(t) for t in row] for row in np.random.default_rng(14).integers(1, 512, (3, 9))]
    prompts[2] = prompts[2][:5]
    check_batch_equals_alone(runs["model"], runs["params"], prompts, 3, max_len=16, max_slots=3)
