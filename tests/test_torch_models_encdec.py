"""repro_torch.models' encoder-decoder and vlm families against
repro.models on the same numpy weights (seamless-m4t-medium and
internvl2-26b smoke configs): the encoder memory of audio-stub frames,
then prefill + decode_step with cross-attention over it; prefill with
vit-stub patch embeddings before the tokens, then decode_step; under native
f32, memory to rtol 1e-5 and logits to LOGIT_RTOL of max|logit| with equal
greedy tokens. And the serving gates, with the reference's messages: the
BatchingEngine refuses both families (they serve through Model.init_cache
/ prefill / decode_step), the paged cache refuses them and the SSM
families, the encdec slot cache needs its encoder length."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.serve import BatchingEngine as RefBatchingEngine
from repro_torch.serve import BatchingEngine

from _torch_families_parity import check_aligned, family_pair, ref_aligned
from _torch_models_parity import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(15)
TOKS = RNG.integers(1, 512, (2, 6))
FRAMES = RNG.standard_normal((2, 9, 64)).astype(np.float32)
PATCHES = RNG.standard_normal((2, 8, 64)).astype(np.float32)
BATCHES = {"seamless-m4t-medium": {"tokens": TOKS, "frames": FRAMES},
           "internvl2-26b": {"tokens": TOKS, "patch_embeds": PATCHES}}
MAX_LEN = 20


@pytest.fixture(scope="module", params=list(BATCHES))
def runs(request):
    ref_model, ref_params, model, params = family_pair(request.param)
    batch = BATCHES[request.param]
    return {"model": model, "params": params, "ref_model": ref_model, "ref_params": ref_params,
            "batch": batch, "aligned": ref_aligned(ref_model, ref_params, batch, MAX_LEN)}


def test_prefill_and_decode_step_aligned_cache(runs):
    """seamless: the encoder's memory in the cache, cross-attention in every
    decoder layer; internvl2: 8 projected patches ahead of 6 tokens, the
    cache positions counting both."""
    batch = runs["batch"]
    cache = check_aligned(runs["model"], runs["params"], batch, MAX_LEN, runs["aligned"])
    prefix = PATCHES.shape[1] if "patch_embeds" in batch else 0
    assert cache["pos"] == prefix + TOKS.shape[1] + len(runs["aligned"]) - 1
    if "frames" in batch:
        want = np.asarray(runs["ref_model"]._encode(runs["ref_params"],
                                                    {"frames": jnp.asarray(FRAMES)}))
        got = cache["enc_memory"].numpy()
        assert got.shape == want.shape == (2, FRAMES.shape[1], 128)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _message(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_serving_gates_match_reference(arch):
    """The engine refuses encdec and frontend configs, the paged cache every
    family but token-only dense and moe; an encdec slot cache needs the
    encoder length: each with the reference's message, and the slot cache
    of the reference's shapes."""
    ref_model, ref_params, model, params = family_pair(arch)
    kw = dict(max_len=8, max_slots=2)
    if model.cfg.family == "encdec" or model.cfg.frontend:
        assert _message(lambda: BatchingEngine(model, params, **kw)) == _message(
            lambda: RefBatchingEngine(ref_model, ref_params, **kw))
    assert _message(lambda: model.init_paged_cache(5, 4)) == _message(
        lambda: ref_model.init_paged_cache(5, 4))
    if model.cfg.family == "encdec":
        assert _message(lambda: model.init_slot_cache(2, 8)) == _message(
            lambda: ref_model.init_slot_cache(2, 8))
    enc_len = 9 if model.cfg.family == "encdec" else None
    got, want = model.init_slot_cache(2, 8, enc_len), ref_model.init_slot_cache(2, 8, enc_len)
    if enc_len:
        assert tuple(got["enc_memory"].shape) == want["enc_memory"].shape
    for stage, ref_stage in zip(got["stages"], want["stages"]):
        for i, layer in enumerate(stage):
            for k, v in layer.items():  # the reference stacks a stage's layers (not a shared block)
                ref_v = ref_stage[k] if ref_stage[k].ndim == v.ndim else ref_stage[k][i]
                assert tuple(v.shape) == ref_v.shape and str(v.dtype)[6:] == ref_v.dtype.name, k
