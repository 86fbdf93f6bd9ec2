"""repro_torch.models against repro.models on the same numpy inputs (the
qwen2-7b smoke config through params_from_reference): the prepared-weight
``layers.matmul`` bitwise under ozaki2-fp8/fast and ozaki2-int8/fast on
the kernel route's plain versions and on '+core'; paged KV exactly; GQA
attention and every Model serving path (dense aligned cache, dense slot
cache, paged pools) under native, logits to LOGIT_RTOL of max|logit| with
equal greedy tokens. The emulated model paths are in
test_torch_models_fast.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.moduli import make_moduli_set as ref_moduli_set
from repro.core.plan import quantize_matrix as ref_quantize_matrix
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import paged_kv as ref_paged_kv
from repro_torch.core.moduli import make_moduli_set
from repro_torch.core.plan import quantize_matrix
from repro_torch.kernels import ozmm_fused_parts_ref
from repro_torch.models import attention, layers, paged_kv

from _torch_models_parity import assert_logits_close, one_torch_thread, smoke_pair  # noqa: F401

FAMILY = {"ozaki2-fp8/fast": "fp8-hybrid", "ozaki2-int8/fast": "int8"}
ROUTES = ("+pallas", "+pallas+unfused", "+core")


@pytest.fixture(scope="module")
def matmul_cases():
    """Per (spec, dtype): x, the weight plan, and the reference's
    layers.matmul output; x (2, 3, 40) @ w (40, 24)."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((40, 24)) * 40 ** -0.5).astype(np.float32)
    cases = {}
    for spec, family in FAMILY.items():
        for dtype in ("float32", "bfloat16"):
            x = jnp.asarray(rng.standard_normal((2, 3, 40)).astype(np.float32)).astype(dtype)
            qw = ref_quantize_matrix(jnp.asarray(w, jnp.float64), "rhs",
                                     ref_moduli_set(family, 12 if family != "int8" else 14),
                                     mode="fast").drop_source()
            cases[spec, dtype] = (x, np.asarray(ref_layers.matmul(x, qw, spec).astype(jnp.float32)))
    return w, cases


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", list(FAMILY))
def test_prepared_matmul_bitwise(matmul_cases, spec, dtype, route):
    """layers.matmul with a cached (source-dropped) weight plan equals the
    reference's bit for bit, on the route given: K2's plain version
    ('+pallas'), the phase-split plain versions ('+pallas+unfused'), core."""
    w, cases = matmul_cases
    x, want = cases[spec, dtype]
    family = FAMILY[spec]
    ms = make_moduli_set(family, 12 if family != "int8" else 14)
    qw = quantize_matrix(torch.from_numpy(w).double(), "rhs", ms, mode="fast").drop_source()
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    calls = ozmm_fused_parts_ref.calls
    got = layers.matmul(tx, qw, spec + route)
    assert got.dtype == tx.dtype and got.shape == (2, 3, 24)
    assert ozmm_fused_parts_ref.calls == calls + (route == "+pallas")
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_paged_kv_exact():
    """flat_slot_index, paged_update (in place) and paged_gather equal the
    reference's, element for element, scratch-page collisions aside."""
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    vals = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    bt = np.array([[3, 1, 5], [2, 6, 4]], np.int32)
    pos = np.array([[0, 5, 9], [3, 4, 11]], np.int32)
    np.testing.assert_array_equal(
        paged_kv.flat_slot_index(torch.from_numpy(bt), torch.from_numpy(pos), 4).numpy(),
        np.asarray(ref_paged_kv.flat_slot_index(jnp.asarray(bt), jnp.asarray(pos), 4)))
    want = np.asarray(ref_paged_kv.paged_update(jnp.asarray(pool), jnp.asarray(vals),
                                                jnp.asarray(bt), jnp.asarray(pos)))
    tpool = torch.from_numpy(pool.copy())
    ptr = tpool.data_ptr()
    got = paged_kv.paged_update(tpool, torch.from_numpy(vals), torch.from_numpy(bt),
                                torch.from_numpy(pos))
    assert got is tpool and got.data_ptr() == ptr
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        paged_kv.paged_gather(got, torch.from_numpy(bt)).numpy(),
        np.asarray(ref_paged_kv.paged_gather(jnp.asarray(want), jnp.asarray(bt))))


@pytest.fixture(scope="module")
def native_pair():
    return smoke_pair()


def test_gqa_training_path_matches(native_pair):
    """gqa_apply without a cache (causal self-attention over the sequence)."""
    ref_model, ref_params, model, params = native_pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    ref_p = {k: v[0] for k, v in ref_params["stages"][0]["attn"].items()}
    want, _ = ref_attention.gqa_apply(
        ref_p, jnp.asarray(x), ref_model.cfg,
        ref_attention.AttnTemporal(jnp.asarray(pos), None, None), None, None)
    got, cache = attention.gqa_apply(
        params.stages[0][0].attn, torch.from_numpy(x), model.cfg,
        attention.AttnTemporal(torch.from_numpy(pos.copy()), None, None), None, None)
    assert cache is None
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_prefill_and_decode_step_dense_cache(native_pair):
    """Model.prefill + two decode_step calls over the aligned dense cache."""
    ref_model, ref_params, model, params = native_pair
    toks = np.random.default_rng(3).integers(1, 512, (2, 6))
    ref_cache = ref_model.init_cache(ref_params, {"tokens": jnp.asarray(toks)}, 12)
    want, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_cache)
    cache = model.init_cache(params, {"tokens": torch.from_numpy(toks)}, 12)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
    tok = assert_logits_close(got, want, "prefill")
    assert cache["pos"] == 6
    for step in range(2):
        want, ref_cache = ref_model.decode_step(ref_params, jnp.asarray(tok), ref_cache)
        got, cache = model.decode_step(params, torch.from_numpy(tok), cache)
        tok = assert_logits_close(got, want, f"decode step {step}")
    np.testing.assert_allclose(cache["stages"][0][1]["k"].numpy(),
                               np.asarray(ref_cache["stages"][0]["k"][1]), rtol=0, atol=1e-5)


def test_slot_paths_paged_and_dense(native_pair):
    """prefill_slots (ragged, paged) then decode_slots on the page pools,
    and decode_slots on a dense slot cache (per-slot positions)."""
    ref_model, ref_params, model, params = native_pair
    toks = np.random.default_rng(4).integers(1, 512, (2, 8))
    lengths = np.array([8, 5], np.int32)
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ref_pool = ref_model.init_paged_cache(7, 4)
    want, ref_pool = ref_model.prefill_slots(ref_params, jnp.asarray(toks), jnp.asarray(lengths),
                                             jnp.asarray(bt), ref_pool)
    pool = model.init_paged_cache(7, 4)
    k_ptr = pool["stages"][0][0]["k"].data_ptr()
    got, pool = model.prefill_slots(params, toks, lengths, bt, pool)
    tok = assert_logits_close(got, want, "prefill_slots")
    pos = lengths.copy()
    for step in range(2):
        want, ref_pool = ref_model.decode_slots(ref_params, jnp.asarray(tok), jnp.asarray(pos),
                                                ref_pool, jnp.asarray(bt))
        got, pool = model.decode_slots(params, tok, pos, pool, bt)
        tok = assert_logits_close(got, want, f"paged decode step {step}")
        pos = pos + 1
    assert pool["stages"][0][0]["k"].data_ptr() == k_ptr  # written in place

    # dense slot cache: prefill both rows (aligned), then per-slot decode
    ref_slots = ref_model.init_slot_cache(2, 12)
    _, ref_slots = ref_model.prefill(ref_params, {"tokens": jnp.asarray(toks)}, ref_slots)
    slots = model.init_slot_cache(2, 12)
    _, slots = model.prefill(params, {"tokens": torch.from_numpy(toks)}, slots)
    positions = np.array([8, 8], np.int32)
    want, _ = ref_model.decode_slots(ref_params, jnp.asarray(tok), jnp.asarray(positions),
                                     ref_slots)
    got, _ = model.decode_slots(params, tok, positions, slots)
    assert_logits_close(got, want, "dense slot decode")


def test_unported_families_raise():
    """Every config builds and serves through the port (prefill +
    decode_step), and trains: forward_train (ported since) gives finite
    logits of every position and an f32 aux loss."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import Model

    assert len(ARCHS) == 10
    for arch in ARCHS:
        cfg = get_config(arch, "smoke")
        model = Model(cfg, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(0)
        params = model.init(gen)
        batch = {"tokens": torch.tensor([[5, 6, 7]])}
        if cfg.frontend == "vit-stub":
            batch["patch_embeds"] = torch.zeros((1, cfg.frontend_len, cfg.frontend_dim))
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, 4, cfg.frontend_dim))
        cache = model.init_cache(params, batch, 16)
        logits, cache = model.prefill(params, batch, cache)
        logits, cache = model.decode_step(params, logits.argmax(-1), cache)
        assert logits.shape == (1, cfg.padded_vocab), arch
        assert torch.isfinite(logits[:, :cfg.vocab_size]).all(), arch
        with torch.no_grad():
            out = model.forward_train(params, batch)
        positions = 3 + (cfg.frontend_len if cfg.frontend == "vit-stub" else 0)
        assert out.logits.shape == (1, positions, cfg.padded_vocab), arch
        assert torch.isfinite(out.logits[..., :cfg.vocab_size]).all(), arch
        assert out.aux_loss.dtype == torch.float32 and torch.isfinite(out.aux_loss), arch


def test_model_runs_on_the_card_unless_asked():
    """device=None means the card: without one the model raises, never
    falls back to the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("qwen2-7b", "smoke")
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
