"""Shared by tests/test_torch_models_{moe,ssm,encdec}.py: the smoke config of
one model family in the JAX reference and in the PyTorch port with the same
weights, the reference's serving steps jitted (as its engine runs them),
and the comparisons.

The weights are drawn with numpy from a seed into the shapes of the
reference's ``Model.init`` (``jax.eval_shape``: its eager init takes
seconds a config); norms, biases and the SSM's per-head scalars get small
random values, so that none of them is an identity. The port loads them
through ``params_from_reference``. Logits are held to ``LOGIT_RTOL`` of
max|logit| with equal greedy tokens (``_torch_models_parity``).
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_reference

from _torch_models_parity import assert_logits_close

#: Reference leaves that are vectors of a layer (stacked or not): drawn at
#: scale 0.1 rather than 1/sqrt(fan-in).
VECTORS = frozenset({"bq", "bk", "bv", "conv_b", "A_log", "D", "dt_bias", "norm_h", "norm_e"})


def ref_params_from_seed(ref_model, seed: int) -> dict:
    """The reference params pytree (numpy leaves) of ``ref_model``'s shapes,
    drawn from ``seed``."""
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        name = path[-1].key
        vector = name in VECTORS or name.endswith("norm")
        scale = 0.1 if vector else sd.shape[-2] ** -0.5
        return (rng.standard_normal(sd.shape) * scale).astype(sd.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def family_pair(arch: str, seed: int = 0, **overrides):
    """(reference model, its params, port model, the same params) on
    ``arch``'s smoke config (with ``overrides``), the port on the CPU."""
    ref_model = RefModel(dataclasses.replace(ref_get_config(arch, "smoke"), **overrides))
    model = Model(dataclasses.replace(get_config(arch, "smoke"), **overrides), device="cpu")
    tree = ref_params_from_seed(ref_model, seed)
    return ref_model, jax.tree.map(jnp.asarray, tree), model, params_from_reference(model, tree)


def ref_aligned(ref_model, ref_params, batch: dict, max_len: int, steps: int = 2) -> list:
    """The reference's init_cache + prefill and ``steps`` greedy
    decode_steps over the aligned dense cache: each step's logits."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    cache = ref_model.init_cache(ref_params, batch, max_len)
    logits, cache = jax.jit(ref_model.prefill)(ref_params, batch, cache)
    out = [np.asarray(logits)]
    decode = jax.jit(ref_model.decode_step)
    for _ in range(steps):
        logits, cache = decode(ref_params, logits.argmax(-1), cache)
        out.append(np.asarray(logits))
    return out


def check_aligned(model, params, batch: dict, max_len: int, want: list) -> dict:
    """The port's init_cache + prefill + decode_steps against ``want``
    (``ref_aligned``); returns the final cache."""
    cache = model.init_cache(params, batch, max_len)
    got, cache = model.prefill(params, batch, cache)
    tok = assert_logits_close(got, want[0], "prefill")
    for i, w in enumerate(want[1:]):
        got, cache = model.decode_step(params, torch.from_numpy(tok), cache)
        tok = assert_logits_close(got, w, f"decode step {i}")
    return cache


def ref_paged(ref_model, ref_params, toks, lengths, bt, num_pages: int, page_size: int,
              steps: int = 2) -> list:
    """The reference's ragged paged prefill_slots and ``steps`` greedy
    decode_slots over its page pools: each step's logits."""
    pool = ref_model.init_paged_cache(num_pages, page_size)
    bt = jnp.asarray(bt)
    logits, pool = jax.jit(ref_model.prefill_slots)(ref_params, jnp.asarray(toks),
                                                    jnp.asarray(lengths), bt, pool)
    out = [np.asarray(logits)]
    decode = jax.jit(ref_model.decode_slots)
    pos = jnp.asarray(lengths)
    for _ in range(steps):
        logits, pool = decode(ref_params, logits.argmax(-1), pos, pool, bt)
        out.append(np.asarray(logits))
        pos = pos + 1
    return out


def check_paged(model, params, toks, lengths, bt, num_pages: int, page_size: int,
                want: list) -> None:
    pool = model.init_paged_cache(num_pages, page_size)
    got, pool = model.prefill_slots(params, toks, lengths, bt, pool)
    tok = assert_logits_close(got, want[0], "prefill_slots")
    pos = np.asarray(lengths).copy()
    for i, w in enumerate(want[1:]):
        got, pool = model.decode_slots(params, tok, pos, pool, bt)
        tok = assert_logits_close(got, w, f"paged decode step {i}")
        pos = pos + 1


def ref_slots(ref_model, ref_params, toks, max_len: int, steps: int = 2) -> list:
    """The reference's dense slot cache: an aligned prefill of every row,
    then ``steps`` greedy decode_slots at per-slot positions."""
    cache = ref_model.init_slot_cache(toks.shape[0], max_len)
    logits, cache = jax.jit(ref_model.prefill)(ref_params, {"tokens": jnp.asarray(toks)}, cache)
    out = [np.asarray(logits)]
    decode = jax.jit(ref_model.decode_slots)
    pos = jnp.full((toks.shape[0],), toks.shape[1], jnp.int32)
    for _ in range(steps):
        logits, cache = decode(ref_params, logits.argmax(-1), pos, cache)
        out.append(np.asarray(logits))
        pos = pos + 1
    return out


def check_slots(model, params, toks, max_len: int, want: list) -> None:
    cache = model.init_slot_cache(toks.shape[0], max_len)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache)
    tok = assert_logits_close(got, want[0], "slot prefill")
    pos = np.full((toks.shape[0],), toks.shape[1], np.int32)
    for i, w in enumerate(want[1:]):
        got, cache = model.decode_slots(params, tok, pos, cache)
        tok = assert_logits_close(got, w, f"slot decode step {i}")
        pos = pos + 1


def port_path_as_ref(path: str) -> tuple[str, int | None]:
    """A port parameter path as the reference's keystr and the layer it
    holds: 'stages.1.0.moe.router' -> ("['stages'][1]['moe']['router']",
    0); 'encoder.stages.0.1.attn.wq' -> ("['encoder']['stages'][0]...", 1);
    'shared_attn.attn.wq' -> ("['shared_attn']['attn']['wq']", None)."""
    parts, out, layer, i = path.split("."), [], None, 0
    while i < len(parts):
        if parts[i] == "stages":
            out.append(f"['stages'][{parts[i + 1]}]")
            i += 2
            if i < len(parts) and parts[i].isdigit():  # the layer: stacked in the reference
                layer = int(parts[i])
                i += 1
        else:
            out.append(f"['{parts[i]}']")
            i += 1
    return "".join(out), layer


def engine_tokens(model, params, prompts, new_tokens: int, **engine_kw) -> list:
    """Greedy tokens of ``prompts`` served together by one BatchingEngine."""
    from repro_torch.serve import BatchingEngine

    eng = BatchingEngine(model, params, **engine_kw)
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    res = eng.run()
    return [res[r].tokens for r in rids]


def check_batch_equals_alone(model, params, prompts, new_tokens: int, **engine_kw) -> None:
    """Each request served alone gives the tokens it gets in the batch."""
    batch = engine_tokens(model, params, prompts, new_tokens, **engine_kw)
    alone_kw = dict(engine_kw, max_slots=1)
    for i, p in enumerate(prompts):
        assert engine_tokens(model, params, [p], new_tokens, **alone_kw) == [batch[i]], i
