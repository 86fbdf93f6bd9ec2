"""repro_torch.models against repro.models under ozaki2-fp8/fast, the
serving path's policy, on the qwen2-7b smoke config (2 layers) with the
same weights (drawn with numpy into the reference's shapes) and the same
cached weight plans: one ragged paged Model.prefill_slots and one
decode_slots step, logits to LOGIT_RTOL of max|logit| with equal greedy
tokens, on the kernel route's plain versions ('+pallas': K2's) and on
'+core'.

The reference compiles its prepared GEMMs at every shape, ~1.2 s each on
a CPU (15 a step), so each of its steps is computed once for the module;
its cached plans are the port's (held bitwise equal to its own
quantization by test_torch_serve.py), which saves its quantization
pass."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro_torch.serve import quantize_params

from _torch_families_parity import family_pair
from _torch_models_parity import (ARCH, assert_logits_close, one_torch_thread,  # noqa: F401
                                  ref_params_with_plans)

FAST = "ozaki2-fp8/fast"
TOKS = np.random.default_rng(6).integers(1, 512, (2, 8))
LENGTHS = np.array([8, 5], np.int32)
BT = np.array([[1, 2, 3], [4, 5, 6]], np.int32)


@pytest.fixture(scope="module")
def fast_runs():
    """The reference's prefill_slots and decode_slots logits, and the port's
    model with its prepared params."""
    ref_model, ref_params, model, params = family_pair(ARCH, gemm=FAST)
    serve_params = quantize_params(params, FAST)
    ref_serve = ref_params_with_plans(ref_params, serve_params)
    pool = ref_model.init_paged_cache(7, 4)
    pre, pool = ref_model.prefill_slots(ref_serve, jnp.asarray(TOKS), jnp.asarray(LENGTHS),
                                        jnp.asarray(BT), pool)
    tok = np.asarray(pre).argmax(-1)
    dec, _ = ref_model.decode_slots(ref_serve, jnp.asarray(tok), jnp.asarray(LENGTHS), pool,
                                    jnp.asarray(BT))
    return model, serve_params, np.asarray(pre), tok, np.asarray(dec)


@pytest.mark.parametrize("route", ["+pallas", "+core"])
def test_prefill_and_decode_slots_fast(fast_runs, route):
    import dataclasses

    from repro_torch.models import Model

    model, serve_params, pre, tok, dec = fast_runs
    model = Model(dataclasses.replace(model.cfg, gemm=FAST + route), device="cpu")
    pool = model.init_paged_cache(7, 4)
    got, pool = model.prefill_slots(serve_params, TOKS, LENGTHS, BT, pool)
    np.testing.assert_array_equal(assert_logits_close(got, pre, "prefill_slots"), tok)
    got, _ = model.decode_slots(serve_params, tok, LENGTHS, pool, BT)
    assert_logits_close(got, dec, "decode_slots")
