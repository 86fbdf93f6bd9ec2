"""repro_torch.models' codeqwen1.5-7b paths against repro.models on the same
numpy weights (the smoke config: 2 dense layers, QKV bias, as many KV heads
as query heads, rope_theta 1e6), under native f32: prefill + decode_step
over the aligned cache and the ragged paged prefill_slots + decode_slots;
logits to LOGIT_RTOL of max|logit| with equal greedy tokens (the tolerance
of the other families, tests/_torch_families_parity.py)."""
import numpy as np
import pytest

from _torch_families_parity import check_aligned, check_paged, family_pair, ref_aligned, ref_paged
from _torch_models_parity import one_torch_thread  # noqa: F401

ARCH = "codeqwen1.5-7b"
#: 13 and 9 prompt tokens: a ragged paged bucket.
TOKS = np.random.default_rng(9).integers(1, 512, (2, 13))
LENGTHS = np.array([13, 9], np.int32)
BT = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
MAX_LEN = 16


@pytest.fixture(scope="module")
def runs():
    ref_model, ref_params, model, params = family_pair(ARCH)
    cfg = model.cfg
    assert cfg.qkv_bias and cfg.num_kv_heads == cfg.num_heads and cfg.rope_theta == 1e6
    return {"model": model, "params": params,
            "aligned": ref_aligned(ref_model, ref_params, {"tokens": TOKS}, MAX_LEN),
            "paged": ref_paged(ref_model, ref_params, TOKS, LENGTHS, BT, 9, 4)}


def test_prefill_and_decode_step_aligned_cache(runs):
    check_aligned(runs["model"], runs["params"], {"tokens": TOKS}, MAX_LEN, runs["aligned"])


def test_paged_prefill_and_decode_slots(runs):
    """A ragged bucket over page pools, the rows at different positions."""
    check_paged(runs["model"], runs["params"], TOKS, LENGTHS, BT, 9, 4, runs["paged"])
