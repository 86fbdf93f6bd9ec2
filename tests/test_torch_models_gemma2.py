"""repro_torch.models' gemma2 paths against repro.models on the same numpy
weights (the gemma2-27b smoke config: 4 layers alternating a 16-token
sliding window and global attention, attention and final logit softcaps,
post-norms, tied embeddings), under native f32: prefill + decode_step over
the aligned cache and the ragged paged prefill_slots + decode_slots, with
prompts longer than the window so that the local layers mask; logits to
LOGIT_RTOL of max|logit| with equal greedy tokens (the tolerance of the
other families, tests/_torch_families_parity.py)."""
import numpy as np
import pytest

from _torch_families_parity import check_aligned, check_paged, family_pair, ref_aligned, ref_paged
from _torch_models_parity import one_torch_thread  # noqa: F401

ARCH = "gemma2-27b"
#: 21 and 18 prompt tokens: past the smoke config's window of 16.
TOKS = np.random.default_rng(8).integers(1, 512, (2, 21))
LENGTHS = np.array([21, 18], np.int32)
BT = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
MAX_LEN = 24


@pytest.fixture(scope="module")
def runs():
    ref_model, ref_params, model, params = family_pair(ARCH)
    cfg = model.cfg
    assert cfg.attn_softcap and cfg.final_softcap and cfg.post_norms and cfg.tie_embeddings
    assert cfg.local_global_pattern and cfg.sliding_window < TOKS.shape[1]
    return {"model": model, "params": params,
            "aligned": ref_aligned(ref_model, ref_params, {"tokens": TOKS}, MAX_LEN),
            "paged": ref_paged(ref_model, ref_params, TOKS, LENGTHS, BT, 13, 4)}


def test_prefill_and_decode_step_aligned_cache(runs):
    check_aligned(runs["model"], runs["params"], {"tokens": TOKS}, MAX_LEN, runs["aligned"])


def test_paged_prefill_and_decode_slots(runs):
    """A ragged bucket over page pools: the window masks by position."""
    check_paged(runs["model"], runs["params"], TOKS, LENGTHS, BT, 13, 4, runs["paged"])
