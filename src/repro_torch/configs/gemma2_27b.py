"""gemma2-27b [dense]: alternating local(4096)/global attention, attention
and final logit softcaps, post-norms, tied embeddings. 46L d_model=4608 32H
(GQA kv=16) d_ff=36864 vocab=256000 [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        num_layers=46, d_model=4608, vocab_size=256000,
        num_heads=32, num_kv_heads=16, head_dim=128,
        d_ff=36864, act="gelu",
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096, local_global_pattern=True,
        post_norms=True, tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke", family="dense",
        num_layers=4, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, act="gelu",
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=16, local_global_pattern=True,
        post_norms=True, tie_embeddings=True,
        dtype="float32",
    )
