"""qwen2-7b [dense]: GQA with QKV bias. 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064 [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, vocab_size=152064,
        num_heads=28, num_kv_heads=4, head_dim=128,
        d_ff=18944, act="silu", qkv_bias=True, rope_theta=1e6,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke", family="dense",
        num_layers=2, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, act="silu", qkv_bias=True, rope_theta=1e6,
        dtype="float32",
    )
