"""codeqwen1.5-7b [dense]: qwen1.5 architecture (MHA-equivalent GQA kv=32,
QKV bias). 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, vocab_size=92416,
        num_heads=32, num_kv_heads=32, head_dim=128,
        d_ff=13440, act="silu", qkv_bias=True, rope_theta=1e6,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        num_layers=2, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, act="silu", qkv_bias=True, rope_theta=1e6,
        dtype="float32",
    )
