"""starcoder2-15b [dense]: GQA + RoPE. 40L d_model=6144 48H (GQA kv=4)
d_ff=24576 vocab=49152 [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, vocab_size=49152,
        num_heads=48, num_kv_heads=4, head_dim=128,
        d_ff=24576, act="gelu", qkv_bias=True, rope_theta=1e5,
        gated_mlp=False,  # plain c_fc/c_proj MLP (starcoder2)
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense",
        num_layers=2, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, act="gelu", qkv_bias=True, rope_theta=1e5,
        gated_mlp=False,
        dtype="float32",
    )
