"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style, 64 experts top-6.
48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per-expert) vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]. Assumptions (DESIGN.md): first layer
dense (d_ff = 8x expert ff = 11264), one shared expert."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, vocab_size=163840,
        num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=11264, act="silu",
        num_experts=64, experts_per_token=6, num_shared_experts=1,
        moe_d_ff=1408, first_dense_layers=1,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        num_layers=3, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, act="silu",
        num_experts=8, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=64, first_dense_layers=1,
        dtype="float32",
    )
