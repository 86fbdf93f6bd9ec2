"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP.
61L d_model=7168 128H d_ff=2048 (per-expert) vocab=129280
[arXiv:2412.19437; hf]. MLA ranks per the paper: q_lora 1536, kv_lora 512,
qk_rope 64, qk_nope 128, v 128; first 3 layers dense (d_ff 18432);
mtp_depth=1."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        num_layers=61, d_model=7168, vocab_size=129280,
        num_heads=128, num_kv_heads=128, head_dim=128,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        d_ff=18432, act="silu",
        num_experts=256, experts_per_token=8, num_shared_experts=1,
        moe_d_ff=2048, first_dense_layers=3,
        mtp_depth=1,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        num_layers=3, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=32,
        use_mla=True, q_lora_rank=64, kv_lora_rank=32,
        qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
        d_ff=256, act="silu",
        num_experts=8, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=64, first_dense_layers=1,
        mtp_depth=1,
        dtype="float32",
    )
