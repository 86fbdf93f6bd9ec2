"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block applied at
intervals. 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64 [arXiv:2411.15242; hf]. Simplification (DESIGN.md): the shared
transformer block is reused verbatim (no per-invocation LoRA specialisation)
every 6 Mamba2 layers."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, vocab_size=32000,
        num_heads=32, num_kv_heads=32, head_dim=64,
        d_ff=8192, act="gelu",
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
        shared_attn_every=6,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        num_layers=5, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, act="gelu",
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
        shared_attn_every=2,
        dtype="float32",
    )
