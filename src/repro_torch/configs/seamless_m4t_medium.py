"""seamless-m4t-medium [audio]: encoder-decoder, multimodal. 12L(+12L dec)
d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].
The audio frontend is a STUB (precomputed frame embeddings); positions use
RoPE instead of learned/sinusoidal embeddings (DESIGN.md assumption table)."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        num_layers=12, num_encoder_layers=12,
        d_model=1024, vocab_size=256206,
        num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, act="relu", gated_mlp=False,
        frontend="audio-stub", frontend_dim=1024, frontend_len=0,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        num_layers=2, num_encoder_layers=2,
        d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, act="relu", gated_mlp=False,
        frontend="audio-stub", frontend_dim=64, frontend_len=0,
        dtype="float32",
    )
