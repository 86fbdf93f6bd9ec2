"""internvl2-26b [vlm]: InternViT frontend (stub) + InternLM2-20B-style
backbone. 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]. The modality frontend is a STUB per the assignment:
input_specs provides precomputed patch embeddings (InternViT-6B hidden 3200)
projected into the LM width."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, vocab_size=92553,
        num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=16384, act="silu", rope_theta=1e6,
        frontend="vit-stub", frontend_dim=3200, frontend_len=256,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", family="vlm",
        num_layers=2, d_model=128, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, act="silu", rope_theta=1e6,
        frontend="vit-stub", frontend_dim=64, frontend_len=8,
        dtype="float32",
    )
