"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.
64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
        tie_embeddings=True,
        remat="full",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        num_layers=3, d_model=128, vocab_size=512,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
        tie_embeddings=True,
        dtype="float32",
    )
