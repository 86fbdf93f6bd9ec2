"""Unified model configuration (the torch counterpart of
``repro/models/config.py``, field for field).

One frozen dataclass drives dense / MoE / SSM / hybrid / enc-dec / VLM /
audio families; ``repro_torch/configs/<arch>.py`` instantiate it with the
published hyperparameters (full) plus reduced smoke variants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.precision import PrecisionPolicy, coerce_policy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
    num_layers: int
    d_model: int
    vocab_size: int
    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    attn_softcap: Optional[float] = None  # gemma2 attention-logit softcap
    final_softcap: Optional[float] = None  # gemma2 output-logit softcap
    sliding_window: Optional[int] = None  # local layers' window
    local_global_pattern: bool = False  # gemma2: alternate local/global
    post_norms: bool = False  # gemma2: post-attention/post-mlp rmsnorms
    # context-parallel attention: constrain q/scores to shard the QUERY
    # position axis over "model" when heads don't divide the TP width
    # (softmax is row-local, so no score all-reduce). §Perf hillclimb B —
    # REFUTED: fwd-only constraints conflict with the bwd layout (see log).
    attn_context_parallel: bool = False
    # runtime head padding: broadcast KV to full MHA and zero-pad Q heads to
    # this count so the head axis divides TP; padded rows are sliced before
    # wo (exact). §Perf hillclimb B iteration 2.
    attn_head_pad_to: int = 0
    tie_embeddings: bool = False
    # ---- MLP ----
    d_ff: int = 0
    act: str = "silu"
    gated_mlp: bool = True  # SwiGLU/GeGLU; False = plain 2-matrix MLP
    # ---- MLA (deepseek-v3) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # ---- MoE ----
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    router_aux_weight: float = 0.001
    # dropless: exact per-token expert mixture (all-pairs einsum; E x compute)
    # — used for serving-equivalence validation and small-E configs. The
    # capacity path (default) matches train-time semantics; decode raises the
    # capacity factor 4x so dropping is negligible at s=1 (DESIGN.md).
    moe_dropless: bool = False
    # routing-group size in tokens (None = one sequence per group); capacity
    # and the dispatch one-hot are per-group — see moe.py / §Perf hillclimb 1
    moe_group_size: int | None = None
    # ---- SSM (mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4
    # ---- hybrid (zamba2): shared attention block cadence ----
    shared_attn_every: int = 0
    # ---- encoder-decoder (seamless-m4t) ----
    num_encoder_layers: int = 0
    # ---- multimodal frontend stubs ----
    frontend: Optional[str] = None  # "vit-stub" | "audio-stub"
    frontend_dim: int = 0
    frontend_len: int = 0
    # ---- deepseek multi-token prediction ----
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # ---- numerics ----
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    # Precision policy for every matmul: a PrecisionPolicy, a spec string
    # ("ozaki2-fp8/accurate@8", normalized at construction), or None — then
    # the precision context decides at call time (native by default).
    gemm: Optional[Union[PrecisionPolicy, str]] = None
    # ---- remat / scan ----
    remat: str = "none"  # "none" | "full" | "dots"
    scan_layers: bool = True

    def __post_init__(self):
        if self.gemm is not None and type(self.gemm) is not PrecisionPolicy:
            # normalize spec strings / legacy GemmConfig to the base policy
            object.__setattr__(self, "gemm", coerce_policy(self.gemm))

    # ---------- derived ----------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 128 multiple: TP shards the vocab axis over
        16 chips and the MXU wants 128 lanes — standard Megatron/MaxText
        practice. CE loss and sampling mask the padded tail."""
        return -(-self.vocab_size // 128) * 128

    @property
    def attention_kind(self) -> str:
        if self.use_mla:
            return "mla"
        return "gqa"

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_dense_layers if self.num_experts else 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D accounting."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            dil = self.d_inner
            per = (d * (2 * dil + 2 * self.ssm_heads)  # in_proj (x,z) + dt/bias-ish
                   + dil * (2 * self.ssm_state)  # B,C proj via x
                   + dil * self.conv_width + dil * d)
            return emb + self.num_layers * per
        attn = self._attn_params()
        mlp_dense = (3 if self.gated_mlp else 2) * d * self.d_ff
        if self.num_experts:
            moe = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts \
                + self.num_shared_experts * 3 * d * self.moe_d_ff
            dense_part = self.first_dense_layers * (attn + mlp_dense)
            moe_part = self.num_moe_layers * (attn + moe)
            return emb + dense_part + moe_part
        if self.family == "hybrid":
            dil = self.d_inner
            mamba_per = (d * 2 * dil + dil * (2 * self.ssm_state) + dil * self.conv_width
                         + dil * d + d * 2 * self.ssm_heads)
            n_shared = 1
            shared = attn + mlp_dense
            return emb + self.num_layers * mamba_per + n_shared * shared
        layers = self.num_layers + self.num_encoder_layers
        per = attn + mlp_dense
        if self.num_encoder_layers:  # cross-attention in decoder
            per_dec = attn * 2 + mlp_dense
            return emb + self.num_encoder_layers * per + self.num_layers * per_dec
        return emb + layers * per

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            rope, nope, v = self.qk_rope_dim, self.qk_nope_dim, self.v_head_dim
            h = self.num_heads
            q = d * self.q_lora_rank + self.q_lora_rank * h * (rope + nope) \
                if self.q_lora_rank else d * h * (rope + nope)
            kv = d * (self.kv_lora_rank + rope) + self.kv_lora_rank * h * (nope + v)
            o = h * v * d
            return q + kv + o
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D MODEL_FLOPS)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        mlp_dense = (3 if self.gated_mlp else 2) * d * self.d_ff
        active_moe = (self.experts_per_token + self.num_shared_experts) * 3 * d * self.moe_d_ff \
            + d * self.num_experts
        return (emb + self.first_dense_layers * (attn + mlp_dense)
                + self.num_moe_layers * (attn + active_moe))


def validate(cfg: ModelConfig) -> None:
    if cfg.family in ("dense", "moe", "encdec", "vlm"):
        assert cfg.num_heads > 0 and cfg.head_dim > 0
        if not cfg.use_mla:
            assert cfg.num_heads % max(cfg.num_kv_heads, 1) == 0
    if cfg.family in ("ssm", "hybrid"):
        assert cfg.ssm_state > 0 and cfg.d_inner % cfg.ssm_head_dim == 0
    if cfg.num_experts:
        assert 0 < cfg.experts_per_token <= cfg.num_experts
    if cfg.local_global_pattern:
        assert cfg.sliding_window
