"""Layer blocks and stage application (the torch counterpart of
``repro/models/blocks.py``).

A model is a sequence of *stages*, each a homogeneous stack of blocks. The
reference stacks a stage's parameters on a leading layer axis and scans
over it; here a stage is an ``nn.ModuleList`` of per-layer blocks and
``stage_apply`` is a Python loop over them, with one cache dict per layer.
Per-layer heterogeneity inside a stage (gemma2's local/global alternation)
comes from the per-layer window list of ``stage_windows``.

Block kinds: ``"attn_mlp"`` is ported; ``"attn_moe"``, ``"mamba"``,
``"encoder"`` and ``"decoder_cross"`` raise (ROADMAP Queue A item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .attention import AttnTemporal, apply_attention, init_attention
from .config import ModelConfig
from .layers import MLP, frozen, mlp_apply, mlp_init, rmsnorm, zeros

GLOBAL_WINDOW = 2 ** 30  # "no sliding window" sentinel


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str
    num_layers: int
    scan: bool = True
    shared_attn: bool = False  # zamba2: shared attention block after each layer-group


def _check_kind(kind: str) -> None:
    if kind != "attn_mlp":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported to repro_torch yet (MoE, SSM, "
            "hybrid and encoder-decoder blocks: ROADMAP Queue A item 5)")


class Block(nn.Module):
    """Pre-norm attention + MLP block (``attn_norm``, ``attn``,
    ``mlp_norm``, ``mlp``; gemma2's ``attn_post_norm``/``mlp_post_norm``)."""

    def __init__(self, attn_norm, attn: nn.Module, mlp_norm, mlp: MLP,
                 attn_post_norm=None, mlp_post_norm=None):
        super().__init__()
        self.attn_norm = frozen(attn_norm)
        self.attn = attn
        self.mlp_norm = frozen(mlp_norm)
        self.mlp = mlp
        if attn_post_norm is not None:
            self.attn_post_norm = frozen(attn_post_norm)
            self.mlp_post_norm = frozen(mlp_post_norm)

    def forward(self, x, cfg: ModelConfig, t: AttnTemporal, window, cache: dict):
        return block_apply(self, x, cfg, t, window, cache, "attn_mlp")


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype) -> Block:
    _check_kind(kind)
    d, dev = cfg.d_model, gen.device
    attn = init_attention(gen, cfg, dtype)
    mlp = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp)
    post = (zeros(d, dtype, dev), zeros(d, dtype, dev)) if cfg.post_norms else ()
    return Block(zeros(d, dtype, dev), attn, zeros(d, dtype, dev), mlp, *post)


def block_apply(p: Block, x: torch.Tensor, cfg: ModelConfig, t: AttnTemporal,
                window, cache: dict, kind: str):
    """Returns (x, new_cache, aux_loss). ``cache`` is {} when not serving;
    ``aux_loss`` is 0 (it is the MoE router's in the reference)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    attn_cache = {k: cache[k] for k in ("k", "v") if k in cache} or None
    h, new_attn_cache = apply_attention(
        p.attn, rmsnorm(x, p.attn_norm, eps), cfg, t, window, attn_cache)
    if cfg.post_norms:
        h = rmsnorm(h, p.attn_post_norm, eps)
    x = x + h
    h = mlp_apply(p.mlp, rmsnorm(x, p.mlp_norm, eps), cfg.act, cfg.gemm)
    if cfg.post_norms:
        h = rmsnorm(h, p.mlp_post_norm, eps)
    x = x + h
    return x, (new_attn_cache or {}), 0.0


def stage_apply(stage_params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                t: AttnTemporal, windows: list, stage_cache: Optional[list],
                kind: str):
    """Apply a stack of blocks layer by layer; ``stage_cache`` is one dict
    per layer (None for training). Returns (x, new_stage_cache, aux)."""
    aux = 0.0
    new_caches = []
    for i, lp in enumerate(stage_params):
        x, co, a = block_apply(lp, x, cfg, t, windows[i],
                               stage_cache[i] if stage_cache else {}, kind)
        aux += a
        new_caches.append(co)
    return x, (new_caches if stage_cache else []), aux


def stage_init(gen: torch.Generator, cfg: ModelConfig, spec: StageSpec, dtype) -> nn.ModuleList:
    """Per-layer parameters of a stage, drawn layer after layer."""
    return nn.ModuleList(block_init(gen, cfg, spec.kind, dtype) for _ in range(spec.num_layers))


def stage_windows(cfg: ModelConfig, spec: StageSpec, stage_offset: int) -> list:
    """Per-layer sliding windows (gemma2 alternation is layer-index driven)."""
    idx = range(stage_offset, stage_offset + spec.num_layers)
    if cfg.local_global_pattern and spec.kind.startswith("attn"):
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW for i in idx]
    if cfg.sliding_window and not cfg.local_global_pattern:
        return [cfg.sliding_window] * spec.num_layers
    return [GLOBAL_WINDOW] * spec.num_layers
