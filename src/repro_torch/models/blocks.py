"""Layer blocks and stage application (the torch counterpart of
``repro/models/blocks.py``).

A model is a sequence of *stages*, each a homogeneous stack of blocks. The
reference stacks a stage's parameters on a leading layer axis and scans
over it; here a stage is an ``nn.ModuleList`` of per-layer blocks and
``stage_apply`` is a Python loop over them, with one cache dict per layer.
Per-layer heterogeneity inside a stage (gemma2's local/global alternation)
comes from the per-layer window list of ``stage_windows``; structural
heterogeneity (deepseek's dense prefix, zamba2's shared attention cadence)
becomes separate stages.

Block kinds: "attn_mlp", "attn_moe", "mamba", "encoder", "decoder_cross".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .attention import AttnTemporal, apply_attention, init_attention
from .config import ModelConfig
from .layers import MLP, frozen, mlp_apply, mlp_init, rmsnorm, zeros
from .moe import MoE, moe_apply, moe_init
from .ssm import Mamba2, SSMState, mamba2_apply, mamba2_init

GLOBAL_WINDOW = 2 ** 30  # "no sliding window" sentinel


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str
    num_layers: int
    scan: bool = True
    shared_attn: bool = False  # zamba2: shared attention block after each layer-group


class Block(nn.Module):
    """Pre-norm attention block: ``attn_norm``, ``attn``, ``mlp_norm`` and
    either ``mlp`` or (``attn_moe``) ``moe``; gemma2's ``attn_post_norm``/
    ``mlp_post_norm``; ``decoder_cross``'s ``cross_norm``/``cross_attn``."""

    def __init__(self, attn_norm, attn: nn.Module, mlp_norm, mlp: MLP | None = None,
                 moe: MoE | None = None, attn_post_norm=None, mlp_post_norm=None,
                 cross_norm=None, cross_attn: nn.Module | None = None):
        super().__init__()
        self.attn_norm = frozen(attn_norm)
        self.attn = attn
        self.mlp_norm = frozen(mlp_norm)
        if moe is not None:
            self.moe = moe
        else:
            self.mlp = mlp
        if attn_post_norm is not None:
            self.attn_post_norm = frozen(attn_post_norm)
            self.mlp_post_norm = frozen(mlp_post_norm)
        if cross_attn is not None:
            self.cross_norm = frozen(cross_norm)
            self.cross_attn = cross_attn


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 block: ``norm`` and ``mixer``."""

    def __init__(self, norm, mixer: Mamba2):
        super().__init__()
        self.norm = frozen(norm)
        self.mixer = mixer


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype) -> nn.Module:
    d, dev = cfg.d_model, gen.device
    if kind == "mamba":
        return MambaBlock(zeros(d, dtype, dev), mamba2_init(gen, cfg, dtype))
    attn = init_attention(gen, cfg, dtype)
    ffn = ({"moe": moe_init(gen, cfg, dtype)} if kind == "attn_moe" else
           {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp)})
    extra = {}
    if cfg.post_norms:
        extra = {"attn_post_norm": zeros(d, dtype, dev), "mlp_post_norm": zeros(d, dtype, dev)}
    if kind == "decoder_cross":
        extra.update(cross_norm=zeros(d, dtype, dev), cross_attn=init_attention(gen, cfg, dtype))
    return Block(zeros(d, dtype, dev), attn, zeros(d, dtype, dev), **ffn, **extra)


def block_apply(p: nn.Module, x: torch.Tensor, cfg: ModelConfig, t: AttnTemporal,
                window, cache: dict, kind: str,
                enc_memory: Optional[torch.Tensor] = None):
    """Returns (x, new_cache, aux_loss). ``cache`` is {} when not serving."""
    aux = 0.0
    eps = cfg.norm_eps

    if kind == "mamba":
        state = SSMState(cache["conv"], cache["ssd"]) if cache else None
        h, new_state = mamba2_apply(p.mixer, rmsnorm(x, p.norm, eps), cfg, state)
        new_cache = {"conv": new_state.conv, "ssd": new_state.ssd} if cache else {}
        return x + h, new_cache, aux

    attn_cache = {k: cache[k] for k in ("k", "v", "ckv", "krope") if k in cache} or None
    h, new_attn_cache = apply_attention(
        p.attn, rmsnorm(x, p.attn_norm, eps), cfg, t, window, attn_cache)
    if cfg.post_norms:
        h = rmsnorm(h, p.attn_post_norm, eps)
    x = x + h

    if kind == "decoder_cross":
        h, _ = apply_attention(p.cross_attn, rmsnorm(x, p.cross_norm, eps),
                               cfg, t, None, None, cross_kv=enc_memory)
        x = x + h

    if kind == "attn_moe":
        out = moe_apply(p.moe, rmsnorm(x, p.mlp_norm, eps), cfg)
        h, aux = out.y, out.aux_loss
    else:
        h = mlp_apply(p.mlp, rmsnorm(x, p.mlp_norm, eps), cfg.act, cfg.gemm)
    if cfg.post_norms:
        h = rmsnorm(h, p.mlp_post_norm, eps)
    x = x + h
    return x, (new_attn_cache or {}), aux


def stage_apply(stage_params: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                t: AttnTemporal, windows: list, stage_cache: Optional[list],
                kind: str, shared_attn_params: Optional[Block] = None,
                enc_memory: Optional[torch.Tensor] = None):
    """Apply a stack of blocks layer by layer; ``stage_cache`` is one dict
    per layer (None when not serving). With ``shared_attn_params`` (zamba2)
    the shared block is woven in after each layer, its cache under the
    layer's ``"shared"``. Returns (x, new_stage_cache, aux)."""
    aux = 0.0
    new_caches = []
    for i, lp in enumerate(stage_params):
        cache_l = stage_cache[i] if stage_cache else {}
        x, co, a = block_apply(lp, x, cfg, t, windows[i], cache_l, kind, enc_memory)
        if shared_attn_params is not None:
            x, c_sh, a2 = block_apply(shared_attn_params, x, cfg, t, GLOBAL_WINDOW,
                                      cache_l.get("shared", {}), "attn_mlp")
            if cache_l:
                co = dict(co, shared=c_sh)
            a = a + a2
        aux += a
        new_caches.append(co)
    return x, (new_caches if stage_cache else []), aux


def stage_init(gen: torch.Generator, cfg: ModelConfig, spec: StageSpec, dtype) -> nn.ModuleList:
    """Per-layer parameters of a stage, drawn layer after layer; a zamba2
    shared-block entry holds none (the block is the model's
    ``shared_attn``)."""
    if spec.shared_attn:
        return nn.ModuleList()
    return nn.ModuleList(block_init(gen, cfg, spec.kind, dtype) for _ in range(spec.num_layers))


def stage_windows(cfg: ModelConfig, spec: StageSpec, stage_offset: int) -> list:
    """Per-layer sliding windows (gemma2 alternation is layer-index driven)."""
    idx = range(stage_offset, stage_offset + spec.num_layers)
    if cfg.local_global_pattern and spec.kind.startswith("attn"):
        return [cfg.sliding_window if i % 2 == 0 else GLOBAL_WINDOW for i in idx]
    if cfg.sliding_window and not cfg.local_global_pattern:
        return [cfg.sliding_window] * spec.num_layers
    return [GLOBAL_WINDOW] * spec.num_layers
