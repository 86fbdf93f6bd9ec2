"""Mixture-of-Experts (the torch counterpart of ``repro/models/moe.py``):
top-k routing with capacity-based dense dispatch, shared experts
(deepseek-v3 / moonlight) and a switch-style load-balance auxiliary loss.

Expert weights are stacked (E, d, ff). As in the reference, only the router
and the shared expert go through ``layers.matmul`` (the emulated GEMM); the
routed experts are plain ``torch.einsum`` products in the compute dtype,
and the serve weight cache leaves their 3-D stacks alone.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, activation, dense_init, frozen, matmul, mlp_apply, mlp_init, randn


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class MoE(nn.Module):
    """``router`` (d, E) f32, the expert stacks ``w_gate``/``w_up`` (E, d, ff)
    and ``w_down`` (E, ff, d), and with shared experts ``shared`` (an MLP)."""

    def __init__(self, router, w_gate, w_up, w_down, shared: MLP | None = None):
        super().__init__()
        self.router = frozen(router)
        self.w_gate, self.w_up, self.w_down = (frozen(w) for w in (w_gate, w_up, w_down))
        if shared is not None:
            self.shared = shared


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> MoE:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def stack(shape, scale):
        return (randn(gen, shape) * scale).to(dtype)

    shared = (mlp_init(gen, d, cfg.moe_d_ff * cfg.num_shared_experts, dtype)
              if cfg.num_shared_experts else None)
    return MoE(dense_init(gen, d, e, torch.float32, scale=0.02),
               stack((e, d, ff), d ** -0.5), stack((e, d, ff), d ** -0.5),
               stack((e, ff, d), ff ** -0.5), shared)


def capacity(tokens: int, cfg: ModelConfig, factor: float = 1.25) -> int:
    c = math.ceil(tokens * cfg.experts_per_token * factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for clean tiling


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, descending, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = matmul(xt.to(torch.float32), p.router, cfg.gemm, out_dtype=torch.float32)
    return torch.softmax(logits, dim=-1)


def moe_apply_dropless(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> MoEOutput:
    """Exact (no-drop) mixture: every expert evaluates every token and the
    top-k outputs are gathered — E x the FLOPs, independent of routing. Used
    for serving-equivalence validation and small expert counts."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(b * s, d)
    probs = _router_probs(p, xt, cfg)
    top_w, top_idx = top_k(probs, k)
    top_w = (top_w / torch.sum(top_w, dim=-1, keepdim=True)).to(x.dtype)

    g = torch.einsum("td,edf->tef", xt, p.w_gate.to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, p.w_up.to(x.dtype))
    h = activation(g, cfg.act) * u
    out = torch.einsum("tef,efd->ted", h, p.w_down.to(x.dtype))  # (t,e,d)
    sel = torch.take_along_dim(out, top_idx[:, :, None], dim=1)  # (t,k,d)
    y = torch.sum(sel * top_w[:, :, None], dim=1)

    density = torch.mean(F.one_hot(top_idx, e).to(torch.float32).sum(1), dim=0)
    aux = torch.sum(density * torch.mean(probs, dim=0)) * e * cfg.router_aux_weight
    if cfg.num_shared_experts:
        y = y + mlp_apply(p.shared, xt, cfg.act, cfg.gemm)
    return MoEOutput(y.reshape(b, s, d), aux.to(torch.float32))


def dispatch(probs: torch.Tensor, k: int, cap: int):
    """Grouped top-k dispatch of router probabilities ``probs`` (ng, g, e):
    (top_w, top_idx, pos, keep), each (ng, g, k). ``pos`` is the token's
    place in its expert's queue (the exclusive cumulative count over the
    group's (token, choice) pairs in order) and ``keep`` is ``pos < cap``."""
    ng, gsz, e = probs.shape
    top_w, top_idx = top_k(probs, k)  # (ng, g, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    flat_sel = F.one_hot(top_idx, e).reshape(ng, gsz * k, e)
    pos_in_e = torch.cumsum(flat_sel, dim=1) - flat_sel  # exclusive
    pos = torch.sum(pos_in_e * flat_sel, dim=-1).reshape(ng, gsz, k)
    return top_w, top_idx, pos, pos < cap


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> MoEOutput:
    """Capacity-based dispatch, GROUPED: routing and capacity are computed
    per token group (``moe_group_size`` tokens, default one sequence), so
    the dispatch one-hot is (groups, g, e, cap) with cap = O(g·k/e)."""
    if cfg.moe_dropless:
        return moe_apply_dropless(p, x, cfg)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    gsz = min(cfg.moe_group_size or s, s)
    assert s % gsz == 0, (s, gsz)
    ng = b * (s // gsz)
    xt = x.reshape(ng, gsz, d)
    # decode (s=1): raise the capacity factor so dropping is negligible
    cap = capacity(gsz, cfg, factor=4.0 if s == 1 else 1.25)

    probs = _router_probs(p, xt, cfg)  # (ng, g, e)
    top_w, top_idx, pos, keep = dispatch(probs, k, cap)

    # dispatch tensor (ng, g, k, e, cap): weighted one-hot
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    disp = (F.one_hot(top_idx, e).to(x.dtype)[..., None]
            * F.one_hot(slot, cap + 1).to(x.dtype)[..., None, :cap])
    disp_sum = torch.sum(disp, dim=2)  # (ng, g, e, cap) 0/1
    comb = torch.sum(disp * top_w.to(x.dtype)[..., None, None], dim=2)

    expert_in = torch.einsum("ngec,ngd->necd", disp_sum, xt)
    g_ = torch.einsum("necd,edf->necf", expert_in, p.w_gate.to(x.dtype))
    u = torch.einsum("necd,edf->necf", expert_in, p.w_up.to(x.dtype))
    h = activation(g_, cfg.act) * u
    expert_out = torch.einsum("necf,efd->necd", h, p.w_down.to(x.dtype))
    y = torch.einsum("ngec,necd->ngd", comb, expert_out)

    # switch-style load-balance loss
    density = torch.mean(F.one_hot(top_idx, e).to(torch.float32).sum(2), dim=(0, 1))  # (e,)
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = torch.sum(density * mean_prob) * e * cfg.router_aux_weight

    if cfg.num_shared_experts:
        y = y + mlp_apply(p.shared, xt.reshape(b * s, d), cfg.act,
                          cfg.gemm).reshape(ng, gsz, d)
    return MoEOutput(y.reshape(b, s, d), aux.to(torch.float32))
