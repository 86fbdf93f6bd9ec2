"""AdamW with optional 8-bit moments, global-norm clipping and a
warmup-cosine schedule (the torch counterpart of ``repro/optim/adamw.py``,
with its formula; not ``torch.optim.AdamW``, which applies the decay in
another order and rounds differently).

The trees are ordered dicts of tensors, name -> leaf, in the reference's
leaf order (``models.convert.reference_leaves``): the gradient norm sums
the leaves in that order. ``update`` works leaf by leaf, in place, so its
temporaries are one leaf's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import quantized


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    eightbit: bool = False  # quantize m (int8) and v (uint8) blockwise


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    m: dict
    v: dict


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, params: dict) -> OptState:
    """Zero moments for the leaves of ``params``, f32 or (``eightbit``) Q8."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.eightbit:
        m = {k: quantized.quantize(zeros(p)) for k, p in params.items()}
        v = {k: quantized.quantize(zeros(p), signed=False) for k, p in params.items()}
    else:
        m = {k: zeros(p) for k, p in params.items()}
        v = {k: zeros(p) for k, p in params.items()}
    step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    return OptState(step, m, v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, in leaf order
    (``tree`` a name -> leaf dict, or the leaves in order). A leaf is
    summed in row-major order whatever its strides (a sum runs in memory
    order), so a leaf gathered from blocks gives the bits of the leaf that
    autograd accumulated whole (``models.tensor_parallel``, Layout)."""
    total = None
    for g in tree.values() if isinstance(tree, dict) else tree:
        sq = torch.sum(torch.square(g.to(torch.float32).contiguous()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor):
    """(lr, clip, bc1, bc2) of the step counted to ``step``, with the
    gradient's global norm ``gnorm``."""
    lr = schedule(cfg, step)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    return lr, clip, 1 - torch.pow(cfg.b1, stepf), 1 - torch.pow(cfg.b2, stepf)


def leaf_update(cfg: AdamWConfig, p: torch.Tensor, m, v, g: torch.Tensor, scalars) -> None:
    """One leaf's AdamW update, in place: ``p`` and its moments ``m``, ``v``
    (f32 tensors, or Q8) from its gradient ``g``. Elementwise but for Q8's
    blocks, so a block of a leaf takes the bits the whole leaf would."""
    lr, clip, bc1, bc2 = scalars
    g = g.to(torch.float32) * clip
    q8 = isinstance(m, quantized.Q8)
    m_new = cfg.b1 * (quantized.dequantize(m) if q8 else m) + (1 - cfg.b1) * g
    v_new = (cfg.b2 * (quantized.dequantize(v, signed=False) if q8 else v)
             + (1 - cfg.b2) * g * g)
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    if p.dtype in (torch.float32, torch.float64, torch.bfloat16):
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    p.copy_(p.to(torch.float32) - lr * upd)
    if q8:
        for dst, src in ((m, quantized.quantize(m_new)),
                         (v, quantized.quantize(v_new, signed=False))):
            dst.q.copy_(src.q)
            dst.scale.copy_(src.scale)
    else:
        m.copy_(m_new)
        v.copy_(v_new)


def update(cfg: AdamWConfig, grads: dict, state: OptState, params: dict):
    """One AdamW step: ``params`` and the moments of ``state`` are updated
    in place and the step counted. Returns (params, state, {"grad_norm",
    "lr"})."""
    with torch.no_grad():
        state.step.add_(1)
        gnorm = global_norm(grads)
        scalars = step_scalars(cfg, state.step, gnorm)
        for k, g in grads.items():
            leaf_update(cfg, params[k], state.m[k], state.v[k], g, scalars)
    return params, state, {"grad_norm": gnorm, "lr": scalars[0]}
