"""Interchange with the reference's parameters: ``params_from_reference``
loads the params pytree of the JAX package's ``Model.init`` (its leaves as
numpy arrays; a stage's leaves stacked on a leading layer axis, MoE expert
stacks as (layers, E, d, ff)) onto the port's module tree, layer i of a
stage from slice i, so both packages compute the same function from the
same weights."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from .attention import GQAAttention, MLAAttention
from .blocks import Block, MambaBlock
from .layers import MLP
from .model import MTP, CausalLM, Encoder, Model
from .moe import MoE
from .ssm import Mamba2

_MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm", "out_proj")


def _mlp(d: dict, leaf: Callable) -> MLP:
    return MLP(leaf(d["w_up"]), leaf(d["w_down"]),
               leaf(d["w_gate"]) if "w_gate" in d else None)


def _attention(d: dict, leaf: Callable) -> nn.Module:
    if "w_dkv" in d:
        opt = {k: leaf(d[k]) for k in ("w_dq", "w_uq", "w_q") if k in d}
        return MLAAttention(*(leaf(d[k]) for k in ("w_dkv", "w_uk", "w_uv", "wo")), **opt)
    biases = tuple(leaf(d[k]) for k in ("bq", "bk", "bv")) if "bq" in d else ()
    return GQAAttention(*(leaf(d[k]) for k in ("wq", "wk", "wv", "wo")), *biases)


def _block(d: dict, leaf: Callable) -> nn.Module:
    """One block from the reference leaves ``d``, each read through
    ``leaf`` (a layer's slice of a stacked stage, or the leaf itself)."""
    if "mixer" in d:
        return MambaBlock(leaf(d["norm"]), Mamba2(*(leaf(d["mixer"][k]) for k in _MAMBA)))
    ffn = {}
    if "moe" in d:
        m = d["moe"]
        ffn["moe"] = MoE(*(leaf(m[k]) for k in ("router", "w_gate", "w_up", "w_down")),
                         _mlp(m["shared"], leaf) if "shared" in m else None)
    else:
        ffn["mlp"] = _mlp(d["mlp"], leaf)
    opt = {k: leaf(d[k]) for k in ("attn_post_norm", "mlp_post_norm", "cross_norm") if k in d}
    if "cross_attn" in d:
        opt["cross_attn"] = _attention(d["cross_attn"], leaf)
    return Block(leaf(d["attn_norm"]), _attention(d["attn"], leaf), leaf(d["mlp_norm"]),
                 **ffn, **opt)


def params_from_reference(model: Model, tree: dict) -> CausalLM:
    """The ``CausalLM`` of ``model`` (on its device) holding the reference
    params ``tree``: {"embed", "stages": (stage dicts of stacked leaves,
    {} for a zamba2 shared-block entry), "final_norm", ["lm_head"],
    ["shared_attn"], ["frontend_proj"], ["encoder"], ["mtp"]}."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(model.device)

    def stage(sp: dict, num_layers: int) -> nn.ModuleList:
        return nn.ModuleList(_block(sp, lambda a, i=i: t(a[i])) for i in range(num_layers))

    stages = nn.ModuleList(nn.ModuleList() if e.spec.shared_attn else
                           stage(sp, e.spec.num_layers)
                           for e, sp in zip(model.stages, tree["stages"]))
    extra = {}
    if "shared_attn" in tree:
        extra["shared_attn"] = _block(tree["shared_attn"], t)
    if "frontend_proj" in tree:
        extra["frontend_proj"] = t(tree["frontend_proj"])
    if "encoder" in tree:
        enc = tree["encoder"]
        extra["encoder"] = Encoder(
            nn.ModuleList([stage(enc["stages"][0], model.cfg.num_encoder_layers)]),
            t(enc["final_norm"]))
    if "mtp" in tree:
        m = tree["mtp"]
        extra["mtp"] = MTP(t(m["proj"]), _block(m["block"], t), t(m["norm_h"]), t(m["norm_e"]))
    return CausalLM(t(tree["embed"]), stages, t(tree["final_norm"]),
                    t(tree["lm_head"]) if "lm_head" in tree else None, **extra)
