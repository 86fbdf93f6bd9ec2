"""Interchange with the reference's parameters: ``params_from_reference``
loads the params pytree of the JAX package's ``Model.init`` (its leaves as
numpy arrays; a stage's leaves stacked on a leading layer axis, MoE expert
stacks as (layers, E, d, ff)) onto the port's module tree, layer i of a
stage from slice i, so both packages compute the same function from the
same weights; ``train_state_from_reference`` carries a whole training
state across. ``reference_leaves`` lists the port's leaves in the order
JAX flattens the reference's params (dict keys sorted, a stage's layers
together), the order the optimizer sums the gradient norm in."""
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


def reference_path(name: str) -> tuple[tuple, int | None]:
    """A port parameter name as the reference's path and the layer it holds
    in a stacked stage leaf: 'stages.1.0.moe.router' -> (("stages", 1,
    "moe", "router"), 0); 'shared_attn.attn.wq' -> (("shared_attn", "attn",
    "wq"), None)."""
    parts, path, layer, i = name.split("."), [], None, 0
    while i < len(parts):
        if parts[i] == "stages":
            path += ["stages", int(parts[i + 1])]
            layer, i = int(parts[i + 2]), i + 3
        else:
            path.append(parts[i])
            i += 1
    return tuple(path), layer


def reference_leaves(params: nn.Module) -> dict:
    """The parameters of ``params``, name -> tensor, in the reference's leaf
    order."""
    def key(item):
        path, layer = reference_path(item[0])
        return path, -1 if layer is None else layer

    return dict(sorted(params.named_parameters(), key=key))


def _q8_leaf(q, layer: int | None, signed: bool, device):
    """The port's Q8 of one leaf from the reference's Q8 ``q`` (numpy
    children) of the leaf or, with ``layer``, of its stacked stage leaf:
    the reference's blocks where they hold this layer alone, else the
    layer's dequantized values quantized again."""
    from repro_torch.optim import BLOCK, Q8, quantize

    qq, scale, shape = np.asarray(q.q), np.asarray(q.scale), tuple(q.shape)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    if layer is None:
        return Q8(t(qq), t(scale), shape)
    n = int(np.prod(shape[1:]))
    if n % BLOCK == 0:
        nb = n // BLOCK
        return Q8(t(qq[layer * n:(layer + 1) * n]), t(scale[layer * nb:(layer + 1) * nb]),
                  shape[1:])
    denom = np.float32(127.0 if signed else 255.0)
    flat = (qq.reshape(-1, BLOCK).astype(np.float32) * (scale[:, None] / denom)).reshape(-1)
    return quantize(t(flat[:int(np.prod(shape))].reshape(shape)[layer]), signed=signed)


def train_state_from_reference(model: Model, ref_state):
    """The port's ``train.TrainState`` holding the reference's TrainState
    ``ref_state`` (numpy leaves): its params (``params_from_reference``,
    made trainable), step, and m and v leaf for leaf (f32, or Q8)."""
    from repro_torch.optim import OptState
    from repro_torch.train.step import TrainState

    params = params_from_reference(model, ref_state.params).requires_grad_(True)
    dev = model.device

    def moment(tree, name: str, signed: bool):
        path, layer = reference_path(name)
        for k in path:
            tree = tree[k]
        if hasattr(tree, "scale"):
            return _q8_leaf(tree, layer, signed, dev)
        arr = np.asarray(tree)
        return torch.from_numpy(np.array(arr if layer is None else arr[layer])).to(dev)

    names = list(reference_leaves(params))
    opt = ref_state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev)
    return TrainState(params, OptState(step, {k: moment(opt.m, k, True) for k in names},
                                       {k: moment(opt.v, k, False) for k in names}))
