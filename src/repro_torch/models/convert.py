"""Interchange with the reference's parameters: ``params_from_reference``
loads the params pytree of the JAX package's ``Model.init`` (its leaves as
numpy arrays; a stage's leaves stacked on a leading layer axis) onto the
port's module tree, layer i of a stage from slice i, so both packages
compute the same function from the same weights."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .attention import GQAAttention
from .blocks import Block
from .layers import MLP
from .model import CausalLM, Model


def params_from_reference(model: Model, tree: dict) -> CausalLM:
    """The ``CausalLM`` of ``model`` (on its device) holding the reference
    params ``tree``: {"embed", "stages": (stage dicts of stacked leaves,),
    "final_norm", ["lm_head"]}."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(model.device)

    stages = nn.ModuleList()
    for entry, sp in zip(model.stages, tree["stages"]):
        blocks = nn.ModuleList()
        for i in range(entry.spec.num_layers):
            at, ml = sp["attn"], sp["mlp"]
            biases = tuple(t(at[k][i]) for k in ("bq", "bk", "bv")) if "bq" in at else ()
            attn = GQAAttention(*(t(at[k][i]) for k in ("wq", "wk", "wv", "wo")), *biases)
            mlp = MLP(t(ml["w_up"][i]), t(ml["w_down"][i]),
                      t(ml["w_gate"][i]) if "w_gate" in ml else None)
            post = ((t(sp["attn_post_norm"][i]), t(sp["mlp_post_norm"][i]))
                    if "attn_post_norm" in sp else ())
            blocks.append(Block(t(sp["attn_norm"][i]), attn, t(sp["mlp_norm"][i]), mlp, *post))
        stages.append(blocks)
    return CausalLM(t(tree["embed"]), stages, t(tree["final_norm"]),
                    t(tree["lm_head"]) if "lm_head" in tree else None)
