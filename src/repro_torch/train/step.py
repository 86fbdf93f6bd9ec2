"""Train-step factory (the torch counterpart of ``repro/train/step.py``):
loss (CE + MoE aux + MTP), gradient accumulation over microbatches, and the
AdamW update, in place.

The step runs eagerly on the model's device: the reference's
``jax.jit(donate_argnums)`` has no counterpart, and ``step`` updates the
state's parameters and moments in place and returns it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.models.model import CausalLM
from repro_torch.optim import AdamWConfig, OptState
from repro_torch.optim import init as opt_init
from repro_torch.optim import update as opt_update
from repro_torch.precision import resolve_pinned_policy, use_policy


class TrainState(NamedTuple):
    params: CausalLM
    opt: OptState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-masked (label >= 0) positions, f32."""
    logits = logits.to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(model: Model, params: CausalLM, batch: dict) -> tuple[torch.Tensor, dict]:
    out = model.forward_train(params, batch)
    labels = torch.as_tensor(batch["labels"], device=model.device)
    ce = cross_entropy(out.logits, labels)
    loss = ce + out.aux_loss
    metrics = {"ce": ce, "aux": out.aux_loss}
    if out.mtp_logits is not None:
        # MTP predicts token t+2 at position t: shift labels by one extra
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_labels[:, -1] = -1
        mtp_ce = cross_entropy(out.mtp_logits, mtp_labels[:, -out.mtp_logits.shape[1]:])
        loss = loss + model.cfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def _each(fn, tree: dict) -> dict:
    """``fn`` on every tensor of a name -> tensor (or list of tensors) dict."""
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v) for k, v in tree.items()}


def grads_of(model: Model, params: CausalLM, leaves: dict, batch: dict):
    """The gradient of ``loss_fn`` with respect to ``leaves`` (name ->
    parameter of ``params``, or the list of a leaf's blocks as a rank's
    program holds a leaf split over "model": a gradient a block), and the
    detached metrics."""
    loss, metrics = loss_fn(model, params, batch)
    flat = [t for v in leaves.values() for t in (v if isinstance(v, list) else [v])]
    # a leaf the loss does not reach gets zeros, as under jax.grad
    it = iter(torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True))
    return _each(lambda _: next(it), leaves), {k: v.detach() for k, v in metrics.items()}


def batch_grads(model: Model, params: CausalLM, leaves: dict, batch: dict,
                microbatches: int = 1):
    """``grads_of`` over ``microbatches`` leading splits of ``batch`` (tensors
    on the model's device), summed in order from zero and divided, as the
    reference's ``lax.scan`` does; the metrics are the last microbatch's.
    The single-device step and each data rank of the sharded step
    (``distribution.spmd``, on its rank-local leaves) run this."""
    if microbatches == 1:
        return grads_of(model, params, leaves, batch)
    grads = _each(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), leaves)
    for i in range(microbatches):
        mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])[i]
              for k, v in batch.items()}
        g, metrics = grads_of(model, params, leaves, mb)
        for k, gk in g.items():
            grads[k] = ([a + b for a, b in zip(grads[k], gk)] if isinstance(gk, list)
                        else grads[k] + gk)
        del g
    _each(lambda gk: gk.div_(microbatches), grads)
    return grads, metrics


def make_train_step(model: Model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    policy=None):
    """Returns (init_state, step): ``init_state(generator)`` draws the
    parameters (``Model.init``) and makes them trainable; ``step(state,
    batch)`` -> (state, metrics) takes one optimizer step on ``batch``
    (numpy arrays or tensors), its gradient summed over ``microbatches``
    leading splits in order from zero, then divided, as the reference's
    ``lax.scan`` does; the metrics are the last microbatch's, beside
    "grad_norm" and "lr".

    Precision resolves ONCE here (per-arg ``policy=``, which must agree with
    an explicit ``cfg.gemm``; else the config's ``gemm``; else the ambient
    context) and is pinned around every step.
    """
    pol = resolve_pinned_policy(model.cfg.gemm, policy)

    def init_state(generator: torch.Generator) -> TrainState:
        params = model.init(generator).requires_grad_(True)
        return TrainState(params, opt_init(opt_cfg, reference_leaves(params)))

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        leaves = reference_leaves(state.params)
        with use_policy(pol):
            grads, metrics = batch_grads(model, state.params, leaves, batch, microbatches)
            _, opt, om = opt_update(opt_cfg, grads, state.opt, leaves)
        return TrainState(state.params, opt), {**metrics, **om}

    return init_state, step
