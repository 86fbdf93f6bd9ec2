"""The sharded training step on the single-controller mesh (the port's
counterpart of the reference's GSPMD step,
``jax.jit(step_fn, in_shardings=named(state_specs),
out_shardings=(named(state_specs), None))``).

The state lives as each rank's blocks, placed by ``sharding.param_specs``
(``sharding.Placed``: a ``NamedSharding`` and its blocks, one per mesh rank,
on the rank's device). One step:

1. ``batch_specs`` splits the batch over the data axes ("data", or "pod"
   and "data").
2. Each data rank, in ascending order, runs its program
   (``sharded_programs``, shard_map-like): on the dense family
   (``sharding.tensor_parallel``) a leaf the rules split over "model" stays
   split, each model rank's block gathered over the data axes alone, as
   FSDP gathers, and the products over it run tensor-parallel
   (``models.tensor_parallel``: column- and row-parallel GEMMs, the vocab-parallel
   embedding, the gathered logits, attention head-local or on gathered
   q/k/v); every other leaf is gathered whole
   (``core.collectives.all_gather``, exact). The program is the
   single-device step's gradient (``train.step.batch_grads``) on its batch
   block; a split leaf's gradient comes back as the model ranks' blocks.
3. The gradients are summed over the data ranks in ascending order
   (``reduce_ranks``; a split leaf's block by block), divided by their
   count, and cut back to each rank's block.
4. AdamW (``optim.adamw.leaf_update``) runs on each rank's block, where the
   update is elementwise; its clipping norm is the norm of the gathered
   gradient in the reference's leaf order (a split leaf's gradient blocks
   are all-gathered over "model" one leaf at a time for it, so that the
   norm is the single-device one, where GSPMD psums partial norms; those
   gathers are counted under the purpose "clip-norm", which the dry run
   reports on its own). Q8 moments
   are blocked over the flattened leaf (the reference replicates them), so
   they are updated on the gathered leaf.
5. The loss and metrics are the mean over the data ranks, in rank order.

Tensor parallelism covers the dense family. The other families' leaves
that the rules split over "model" are gathered over it (GSPMD computes
them tensor-parallel): the MoE experts (EP), MLA's ``w_uq``/``w_uk``/
``w_uv``, the SSM mixer, ``frontend_proj`` and the encoder; so are the rest
of those families' leaves. A native or Ozaki-II policy runs
tensor-parallel; under another emulated scheme (Ozaki-I) every leaf is
gathered.

Under ``ozaki2-*/fast`` a step with one data rank gives the single-device
step's bits wherever no global fast-mode exponent of a split contraction
flips (``models.tensor_parallel``). A native step sums the row-parallel partials
in the compute dtype, as GSPMD's all-reduce does, and is held to the
reference's 1e-4 on the loss.

``ranks`` restricts a call to some ranks' programs (the dry run runs rank
0's, ``launch.dryrun``); the collectives then see only those ranks'
contributions, so such a call is for counting, not for its values.
"""
from __future__ import annotations

import math
import torch
from torch import nn

from repro_torch.core import collectives
from repro_torch.core.collectives import all_gather, reduce_ranks
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.models.tensor_parallel import ModelAxis, ModelSplit, block_sizes, gather
from repro_torch.optim import AdamWConfig, OptState, Q8
from repro_torch.optim.adamw import global_norm, leaf_update, step_scalars
from repro_torch.precision import resolve_pinned_policy, use_policy
from repro_torch.train.step import TrainState, batch_grads

from .sharding import (NamedSharding, P, Placed, batch_specs, local_sharding, model_dim,
                       model_split, named, param_specs, place)


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def data_rank(mesh, rank: int, multi_pod: bool = False) -> int:
    """The data-parallel index of mesh rank ``rank``."""
    coords = mesh.coords(rank)
    d = 0
    for a in data_axes(multi_pod):
        d = d * mesh.shape[a] + coords[a]
    return d


def data_size(mesh, multi_pod: bool = False) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(multi_pod))


def _leads(mesh, multi_pod: bool, ranks) -> dict:
    """Data index -> the first of ``ranks`` (default every rank) in it,
    which runs that data rank's program."""
    out = {}
    for r in range(mesh.devices.size) if ranks is None else sorted(ranks):
        out.setdefault(data_rank(mesh, r, multi_pod), r)
    return dict(sorted(out.items()))


def _owner(module: nn.Module, name: str):
    *path, attr = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, attr


def bind(module: nn.Module, tensors: dict) -> None:
    """Set ``module``'s parameters by name (a skeleton's leaves); a leaf
    split over "model" (``tensor_parallel.ModelSplit``) is held in the
    parameter's place as it is."""
    for name, t in tensors.items():
        owner, attr = _owner(module, name)
        if isinstance(t, ModelSplit):
            owner._parameters.pop(attr, None)
            object.__setattr__(owner, attr, t)
        else:
            setattr(owner, attr, t if isinstance(t, nn.Parameter) else nn.Parameter(t))


def rank_leaf(t, requires_grad: bool):
    """A program's leaf as a skeleton binds it: a parameter, or a split
    leaf whose blocks are leaves of autograd."""
    if isinstance(t, ModelSplit):
        return ModelSplit([b.detach().requires_grad_(requires_grad) for b in t.blocks],
                          t.dim, t.shape, t.axis)
    return nn.Parameter(t.detach(), requires_grad=requires_grad)


def _model_blocks(pl: Placed, axis: ModelAxis) -> ModelSplit:
    """The model ranks' blocks of a leaf split over "model", each gathered
    over the other axes onto its rank's device."""
    blocks = []
    for j, dev in zip(axis.ranks, axis.devices):
        sh, sub_ranks = local_sharding(pl.sharding, j)
        blocks.append(all_gather(sh, [pl.blocks[q] for q in sub_ranks], dev))
    return ModelSplit(blocks, model_dim(pl.sharding.spec), pl.shape, axis)


def sharded_programs(mesh, params: dict, batch: dict, *, multi_pod: bool = False,
                     ranks=None, split=frozenset()):
    """shard_map-like: for each data rank in ascending order, (its data
    index, its ``ModelAxis`` (the model ranks it runs: all, or those of
    ``ranks``), its leaves, its block of ``batch`` on the axis' device). A
    leaf of ``params`` (name -> Placed) named in ``split``
    (``sharding.model_split``) comes as a ``ModelSplit``: the model ranks'
    blocks, gathered over the other axes alone. Every other leaf is
    gathered whole onto the axis' device."""
    bspecs = named(mesh, batch_specs(batch, multi_pod))
    every = range(mesh.devices.size) if ranks is None else sorted(ranks)
    for d, r in _leads(mesh, multi_pod, ranks).items():
        run = sorted((q for q in every if data_rank(mesh, q, multi_pod) == d),
                     key=lambda q: mesh.axis_index(q, "model"))
        axis = ModelAxis(mesh.axis_size("model"),
                         tuple(mesh.axis_index(q, "model") for q in run),
                         tuple(mesh.devices.flat[q] for q in run))
        dev = axis.device
        leaves = {k: _model_blocks(pl, axis) if k in split
                  else all_gather(pl.sharding, pl.blocks, dev) for k, pl in params.items()}
        block = {k: bspecs[k].block(v, r).to(dev) for k, v in batch.items()}
        yield d, axis, leaves, block


def _place_tree(tree, shardings):
    if isinstance(tree, Q8):
        return Q8(place(tree.q, shardings.q), place(tree.scale, shardings.scale), tree.shape)
    return place(tree, shardings)


def _unplace_tree(tree, device):
    if isinstance(tree, Q8):
        return Q8(tree.q.unshard(device), tree.scale.unshard(device), tree.shape)
    return tree.unshard(device)


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, mesh, *, fsdp: bool = True,
                            multi_pod: bool = False, expert_mode: str = "fsdp"):
    """Returns (shard_state, step, unshard_state):

    * ``shard_state(state)``: a ``train.TrainState`` as the ranks' blocks
      (params and moments name -> ``Placed``, Q8 moments as Q8s of them);
    * ``step(sharded, batch, ranks=None)`` -> (sharded, metrics): one
      optimizer step, the blocks updated in place;
    * ``unshard_state(sharded, device=None)``: the ``TrainState`` the blocks
      hold (a ``CausalLM`` and its moments), on ``device`` (rank 0's).
    """
    pol = resolve_pinned_policy(model.cfg.gemm, None)
    models: dict = {}
    skeleton = Model(model.cfg, device="meta").init()
    empty = reference_leaves(skeleton)
    n_data = data_size(mesh, multi_pod)
    split = model_split(param_specs(skeleton, fsdp=fsdp, multi_pod=multi_pod,
                                    expert_mode=expert_mode), model.cfg, mesh)

    def model_on(dev) -> Model:
        if dev not in models:
            models[dev] = Model(model.cfg, device=dev)
        return models[dev]

    def shard_state(state: TrainState) -> TrainState:
        sh = named(mesh, param_specs(state, fsdp=fsdp, multi_pod=multi_pod,
                                     expert_mode=expert_mode))
        params = reference_leaves(state.params)
        with torch.no_grad():
            return TrainState(
                {k: place(p.detach(), sh.params[k]) for k, p in params.items()},
                OptState(place(state.opt.step, NamedSharding(mesh, P())),
                         *({k: _place_tree(x[k], shm[k]) for k in params}
                           for x, shm in ((state.opt.m, sh.opt.m), (state.opt.v, sh.opt.v)))))

    def unshard_state(sharded: TrainState, device=None) -> TrainState:
        device = device if device is not None else mesh.devices.flat[0]
        params = Model(model.cfg, device="meta").init()
        bind(params, {k: nn.Parameter(pl.unshard(device), requires_grad=True)
                      for k, pl in sharded.params.items()})
        opt = sharded.opt
        return TrainState(params, OptState(
            opt.step.unshard(device), *({k: _unplace_tree(x, device) for k, x in tree.items()}
                                        for tree in (opt.m, opt.v))))

    def step(sharded: TrainState, batch: dict, ranks=None) -> tuple[TrainState, dict]:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        dev0 = mesh.devices.flat[0 if ranks is None else min(ranks)]
        grads, metrics, axes = [], [], []
        with use_policy(pol):
            for _, axis, leaves, block in sharded_programs(mesh, sharded.params, batch,
                                                           multi_pod=multi_pod, ranks=ranks,
                                                           split=split):
                bound = {k: rank_leaf(t, True) for k, t in leaves.items()}
                del leaves
                bind(skeleton, bound)
                g, m = batch_grads(model_on(axis.device), skeleton,
                                   {k: t.blocks if isinstance(t, ModelSplit) else t
                                    for k, t in bound.items()}, block)
                bind(skeleton, empty)
                del bound
                grads.append(g)
                metrics.append(m)
                axes.append(axis)

        def data_mean(parts, dev):  # the data ranks' gradients summed in rank order, divided
            if n_data > 1:
                return reduce_ranks(parts, torch.add, dev).div_(n_data)
            return parts[0].to(dev)

        mean = {}
        for k in sharded.params:
            parts = [g.pop(k) for g in grads]
            if isinstance(parts[0], list):  # the model ranks' blocks, block by block
                mean[k] = [data_mean([p[i] for p in parts], dev)
                           for i, dev in enumerate(axes[0].devices)]
            else:
                mean[k] = data_mean(parts, dev0)
            del parts
        if n_data > 1:
            out = {k: reduce_ranks([m[k] for m in metrics], torch.add, dev0) / n_data
                   for k in metrics[0]}
        else:
            out = {k: v.to(dev0) for k, v in metrics[0].items()}
        om = update(sharded, mean, ranks, axes[0])
        return sharded, {**out, **om}

    def update(sharded: TrainState, grads: dict, ranks, axis: ModelAxis) -> dict:
        """AdamW on the ranks' blocks (``optim.adamw.update``'s op order).
        ``grads``: each leaf's mean gradient, whole or (a split leaf) the
        model ranks' blocks on ``axis``."""
        ranks = range(mesh.devices.size) if ranks is None else sorted(ranks)
        devs = {r: mesh.devices.flat[r] for r in ranks}
        opt = sharded.opt

        def whole(k):
            g = grads[k]
            if not isinstance(g, list):
                return g
            dim = model_dim(sharded.params[k].sharding.spec)
            shape = sharded.params[k].shape
            return gather(g, axis, block_sizes(shape[dim], axis.size), dim)

        def block(k, r):
            """Rank r's block of leaf k's mean gradient."""
            p, g = sharded.params[k], grads[k]
            if not isinstance(g, list):
                return p.sharding.block(g, r)
            j = mesh.axis_index(r, "model")
            sh, sub_ranks = local_sharding(p.sharding, j)
            return sh.block(g[axis.ranks.index(j)], sub_ranks.index(r))

        with torch.no_grad():
            for r in ranks:
                opt.step.blocks[r].add_(1)
            r0 = ranks[0]
            with collectives.purpose("clip-norm"):
                gnorm = global_norm(whole(k) for k in grads)
            scalars = step_scalars(opt_cfg, opt.step.blocks[r0], gnorm)
            on = {r: tuple(s.to(devs[r]) for s in scalars) for r in ranks}
            for k in list(grads):
                p, m, v = sharded.params[k], opt.m[k], opt.v[k]
                if isinstance(m, Q8):  # blocked over the flattened leaf: on the gathered leaf
                    g = whole(k)
                    full = all_gather(p.sharding, p.blocks, g.device)
                    mq, vq = (Q8(x.q.blocks[r0], x.scale.blocks[r0], x.shape) for x in (m, v))
                    leaf_update(opt_cfg, full, mq, vq, g, on[r0])
                    for r in ranks:
                        p.blocks[r].copy_(p.sharding.block(full, r))
                        for x in (m, v):
                            for pl in (x.q, x.scale):
                                if r != r0:
                                    pl.blocks[r].copy_(pl.blocks[r0])
                    continue
                for r in ranks:
                    leaf_update(opt_cfg, p.blocks[r], m.blocks[r], v.blocks[r],
                                block(k, r).to(devs[r]), on[r])
                grads[k] = None
        return {"grad_norm": gnorm, "lr": scalars[0]}

    return shard_state, step, unshard_state
