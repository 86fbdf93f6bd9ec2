"""The sharded training step on the single-controller mesh (the port's
counterpart of the reference's GSPMD step,
``jax.jit(step_fn, in_shardings=named(state_specs),
out_shardings=(named(state_specs), None))``).

The state lives as each rank's blocks, placed by ``sharding.param_specs``
(``sharding.Placed``: a ``NamedSharding`` and its blocks, one per mesh rank,
on the rank's device). One step:

1. ``batch_specs`` splits the batch over the data axes ("data", or "pod"
   and "data").
2. Each data rank, in ascending order, gathers every leaf from its blocks
   (``core.collectives.all_gather``, exact) onto its device and runs the
   single-device step's gradient (``train.step.batch_grads``) on its batch
   block.
3. The gradients are summed over the data ranks in ascending order
   (``reduce_ranks``), divided by their count, and cut back to each rank's
   block.
4. AdamW (``optim.adamw.leaf_update``) runs on each rank's block, where the
   update is elementwise; its clipping norm is the norm of the gathered
   gradient in the reference's leaf order. Q8 moments are blocked over the
   flattened leaf (the reference replicates them), so they are updated on
   the gathered leaf.
5. The loss and metrics are the mean over the data ranks, in rank order.

There is no tensor parallelism: a GEMM's work is not split over "model".
Every data rank gathers, as FSDP does, so the "model" axis decides only
where blocks live (GSPMD computes tensor-parallel; the port gathers). With
one data rank the step runs the single-device step's ops on the same
values and gives its bits.

``ranks`` restricts a call to some ranks' programs (the dry run runs rank
0's, ``launch.dryrun``); the collectives then see only those ranks'
contributions, so such a call is for counting, not for its values.
"""
from __future__ import annotations

import math
import numpy as np
import torch
from torch import nn

from repro_torch.core.collectives import all_gather, reduce_ranks
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import AdamWConfig, OptState, Q8
from repro_torch.optim.adamw import global_norm, leaf_update, step_scalars
from repro_torch.precision import resolve_pinned_policy, use_policy
from repro_torch.train.step import TrainState, batch_grads

from .sharding import NamedSharding, P, batch_specs, named, param_specs, place


def data_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def data_rank(mesh, rank: int, multi_pod: bool = False) -> int:
    """The data-parallel index of mesh rank ``rank``."""
    coords = dict(zip(mesh.axis_names, np.unravel_index(rank, mesh.devices.shape)))
    d = 0
    for a in data_axes(multi_pod):
        d = d * mesh.shape[a] + int(coords[a])
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
    """Set ``module``'s parameters by name (a skeleton's leaves)."""
    for name, t in tensors.items():
        owner, attr = _owner(module, name)
        setattr(owner, attr, t if isinstance(t, nn.Parameter) else nn.Parameter(t))


def gathered_programs(mesh, params: dict, batch: dict, *, multi_pod: bool = False,
                      ranks=None):
    """For each data rank in ascending order: (data index, its device, each
    leaf of ``params`` (name -> Placed) gathered there, its block of
    ``batch`` there)."""
    bspecs = named(mesh, batch_specs(batch, multi_pod))
    for d, r in _leads(mesh, multi_pod, ranks).items():
        dev = mesh.devices.flat[r]
        leaves = {k: all_gather(pl.sharding, pl.blocks, dev) for k, pl in params.items()}
        block = {k: bspecs[k].block(v, r).to(dev) for k, v in batch.items()}
        yield d, dev, leaves, block


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
        grads, metrics = [], []
        with use_policy(pol):
            for _, dev, leaves, block in gathered_programs(mesh, sharded.params, batch,
                                                           multi_pod=multi_pod, ranks=ranks):
                bind(skeleton, {k: nn.Parameter(t.detach(), requires_grad=True)
                                for k, t in leaves.items()})
                del leaves
                g, m = batch_grads(model_on(dev), skeleton, reference_leaves(skeleton), block)
                bind(skeleton, empty)
                grads.append(g)
                metrics.append(m)
        # the data ranks' gradients summed in rank order, then divided
        mean = {}
        for k in sharded.params:
            parts = [g.pop(k) for g in grads]
            if n_data > 1:
                mean[k] = reduce_ranks(parts, torch.add, dev0).div_(n_data)
            else:
                mean[k] = parts[0].to(dev0)
            del parts
        if n_data > 1:
            out = {k: reduce_ranks([m[k] for m in metrics], torch.add, dev0) / n_data
                   for k in metrics[0]}
        else:
            out = {k: v.to(dev0) for k, v in metrics[0].items()}
        om = update(sharded, mean, ranks)
        return sharded, {**out, **om}

    def update(sharded: TrainState, grads: dict, ranks) -> dict:
        """AdamW on the ranks' blocks (``optim.adamw.update``'s op order)."""
        ranks = range(mesh.devices.size) if ranks is None else sorted(ranks)
        devs = {r: mesh.devices.flat[r] for r in ranks}
        opt = sharded.opt
        with torch.no_grad():
            for r in ranks:
                opt.step.blocks[r].add_(1)
            r0 = ranks[0]
            gnorm = global_norm(grads)
            scalars = step_scalars(opt_cfg, opt.step.blocks[r0], gnorm)
            on = {r: tuple(s.to(devs[r]) for s in scalars) for r in ranks}
            for k, g in grads.items():
                p, m, v = sharded.params[k], opt.m[k], opt.v[k]
                if isinstance(m, Q8):  # blocked over the flattened leaf: on the gathered leaf
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
                    gr = p.sharding.block(g, r).to(devs[r])
                    leaf_update(opt_cfg, p.blocks[r], m.blocks[r], v.blocks[r], gr, on[r])
                grads[k] = None
        return {"grad_norm": gnorm, "lr": scalars[0]}

    return shard_state, step, unshard_state
