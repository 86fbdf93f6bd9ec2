"""Pipeline parallelism: the GPipe schedule on the single-controller mesh
(the torch counterpart of ``repro/distribution/pipeline.py``).

The layer stack is split into S stages over a mesh axis; microbatches
stream through in the classic M + S - 1 steps. At step t, stage i runs
microbatch t - i on its rank's device and hands the result to rank i + 1
(``core.collectives.permute``); the last stage's outputs come back on the
caller's device. The schedule is explicit, so bubble slots stay idle (the
reference masks them with ``where`` over zeros). Every microbatch meets
the same ops in the same order as in the sequential stack, so the result
is bitwise equal to it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.collectives import permute


def _stage(stage_params, i: int):
    if isinstance(stage_params, (list, tuple)):
        return stage_params[i]
    if isinstance(stage_params, torch.Tensor):
        return stage_params[i]
    if isinstance(stage_params, dict):
        return {k: _stage(v, i) for k, v in stage_params.items()}
    raise TypeError(f"stage params: a list of S trees or a tree of (S, ...) tensors, "
                    f"not {type(stage_params).__name__}")


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def pipeline_apply(fn: Callable, stage_params, x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """(M, mb, ...) outputs of applying all S stages to every microbatch of
    ``x`` (M, mb, ...): ``fn(params_i, h)`` is stage i. ``stage_params`` is
    a list of S stage trees, or one tree whose tensors have a leading S
    axis; stage i's are moved to its rank's device."""
    devs = mesh.axis_devices(axis)
    s, m = len(devs), x.shape[0]
    params = [_to(_stage(stage_params, i), d) for i, d in enumerate(devs)]
    inflight: list = [None] * s  # the input waiting at each stage
    outputs: list = [None] * m
    for t in range(m + s - 1):
        for i in reversed(range(s)):  # downstream first: a stage frees its slot
            mb = t - i
            if not 0 <= mb < m:
                continue  # a bubble: this stage idles
            h = x[mb].to(devs[0]) if i == 0 else inflight[i]
            inflight[i] = None
            y = fn(params[i], h)
            if i == s - 1:
                outputs[mb] = y.to(x.device)
            else:
                inflight[i + 1] = permute(y, devs[i + 1])
    return torch.stack(outputs)
