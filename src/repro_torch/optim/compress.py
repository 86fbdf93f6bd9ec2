"""Gradient compression for data-parallel reductions (the torch counterpart
of ``repro/optim/compress.py``).

* int8 + error feedback: gradients are blockwise int8-quantized
  (``optim.quantized``) before the cross-replica sum, and the quantization
  residual is carried to the next step (memory: one gradient copy); 4x
  fewer reduction bytes than f32.
* Exact reduction: the fixed-point integer image of a scaled gradient is
  summed in int64, associative and exact, so the mean does not depend on
  the replicas' order, unlike a float sum.

Single-controller semantics, as ``core.distributed``: the reference's psum
over a mesh axis is a sum over the list of the replicas' tensors (one per
replica, each on its own device), taken in replica order on the first
replica's device, and every replica gets the result back on its device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.collectives import reduce_ranks

from . import quantized


class EFState(NamedTuple):
    residual: Any  # one replica's tree of f32 residuals, the gradients' structure


def ef_init(params: Any) -> EFState:
    """Zero residuals in the structure of ``params`` (a tree of tensors)."""
    return EFState(pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                         device=p.device), params))


def compress_decompress(g: torch.Tensor, r: torch.Tensor):
    """Quantize (g + carried residual) to int8 blocks; return the dequantized
    value that survives the wire and the new residual."""
    target = g.to(torch.float32) + r
    wire = quantized.dequantize(quantized.quantize(target))
    return wire, target - wire


def compressed_psum(grads: list, efs: list[EFState]) -> tuple[list, list[EFState]]:
    """int8-EF all-reduce over the replicas: ``grads[i]`` and ``efs[i]`` are
    replica i's gradient tree and error-feedback state. Each replica
    quantizes locally; the dequantized values are summed in replica order;
    every replica gets the sum (on its devices) and its new state. On the
    wire this is the int8 payload and the per-block scales."""
    if len(grads) != len(efs) or not grads:
        raise ValueError(f"one state per replica: {len(grads)} gradients, {len(efs)} states")
    wires, new_res = [], []
    for g, ef in zip(grads, efs):
        leaves, spec = pytree.tree_flatten(g)
        pairs = [compress_decompress(x, r)
                 for x, r in zip(leaves, pytree.tree_flatten(ef.residual)[0])]
        wires.append([w for w, _ in pairs])
        new_res.append(EFState(pytree.tree_unflatten([nr for _, nr in pairs], spec)))
    sums = [reduce_ranks(list(ws), torch.add, ws[0].device) for ws in zip(*wires)]
    out = []
    for g in grads:
        leaves, spec = pytree.tree_flatten(g)
        out.append(pytree.tree_unflatten([s.to(x.device) for s, x in zip(sums, leaves)], spec))
    return out, new_res


def exact_residue_psum(xs: list[torch.Tensor], scale_bits: int = 24) -> list[torch.Tensor]:
    """Exact, order-independent mean of the replicas' tensors: scale by
    2^scale_bits / max|x| (the max over every replica), round to int64, sum
    (exact for |sum| < 2^63), unscale. Every replica gets the mean, in its
    tensor's dtype and on its device."""
    n = torch.tensor(float(len(xs)), dtype=torch.float32)
    root = xs[0].device
    amax = reduce_ranks([x.to(torch.float32).abs().max() for x in xs], torch.maximum, root)
    two = torch.tensor(2.0 ** scale_bits, dtype=torch.float32, device=root)
    s = torch.where(amax > 0, two / amax, torch.ones_like(amax))
    tot = reduce_ranks([torch.round(x.to(torch.float32) * s.to(x.device)).to(torch.int64)
                        for x in xs], torch.add, root)
    mean = tot.to(torch.float32) / (s * n.to(root))
    return [mean.to(device=x.device, dtype=x.dtype) for x in xs]
