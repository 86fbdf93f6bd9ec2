"""The collectives of the single-controller mesh, in one place.

One process drives every rank (``launch.Mesh``), so a collective is an
explicit function of the ranks' tensors: an all-reduce folds them in
ascending rank order, an all-gather concatenates blocks in rank order, a
permute hands a tensor to the next rank's device. ``psum`` and
``gather_blocks`` are the all-reduce and all-gather over one mesh axis
that a tensor-parallel program runs on activations. ``core.distributed``,
``distribution.spmd``, ``models.tensor_parallel`` and
``distribution.pipeline`` call these.

Each call records its bytes with every active counter
(``distribution.op_cost.analyze``), by the reference's kinds
(``repro/distribution/hlo_cost.py``): the bytes of the collective's result
as one rank holds it, and under the innermost ``purpose`` named around it. The torch ops a collective runs inside are its own
and are not counted as the program's (``inside()``).
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_COUNTERS: list = []  # objects with .add_collective(kind, nbytes, purpose)
_PURPOSES: list = []  # the purposes named around the collectives now running
_depth = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def counting(counter):
    """Send every collective's bytes to ``counter`` while in the block."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)


@contextlib.contextmanager
def purpose(name: str):
    """Tell the counters that the collectives in the block serve ``name``
    (beside their kind), so a record can show them apart."""
    _PURPOSES.append(name)
    try:
        yield
    finally:
        _PURPOSES.pop()


def inside() -> bool:
    """True while a collective runs its own ops."""
    return _depth > 0


@contextlib.contextmanager
def collective(kind: str):
    """The body of one collective of ``kind``: yields ``done(result_bytes)``,
    which records the bytes once the result exists."""
    global _depth
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    _depth += 1

    def done(n: int) -> None:
        for c in _COUNTERS:
            c.add_collective(kind, int(n), _PURPOSES[-1] if _PURPOSES else None)

    try:
        yield done
    finally:
        _depth -= 1


def reduce_ranks(parts: list[torch.Tensor], op, device) -> torch.Tensor:
    """An explicit all-reduce: ``op`` (``torch.add`` for a psum,
    ``torch.maximum`` for a pmax) folded over the ranks' tensors in
    ascending rank order, on ``device``."""
    with collective("all-reduce") as done:
        acc = parts[0].to(device)
        for t in parts[1:]:
            acc = op(acc, t.to(device))
        done(nbytes(acc))
    return acc


def psum(parts: list[torch.Tensor], device, size: int) -> torch.Tensor:
    """An all-reduce over one mesh axis of ``size`` ranks: the parts summed
    in ascending rank order on ``device`` (``reduce_ranks`` with
    ``torch.add``). Over one rank it moves nothing and records nothing.
    ``parts`` may hold fewer than ``size`` ranks' parts (a call that runs
    some ranks' programs, for counting)."""
    if size == 1:
        return parts[0].to(device)
    return reduce_ranks(parts, torch.add, device)


def gather_blocks(blocks: list, dim: int, device, sizes: list[int]) -> torch.Tensor:
    """An all-gather over one mesh axis of activation blocks: each rank's
    block (``sizes[r]`` long along ``dim``) concatenated along ``dim`` in
    rank order on ``device``. A block given as None, a rank the call does
    not run (a call for counting), is zeros of its size. Over one rank it
    moves nothing and records nothing."""
    if len(sizes) == 1:
        return blocks[0].to(device)
    with collective("all-gather") as done:
        like = next(b for b in blocks if b is not None)
        parts = []
        for b, n in zip(blocks, sizes):
            if b is None:
                shape = list(like.shape)
                shape[dim] = n
                b = torch.zeros(shape, dtype=like.dtype, device=device)
            parts.append(b.to(device))
        out = torch.cat(parts, dim=dim)
        done(nbytes(out))
    return out


def all_gather(sharding, blocks: list[torch.Tensor], device) -> torch.Tensor:
    """The tensor ``sharding`` cut into ``blocks``, gathered onto
    ``device`` (``NamedSharding.unshard``: exact). A tensor no mesh axis
    splits moves nothing and records nothing."""
    if not sharding.is_split(blocks[0].dim()):
        return blocks[0].to(device)
    with collective("all-gather") as done:
        out = sharding.unshard(blocks, device)
        done(nbytes(out))
    return out


def permute(t: torch.Tensor, device) -> torch.Tensor:
    """A collective permute: ``t`` handed to the next rank, on ``device``."""
    with collective("collective-permute") as done:
        out = t.to(device)
        done(nbytes(out))
    return out
