"""Paged KV-cache primitives (the torch counterpart of
``repro/models/paged_kv.py``): fixed-size page pools + per-sequence block
tables (the vLLM layout).

A pool holds ``num_pages`` pages of ``page_size`` consecutive positions for
one cache tensor (k or v); sequences own disjoint sets of pages and address
them through an int32 block table ``(B, nb)`` mapping logical page index
``pos // page_size`` to a physical page. Page 0 is the SCRATCH page:
dead/padded batch slots point every block-table entry at it, so their
writes land in a garbage bucket instead of corrupting live sequences
(duplicate scatter indices only ever collide on scratch).

Numerical contract: ``paged_gather`` reproduces the dense ``(B, L, ...)``
cache layout exactly (L = nb * page_size), so attention over a gathered
pool is bitwise-identical to attention over the dense cache it replaces:
stale values in reused pages sit at masked positions, where
``exp(-1e30) = 0`` zeroes them exactly.

``paged_update`` writes the pool in place (the reference's engine donates
the pool to its jitted step, which XLA also updates in place) and returns
it. Allocation policy lives host-side in ``repro_torch.serve.batching.
kv_pages``.
"""
from __future__ import annotations

import torch


def flat_slot_index(block_tables: torch.Tensor, positions: torch.Tensor,
                    page_size: int) -> torch.Tensor:
    """Flat pool-view indices of ``positions``.

    ``block_tables`` (B, nb) int32; ``positions`` (B, S) absolute sequence
    positions. Returns (B, S) indices into the ``(num_pages * page_size,
    ...)`` flattened pool. Out-of-table logical pages clip to the last entry
    (callers keep positions within ``nb * page_size``), as the reference's
    gather does.
    """
    positions = positions.to(torch.int32)
    logical = torch.clamp(positions // page_size, max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables, 1, logical.long())
    return page * page_size + positions % page_size


def paged_update(pool: torch.Tensor, vals: torch.Tensor,
                 block_tables: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Scatter ``vals`` (B, S, *t) into ``pool`` (P, ps, *t) at ``positions``
    (B, S) of each row's sequence, in place; returns ``pool``. Rows writing
    through an all-scratch block table collide on page 0 by design."""
    num_pages, page_size = pool.shape[:2]
    flat = pool.view((num_pages * page_size,) + tuple(pool.shape[2:]))
    idx = flat_slot_index(block_tables, positions, page_size).long()
    flat[idx] = vals.to(pool.dtype)
    return pool


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense per-sequence view ``(B, nb * page_size, *t)`` of the pool:
    exactly the dense-cache layout the attention masks were written for."""
    num_pages, page_size = pool.shape[:2]
    b, nb = block_tables.shape
    flat = pool.view((num_pages * page_size,) + tuple(pool.shape[2:]))
    idx = (block_tables[:, :, None].long() * page_size
           + torch.arange(page_size, device=pool.device)[None, None, :])
    return flat[idx.reshape(b, nb * page_size)]
