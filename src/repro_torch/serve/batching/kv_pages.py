"""Host-side paged-KV bookkeeping: free-list page allocator + block tables
(the torch counterpart of ``repro/serve/batching/kv_pages.py``).

The device-side layout contract lives in ``repro_torch.models.paged_kv``: pools are
``(num_pages, page_size, ...)`` with page :data:`SCRATCH_PAGE` reserved as
the garbage bucket for dead/padded batch slots. This module owns which
physical pages belong to which sequence: pages are allocated for a request's
full budget (``prompt + max_new_tokens``) when it joins the batch and
released when it leaves, so admission control is a free-list length check
and a running batch can never hit an out-of-pages fault mid-decode.
"""
from __future__ import annotations

import numpy as np

#: Physical page 0 is never allocated: dead/padded slots point their whole
#: block table at it so their writes land in a garbage bucket.
SCRATCH_PAGE = 0


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: low page numbers are handed out first, which keeps
        # smoke-scale pools dense (and page reuse immediate — the bitwise
        # guarantee does not depend on reused pages being zeroed).
        self._free = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._owned: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def pages_needed(self, total_len: int) -> int:
        return -(-int(total_len) // self.page_size)  # ceil

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise MemoryError(f"requested {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.update(pages)
        return pages

    def release(self, pages) -> None:
        for p in pages:
            if p not in self._owned:
                raise ValueError(f"releasing page {p} not handed out by this "
                                 "allocator (double free or foreign page)")
            self._owned.discard(p)
            self._free.append(p)

    def block_table_row(self, pages, num_blocks: int) -> np.ndarray:
        """Fixed-width int32 block-table row: owned pages then scratch
        padding (stable batch shapes need every row the same ``num_blocks``)."""
        if len(pages) > num_blocks:
            raise ValueError(f"{len(pages)} pages exceed table width {num_blocks}")
        row = np.full((num_blocks,), SCRATCH_PAGE, np.int32)
        row[:len(pages)] = pages
        return row

    @staticmethod
    def scratch_row(num_blocks: int) -> np.ndarray:
        return np.full((num_blocks,), SCRATCH_PAGE, np.int32)
