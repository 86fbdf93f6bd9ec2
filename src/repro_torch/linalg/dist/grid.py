"""2-D block-cyclic process grid and distributed matrix layout (the torch
counterpart of ``repro/linalg/dist/grid.py``).

The layout is ScaLAPACK/HPL's: the matrix is tiled into ``block`` x ``block``
blocks, and block (I, J) lives on rank ``(I mod P, J mod Q)`` of a P x Q
process grid. Each rank packs its blocks contiguously in block order, so a
rank's local array is itself a dense matrix and every per-rank update is one
dense kernel call (the trailing update: ONE emulated GEMM per rank).

This is a single-controller SPMD program, as the reference's: all ranks
live in one process, rank-local storage is host numpy, and communication is
explicit: device-placed plan/block broadcasts and the pivot
argmax-allreduce over a ``launch.mesh`` grid mesh. The mesh takes P*Q
distinct devices of the entry point's device type when that many are
visible, and otherwise repeats the entry point's device (the card unless
the caller asks for the CPU): on one H100 a 2 x 2 grid runs every rank's
GEMM on ``cuda:0``, and the CPU, one card and four cards run the same
code. The reference's host-fallback collectives exist because a JAX mesh
cannot repeat a device; a ``launch.mesh.Mesh`` can, so there are none.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import argmax_allreduce
from repro_torch.core.gemm import resolve_device
from repro_torch.launch.mesh import make_grid_mesh


def parse_grid(spec: str) -> tuple[int, int]:
    """``"PxQ"`` -> (P, Q), e.g. ``"2x2"`` -> (2, 2)."""
    try:
        p, _, q = spec.lower().partition("x")
        out = (int(p), int(q))
    except ValueError:
        raise ValueError(f"grid spec must look like '2x2', got {spec!r}") from None
    if out[0] < 1 or out[1] < 1:
        raise ValueError(f"grid dims must be >= 1, got {spec!r}")
    return out


class ProcessGrid:
    """P x Q process grid: owner maps, rank devices, and grid collectives.

    ``device`` is the entry point's device (None: the card). ``mesh`` is
    the ``("row", "col")`` device mesh: P*Q distinct visible devices of that
    device's type when there are enough, else that device repeated.
    """

    def __init__(self, nprow: int, npcol: int, *, device=None):
        if nprow < 1 or npcol < 1:
            raise ValueError(f"grid dims must be >= 1, got {nprow}x{npcol}")
        self.nprow = nprow
        self.npcol = npcol
        self.entry_device = resolve_device(device)
        devs = self.visible_devices()
        self.mesh = make_grid_mesh(nprow, npcol, devs[:self.size]
                                   if len(devs) >= self.size else self.entry_device)

    # ---- identity ----
    @property
    def size(self) -> int:
        return self.nprow * self.npcol

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nprow, self.npcol)

    def __repr__(self) -> str:
        return f"ProcessGrid({self.nprow}x{self.npcol})"

    def coords(self):
        """All (p, q) rank coordinates, row-major."""
        return ((p, q) for p in range(self.nprow) for q in range(self.npcol))

    # ---- ownership ----
    def row_owner(self, block_i: int) -> int:
        return block_i % self.nprow

    def col_owner(self, block_j: int) -> int:
        return block_j % self.npcol

    def owner(self, block_i: int, block_j: int) -> tuple[int, int]:
        return (self.row_owner(block_i), self.col_owner(block_j))

    @staticmethod
    def _local_count(nblocks: int, rank: int, nranks: int) -> int:
        """Number of blocks in ``range(nblocks)`` owned by ``rank``."""
        return max(0, (nblocks - rank + nranks - 1) // nranks)

    def local_row_blocks(self, nblocks: int, p: int) -> int:
        return self._local_count(nblocks, p, self.nprow)

    def local_col_blocks(self, nblocks: int, q: int) -> int:
        return self._local_count(nblocks, q, self.npcol)

    # ---- devices & collectives ----
    def visible_devices(self) -> list[torch.device]:
        """The distinct visible devices of the entry point's device type."""
        if self.entry_device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device(self.entry_device.type)]

    def device(self, p: int, q: int) -> torch.device:
        """The device hosting rank (p, q)."""
        return self.mesh.devices[p, q]

    def row_devices(self, p: int, *, skip: int | None = None) -> list:
        """Devices of process row ``p`` (broadcast receivers along the row),
        optionally skipping the owner column ``skip``."""
        return [self.device(p, q) for q in range(self.npcol) if q != skip]

    def col_devices(self, q: int, *, skip: int | None = None) -> list:
        return [self.device(p, q) for p in range(self.nprow) if p != skip]

    def argmax_allreduce(self, vals, idxs) -> tuple[float, int]:
        """Pivot-search collective along the process-row axis: one candidate
        ``(value, global_row)`` per process row; ties -> smallest index."""
        return argmax_allreduce(vals, idxs, self.mesh, "row")


class BlockCyclicMatrix:
    """A dense matrix scattered block-cyclically over a :class:`ProcessGrid`.

    Rank (p, q) packs its owned blocks contiguously: local row
    ``(I // P) * b + r`` holds global row ``I * b + r`` for every owned block
    row ``I ≡ p (mod P)`` (columns symmetric). Arbitrary shapes are
    supported: the LAST block row/column may be ragged (short), in which case
    only the final owned block of its owner rank is short — every earlier
    owned block is full, so the local-index arithmetic above still holds
    (blocks pack in increasing global order and raggedness can only appear at
    the trailing edge).
    """

    def __init__(self, grid: ProcessGrid, block: int, shape: tuple[int, int],
                 locals_: dict[tuple[int, int], np.ndarray]):
        self.grid = grid
        self.block = block
        self.shape = shape
        self.locals_ = locals_

    @staticmethod
    def num_blocks(n: int, block: int) -> int:
        """ceil(n / block): block count including a trailing ragged block."""
        return -(-n // block)

    @classmethod
    def from_global(cls, a, grid: ProcessGrid, block: int) -> "BlockCyclicMatrix":
        a = np.asarray(a, dtype=np.float64)
        m, n = a.shape
        mb, nb = cls.num_blocks(m, block), cls.num_blocks(n, block)
        b = block
        locals_: dict[tuple[int, int], np.ndarray] = {}
        for p, q in grid.coords():
            rbs = list(range(p, mb, grid.nprow))
            cbs = list(range(q, nb, grid.npcol))
            # Only the globally-last block can be ragged, and it packs last
            # locally, so local offsets stay li*b / lj*b.
            nrow = sum(min(b, m - bi * b) for bi in rbs)
            ncol = sum(min(b, n - bj * b) for bj in cbs)
            loc = np.empty((nrow, ncol), dtype=np.float64)
            for li, bi in enumerate(rbs):
                rs = min(b, m - bi * b)
                for lj, bj in enumerate(cbs):
                    cs = min(b, n - bj * b)
                    loc[li * b:li * b + rs, lj * b:lj * b + cs] = \
                        a[bi * b:bi * b + rs, bj * b:bj * b + cs]
            locals_[(p, q)] = loc
        return cls(grid, block, (m, n), locals_)

    def to_global(self) -> np.ndarray:
        m, n = self.shape
        b = self.block
        out = np.empty((m, n), dtype=np.float64)
        for (p, q), loc in self.locals_.items():
            for li in range((loc.shape[0] + b - 1) // b):
                bi = p + li * self.grid.nprow
                rs = min(b, m - bi * b)
                for lj in range((loc.shape[1] + b - 1) // b):
                    bj = q + lj * self.grid.npcol
                    cs = min(b, n - bj * b)
                    out[bi * b:bi * b + rs, bj * b:bj * b + cs] = \
                        loc[li * b:li * b + rs, lj * b:lj * b + cs]
        return out

    def local(self, p: int, q: int) -> np.ndarray:
        return self.locals_[(p, q)]

    # ---- index maps (global <-> rank-local) ----
    def row_owner(self, i: int) -> int:
        return self.grid.row_owner(i // self.block)

    def col_owner(self, j: int) -> int:
        return self.grid.col_owner(j // self.block)

    def local_row(self, i: int) -> int:
        """Local row index of global row ``i`` on its owning process row."""
        b = self.block
        return (i // b // self.grid.nprow) * b + i % b

    def local_col(self, j: int) -> int:
        b = self.block
        return (j // b // self.grid.npcol) * b + j % b

    def global_row(self, p: int, lr: int) -> int:
        """Inverse of :meth:`local_row` for process row ``p``."""
        b = self.block
        return (p + (lr // b) * self.grid.nprow) * b + lr % b

    def global_col(self, q: int, lc: int) -> int:
        b = self.block
        return (q + (lc // b) * self.grid.npcol) * b + lc % b

    def global_rows(self, p: int) -> np.ndarray:
        """Global row indices of process row ``p``'s local rows, in local
        order (monotone increasing: packing preserves global order)."""
        nloc = self.locals_[(p, 0)].shape[0]
        lr = np.arange(nloc)
        return (p + (lr // self.block) * self.grid.nprow) * self.block \
            + lr % self.block

    def global_cols(self, q: int) -> np.ndarray:
        nloc = self.locals_[(0, q)].shape[1]
        lc = np.arange(nloc)
        return (q + (lc // self.block) * self.grid.npcol) * self.block \
            + lc % self.block

    def local_row_tail(self, p: int, block_i: int) -> int:
        """First local row on process row ``p`` at/after global block row
        ``block_i`` — the start of the contiguous local tail of the trailing
        submatrix (local blocks are packed in increasing global order). The
        clamp covers a ragged last block: counting it as full would overshoot
        the local extent when ``block_i`` lies past it."""
        full = self.grid._local_count(block_i, p, self.grid.nprow) * self.block
        return min(full, self.locals_[(p, 0)].shape[0])

    def local_col_tail(self, q: int, block_j: int) -> int:
        full = self.grid._local_count(block_j, q, self.grid.npcol) * self.block
        return min(full, self.locals_[(0, q)].shape[1])

    # ---- row exchange (the pivoting collective) ----
    def swap_rows(self, i: int, r: int) -> int:
        """Exchange global rows ``i`` and ``r`` across every process column
        (full rows: left factors and trailing matrix alike). Returns the
        bytes a real interconnect would move (0 when both rows live on the
        same process row: the swap is then rank-local in every column)."""
        if i == r:
            return 0
        pi, pr = self.row_owner(i), self.row_owner(r)
        li, lr = self.local_row(i), self.local_row(r)
        moved = 0
        for q in range(self.grid.npcol):
            a_i = self.locals_[(pi, q)]
            a_r = self.locals_[(pr, q)]
            tmp = a_i[li].copy()
            a_i[li] = a_r[lr]
            a_r[lr] = tmp
            if pi != pr:
                moved += a_i[li].nbytes + tmp.nbytes
        return moved
