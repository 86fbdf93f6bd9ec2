"""A single-controller device mesh (the torch counterpart of
``repro/launch/mesh.py``: ``make_mesh``, the production and host meshes,
``use_mesh``, ``GRID_AXES`` / ``make_grid_mesh``, and the
``jax.sharding.Mesh`` they build).

One process drives every rank: a ``Mesh`` is a tuple of axis names and an
object array of ``torch.device``s, one per rank, and the distributed code
runs each rank's work on its rank's device and reduces the ranks' tensors
explicitly (``core.distributed``). Unlike a JAX mesh, a ``Mesh`` may repeat
a device: a 2 x 4 mesh whose eight entries are all ``cuda:0`` runs every
rank on one card, and on four cards the same code spreads the ranks over
``cuda:0-3``. The dry run repeats ``torch.device("meta")`` over the
production mesh's 256 or 512 ranks (the reference's fake host devices).
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch

#: Axis names of a 2-D block-cyclic process grid (``linalg.dist``).
GRID_AXES = ("row", "col")


class Mesh:
    """``devices``: an object array of ``torch.device`` whose shape is the
    axis sizes, in ``axis_names`` order; entries may repeat."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (a ``jax.sharding.Mesh.shape`` look-alike)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, **fixed: int) -> list[torch.device]:
        """The devices along ``axis``, in rank order, at the index ``fixed``
        gives each other axis (default 0: a replicated axis' first copy)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        idx = tuple(slice(None) if name == axis else fixed.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self, rank: int) -> dict[str, int]:
        """Axis name -> the index of mesh rank ``rank`` (row-major over
        ``devices``) along it."""
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(rank, self.devices.shape))))

    def axis_index(self, rank: int, axis: str) -> int:
        """Rank ``rank``'s index along ``axis`` (0 on an axis the mesh does
        not have)."""
        return self.coords(rank).get(axis, 0)

    def sub(self, axis: str, index: int) -> tuple["Mesh", list[int]]:
        """The mesh of the other axes at ``index`` along ``axis``, and the
        ranks of this mesh it holds, in its own rank order (made once an
        axis and index)."""
        cache = self.__dict__.setdefault("_subs", {})
        if (axis, index) not in cache:
            pos = self.axis_names.index(axis)
            sl = tuple(index if i == pos else slice(None) for i in range(len(self.axis_names)))
            ranks = np.arange(self.devices.size).reshape(self.devices.shape)[sl]
            cache[axis, index] = (Mesh(self.devices[sl], self.axis_names[:pos]
                                       + self.axis_names[pos + 1:]),
                                  [int(r) for r in ranks.flat])
        return cache[axis, index]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _device_list(devices, n: int) -> list[torch.device]:
    """``n`` devices from ``devices``: None -> the visible CUDA devices (the
    first n; at least n needed), one device -> repeated n times, a
    sequence -> exactly n devices, in rank order."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(f"a mesh of {n} ranks needs {n} CUDA devices, found {count}; "
                               "pass devices= (one device is repeated over the ranks)")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)] * n
    out = [torch.device(d) for d in devices]
    if len(out) != n:
        raise ValueError(f"a mesh of {n} ranks needs {n} devices, got {len(out)}")
    return out


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``, ranks in row-major order over
    ``devices`` (see ``_device_list``: None takes the visible CUDA devices,
    a single device is repeated)."""
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    devs = _device_list(devices, math.prod(shape))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Single pod: (16, 16) over ("data", "model"), 256 ranks. Multi-pod:
    (2, 16, 16) over ("pod", "data", "model"), 512 ranks; the pod axis
    composes with "data" for DP (``distribution.sharding`` folds them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(data: int = 2, model: int = 4, devices=None) -> Mesh:
    """A small ("data", "model") mesh for tests (``devices="cpu"`` or
    ``"meta"`` repeats one device)."""
    return make_mesh((data, model), ("data", "model"), devices)


_AMBIENT: list[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Ambient-mesh context (the reference's ``use_mesh``, which feeds JAX's
    sharding context); ``current_mesh`` reads it inside. Nothing in the port
    reads it: its meshes are passed as arguments."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Mesh | None:
    """The innermost ``use_mesh`` mesh, or None outside every one."""
    return _AMBIENT[-1] if _AMBIENT else None


def make_grid_mesh(nprow: int, npcol: int, devices=None) -> Mesh:
    """P x Q process-grid mesh with axes ``("row", "col")``, the collective
    substrate of the block-cyclic factorizations."""
    return make_mesh((nprow, npcol), GRID_AXES, devices)
