"""repro_torch.launch: the device grid of the distributed paths (the torch
counterpart of the parts of ``repro.launch.mesh`` that ``core.distributed``
and ``linalg.dist`` use). The production meshes are not ported here."""
from .mesh import GRID_AXES, Mesh, make_grid_mesh, make_mesh

__all__ = ["GRID_AXES", "Mesh", "make_grid_mesh", "make_mesh"]
