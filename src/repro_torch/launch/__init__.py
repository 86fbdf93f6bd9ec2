"""repro_torch.launch: the device meshes of the distributed paths (the torch
counterpart of ``repro.launch.mesh``: the production and host meshes,
``use_mesh`` and the block-cyclic grid) and the dry run (``launch.dryrun``,
imported on its own: ``python -m repro_torch.launch.dryrun``)."""
from .mesh import (GRID_AXES, Mesh, current_mesh, make_grid_mesh, make_host_mesh, make_mesh,
                   make_production_mesh, use_mesh)

__all__ = ["GRID_AXES", "Mesh", "current_mesh", "make_grid_mesh", "make_host_mesh",
           "make_mesh", "make_production_mesh", "use_mesh"]
