"""repro_torch.distribution: the sharding rules and placements (``sharding``),
the sharded training step (``spmd``, tensor-parallel through
``models.tensor_parallel``), the GPipe pipeline (``pipeline``) and the per-rank
cost counter (``op_cost``) on the single-controller mesh (the torch
counterpart of ``repro.distribution``)."""
from .op_cost import collective_bytes, flops_and_bytes
from .sharding import batch_specs, cache_specs, named, param_specs

__all__ = ["collective_bytes", "flops_and_bytes", "batch_specs", "cache_specs",
           "named", "param_specs"]
