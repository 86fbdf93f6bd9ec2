"""Sharding rules: parameter/cache/batch PartitionSpecs from leaf paths (the
torch counterpart of ``repro/distribution/sharding.py``, whose rule table
and ``_spec_for`` are copied here as they are).

Strategy (the reference's):
  TP  — head/mlp/expert/vocab dims -> "model"
  DP  — batch -> ("pod", "data") (pod folds into DP on the multi-pod mesh)
  FSDP— the non-TP weight axis -> "data"
  EP  — expert-stacked weights: leading E axis -> "model"
  SP  — decode caches with batch < DP width shard the cache LENGTH over
        "data", otherwise batch over DP and heads/latent over "model".

Rules match on each leaf's reference path in the form the reference's
``_norm_path`` gives (``jax.tree_util.keystr`` with its brackets folded):
``param_specs`` builds that string for every leaf of the port's trees, so
a leaf gets exactly the spec the reference gives the same leaf. The
reference stacks a stage's layers on a leading axis and prepends ``None``
for it; the port holds one module a layer, so its leaves take the spec
without that axis.

``named(mesh, specs)`` wraps specs in ``NamedSharding``s, which place a
tensor on the port's single-controller mesh (``launch.Mesh``):
``shard(t)`` gives each rank's block on that rank's device, ``unshard``
concatenates them back, exactly. ``Placed`` holds a tensor so placed: its
sharding and its ranks' blocks. ``model_split`` names the leaves a rank's
program keeps split over "model" (tensor parallelism, the dense family);
``local_sharding`` places a model rank's block of such a leaf over the
other axes.
"""
from __future__ import annotations

import math
import re
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_leaves, reference_path
from repro_torch.optim import OptState, Q8
from repro_torch.precision import resolve_policy


class PartitionSpec(tuple):
    """A tensor's placement: one entry per dimension, ``None`` (not split),
    an axis name, or a tuple of axis names folded (the first major). ``P()``
    is replicated; ``P(None)`` differs from it, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(p if p is None or isinstance(p, str) else tuple(p)
                                          for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (regex on leaf path, spec WITHOUT the stacked-layer axis), first match wins.
# "F" marks the axis that FSDP shards over "data" when enabled.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", "F")),
    (r"lm_head$", ("F", "model")),
    (r"frontend_proj$", (None, "model")),
    (r"(final_norm|_norm|/norm)$", (None,)),
    # attention (GQA)
    (r"attn/(wq|wk|wv)$", ("F", "model")),
    (r"attn/wo$", ("model", "F")),
    (r"attn/b[qkv]$", ("model",)),
    # MLA
    (r"attn/w_dq$", ("F", None)),
    (r"attn/w_uq$", (None, "model")),
    (r"attn/w_dkv$", ("F", None)),
    (r"attn/w_(uk|uv)$", (None, "model")),
    # MLP
    (r"mlp/w_(gate|up)$", ("F", "model")),
    (r"mlp/w_down$", ("model", "F")),
    (r"shared/w_(gate|up)$", ("F", "model")),
    (r"shared/w_down$", ("model", "F")),
    # MoE (EP over the expert axis; "EPFULL" resolves per expert_mode:
    #  fsdp -> experts over "model" + FSDP over the weight axis (baseline)
    #  ep   -> experts over ("model","data") — one expert home per chip, no
    #          per-layer weight all-gathers
    (r"moe/router$", (None, None)),
    (r"moe/w_(gate|up)$", ("EPFULL", "EPF", None)),
    (r"moe/w_down$", ("EPFULL", "EPF", None)),
    # Mamba2 (TP over d_inner channels)
    (r"mixer/in_proj$", ("F", "model")),
    (r"mixer/conv_w$", (None, "model")),
    (r"mixer/conv_b$", ("model",)),
    (r"mixer/(A_log|D|dt_bias)$", ("model",)),
    (r"mixer/out_proj$", ("model", "F")),
    # MTP
    (r"mtp/proj$", ("F", "model")),
    # optimizer 8-bit blocks: flat -> FSDP over data
    (r"/(q|scale)$", ("F",)),
    # catch-all small leaves: replicated
    (r".*", None),
]


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path: dict keys ``['k']``, sequence
    indices ``[i]``, NamedTuple fields ``.f``, a custom node's children
    ``[<flat index i>]`` (entries given as ``("attr", f)`` / ``("flat", i)``)."""
    out = []
    for k in path:
        if isinstance(k, tuple):
            out.append(f".{k[1]}" if k[0] == "attr" else f"[<flat index {k[1]}>]")
        elif isinstance(k, int):
            out.append(f"[{k}]")
        else:
            out.append(f"[{k!r}]")
    return "".join(out)


def _norm_path(path) -> str:
    return _keystr(path).replace("']['", "/").strip("[]'\"").replace("'", "")


def _spec_for(path_str: str, ndim: int, fsdp: bool, dp_axes,
              expert_mode: str = "fsdp") -> P:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_str):
            if spec is None:
                return P()

            def resolve(a):
                if a == "F":
                    return dp_axes if fsdp else None
                if a == "EPFULL":
                    return ("model",) + (tuple(dp_axes) if isinstance(dp_axes, tuple)
                                         else (dp_axes,)) if expert_mode == "ep" else "model"
                if a == "EPF":
                    if expert_mode == "ep":
                        return None  # weights live whole on the expert home
                    return dp_axes if fsdp else None
                return a

            axes = [resolve(a) for a in spec]
            # pad/prepend None for stacked layer axes
            while len(axes) < ndim:
                axes.insert(0, None)
            if len(axes) != ndim:  # rank mismatch (e.g. scalar A_log stack)
                axes = [None] * (ndim - len([a for a in axes if True])) + axes
                axes = axes[-ndim:]
            return P(*axes)
    return P()


def _dp(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def _leaf_spec(path, x, fsdp, dp, expert_mode) -> P:
    nd = len(x.shape)
    return P() if nd == 0 else _spec_for(_norm_path(path), nd, fsdp, dp, expert_mode)


def _module_specs(params: nn.Module, prefix: tuple, fsdp, dp, expert_mode) -> dict:
    """Name -> spec over ``reference_leaves(params)``, each leaf at its
    reference path (the layer index of a stacked stage dropped)."""
    return {name: _leaf_spec(prefix + reference_path(name)[0], p, fsdp, dp, expert_mode)
            for name, p in reference_leaves(params).items()}


def _moment_specs(moments: dict, prefix: tuple, fsdp, dp, expert_mode) -> dict:
    out = {}
    for name, x in moments.items():
        path = prefix + reference_path(name)[0]
        if isinstance(x, Q8):  # the reference's Q8 node: children q, scale
            out[name] = Q8(*(_leaf_spec(path + (("flat", i),), t, fsdp, dp, expert_mode)
                             for i, t in enumerate((x.q, x.scale))), x.shape)
        else:
            out[name] = _leaf_spec(path, x, fsdp, dp, expert_mode)
    return out


def param_specs(tree: Any, *, fsdp: bool = True, multi_pod: bool = False,
                expert_mode: str = "fsdp") -> Any:
    """Specs of a ``CausalLM`` (name -> spec, in ``reference_leaves`` order)
    or of a ``TrainState`` (the same structure: params and the AdamW
    moments as such dicts, Q8 moments as Q8s of specs, the step ``P()``)."""
    dp = _dp(multi_pod)
    if isinstance(tree, nn.Module):
        return _module_specs(tree, (), fsdp, dp, expert_mode)
    if hasattr(tree, "params") and hasattr(tree, "opt"):
        opt = tree.opt
        return type(tree)(
            _module_specs(tree.params, (("attr", "params"),), fsdp, dp, expert_mode),
            OptState(P(), *(_moment_specs(getattr(opt, f), (("attr", "opt"), ("attr", f)),
                                          fsdp, dp, expert_mode) for f in ("m", "v"))))
    raise TypeError(f"param_specs takes a CausalLM or a TrainState, not {type(tree).__name__}")


def batch_specs(batch: dict, multi_pod: bool = False) -> dict:
    dp = _dp(multi_pod)
    return {k: P(dp, *([None] * (len(x.shape) - 1))) if len(x.shape) else P()
            for k, x in batch.items()}


def _axes_size(mesh: Mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in (axes if isinstance(axes, tuple) else (axes,))]))


def _cache_leaf_spec(name: str, shape: tuple, dp, dp_size: int) -> P:
    """The reference's cache heuristic on a leaf as the reference holds it."""
    nd = len(shape)
    if name == "pos" or nd == 0:
        return P()
    # layouts: stacked (L, B, ...) or plain (B, ...) for shared blocks
    stacked = name in ("k", "v", "ckv", "krope", "conv", "ssd") and nd >= 4
    bdim = 1 if stacked and nd >= 4 and shape[0] != shape[1] else 0
    spec = [None] * nd
    batch = shape[bdim] if nd > bdim else 1
    shard_batch = batch % dp_size == 0 and batch >= dp_size
    if shard_batch:
        spec[bdim] = dp
    if name in ("k", "v"):
        if not shard_batch and nd >= 3:
            spec[nd - 3] = dp  # cache length (SP)
        spec[nd - 2] = "model"  # kv heads
    elif name == "ckv":
        if not shard_batch:
            spec[nd - 2] = dp
        spec[nd - 1] = "model"  # latent rank
    elif name == "krope":
        if not shard_batch:
            spec[nd - 2] = dp
    elif name in ("conv", "ssd"):
        spec[nd - 1 if name == "conv" else nd - 3] = "model"  # channels/heads
    return P(*spec)


def cache_specs(cache: dict, cfg: ModelConfig, mesh: Mesh, multi_pod: bool = False) -> dict:
    """KV/SSM cache sharding over the port's cache (``Model.init_cache``:
    {"stages": [per stage, a list of per-layer dicts], "pos", ["enc_memory"]}).
    Batch -> DP when divisible; otherwise the cache LENGTH goes to "data"
    (sequence parallelism for long_500k, B=1). Each leaf takes the spec the
    reference gives its stacked stage leaf, the layer axis dropped (a
    zamba2 shared-block entry is not stacked there either). The leaf kind
    is read off the reference's path as its ``_norm_path`` gives it, which
    leaves ``stages][i][k`` whole for a leaf under the stages list: no stage
    leaf is taken for a k/v/ckv/krope/conv/ssd leaf, so each is split over
    the data axes along its leading axis alone (the layer axis, when
    stacked), as the reference splits it."""
    from repro_torch.models.model import build_stages

    dp = _dp(multi_pod)
    dp_size = _axes_size(mesh, dp)
    entries = build_stages(cfg)

    def leaf(path, x, layers):
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
        name = _norm_path(path).rsplit("/", 1)[-1]
        if layers is None:
            return _cache_leaf_spec(name, shape, dp, dp_size)
        return P(*_cache_leaf_spec(name, (layers,) + shape, dp, dp_size)[1:])

    out = {}
    for key, val in cache.items():
        if key == "stages":
            out[key] = [[{n: leaf((key, i, n), x,
                                  None if e.spec.shared_attn else e.spec.num_layers)
                          for n, x in layer.items()} for layer in stage]
                        for i, (e, stage) in enumerate(zip(entries, val))]
        else:
            out[key] = leaf((key,), val, None)
    return out


# ------------------------------------------------------------- placement
class NamedSharding:
    """A spec on a mesh. Each mesh rank (row-major over ``mesh.devices``)
    holds one block: along every tensor dimension whose spec entry names
    mesh axes, the dimension is cut into as many blocks as those axes have
    ranks together (the first axis major) and the rank takes the block its
    coordinates index; blocks are ceil(n / parts) long, the last ones
    shorter or empty, as JAX pads them."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def _dim_axes(self, ndim: int) -> list[tuple]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-D tensor")
        out = []
        for e in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
        return out

    def parts(self, ndim: int) -> list[int]:
        """The number of blocks along each dimension."""
        return [math.prod(self.mesh.shape[a] for a in axes) for axes in self._dim_axes(ndim)]

    def block_indices(self, ndim: int) -> list[tuple[int, ...]]:
        """The block each rank holds, as its index along each dimension, in
        rank order (computed once a mesh, spec and rank)."""
        cache = self.mesh.__dict__.setdefault("_block_indices", {})
        key = (self.spec, ndim)
        if key not in cache:
            coords = np.indices(self.mesh.devices.shape).reshape(len(self.mesh.axis_names), -1)
            pos = dict(zip(self.mesh.axis_names, coords))
            cols = []
            for axes in self._dim_axes(ndim):
                i = np.zeros(self.mesh.devices.size, dtype=np.int64)
                for a in axes:
                    i = i * self.mesh.shape[a] + pos[a]
                cols.append(i)
            cache[key] = [tuple(int(c[r]) for c in cols) for r in range(self.mesh.devices.size)]
        return cache[key]

    def _slices(self, shape, idx) -> tuple:
        sl = []
        for n, k, i in zip(shape, self.parts(len(shape)), idx):
            size = -(-n // k)
            sl.append(slice(min(i * size, n), min((i + 1) * size, n)))
        return tuple(sl)

    def block(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """A view of ``t``'s block on ``rank``."""
        return t[self._slices(t.shape, self.block_indices(t.dim())[rank])]

    def is_split(self, ndim: int) -> bool:
        return any(k > 1 for k in self.parts(ndim))

    def shard(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Each rank's block of ``t``, a tensor of its own on the rank's
        device, in rank order (on ``meta``, where nothing is stored, the
        ranks holding one block share its tensor)."""
        t = t.detach()
        out, meta = [], {}
        for idx, dev in zip(self.block_indices(t.dim()), self.mesh.devices.flat):
            if dev.type == "meta":
                if idx not in meta:
                    shape = [s.stop - s.start for s in self._slices(t.shape, idx)]
                    meta[idx] = torch.empty(shape, dtype=t.dtype, device="meta")
                out.append(meta[idx])
                continue
            view = t[self._slices(t.shape, idx)]
            out.append(torch.empty(view.shape, dtype=t.dtype, device=dev).copy_(view))
        return out

    def unshard(self, blocks: list[torch.Tensor], device=None) -> torch.Tensor:
        """The tensor the ranks' ``blocks`` cut (concatenation in rank
        order, exact), on ``device`` (default: rank 0's)."""
        device = torch.device(device) if device is not None else blocks[0].device
        ndim = blocks[0].dim()
        parts = self.parts(ndim)
        first = {}  # block index -> the first rank holding it
        for idx, blk in zip(self.block_indices(ndim), blocks):
            first.setdefault(idx, blk)

        def cat(prefix: tuple, d: int):
            if d == ndim:
                return first[prefix].to(device)
            return torch.cat([cat(prefix + (i,), d + 1) for i in range(parts[d])], dim=d)

        return cat((), 0)


# ------------------------------------------------------- tensor parallelism
def tensor_parallel(cfg: ModelConfig) -> bool:
    """Whether the sharded programs compute ``cfg``'s "model"-split leaves
    tensor-parallel: the dense family without MLA. Every other family's
    leaves are gathered over "model" (``spmd``'s docstring names them)."""
    return cfg.family == "dense" and not cfg.use_mla


def model_dim(spec: P) -> int | None:
    """The dimension a spec splits over "model" alone, or None (not split
    over "model", or "model" folded with another axis)."""
    dims = [i for i, e in enumerate(spec) if e == "model"]
    return dims[0] if len(dims) == 1 else None


def model_split(specs: dict, cfg: ModelConfig, mesh: Mesh) -> frozenset:
    """The leaves (names of ``specs``) that stay split over "model" in a
    rank's program: under ``tensor_parallel(cfg)`` on a mesh whose "model"
    axis has more than one rank, with a native or Ozaki-II policy
    (``cfg.gemm``, else the context's: another emulated scheme has no exact
    split contraction), every leaf its spec splits over "model" alone (for
    the dense family: ``embed``, ``lm_head``, attention's ``wq``/``wk``/
    ``wv``/``wo`` and biases, the MLP's three matrices)."""
    pol = resolve_policy(cfg.gemm)
    if (not tensor_parallel(cfg) or mesh.axis_size("model") == 1
            or (pol.is_emulated and not pol.supports_plans)):
        return frozenset()
    return frozenset(k for k, s in specs.items() if model_dim(s) is not None)


def local_sharding(sharding: "NamedSharding", index: int) -> tuple["NamedSharding", list[int]]:
    """A model rank's block of a leaf split over "model", as the other
    axes place it: the sharding on the mesh of the other axes at ``index``
    along "model" (the spec's "model" entry dropped), and the ranks of the
    mesh that hold its blocks, in that sharding's rank order."""
    sub, ranks = sharding.mesh.sub("model", index)
    spec = P(*(None if e == "model" else e for e in sharding.spec))
    return NamedSharding(sub, spec), ranks


class Placed(NamedTuple):
    """A tensor as the ranks hold it: its sharding and one block a rank."""
    sharding: NamedSharding
    blocks: list

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def shape(self) -> torch.Size:
        """The shape of the tensor the blocks cut."""
        nd = self.blocks[0].dim()
        out = []
        for d in range(nd):
            lengths = {}
            for idx, b in zip(self.sharding.block_indices(nd), self.blocks):
                lengths.setdefault(idx[d], b.shape[d])
            out.append(sum(lengths.values()))
        return torch.Size(out)

    def unshard(self, device=None) -> torch.Tensor:
        return self.sharding.unshard(self.blocks, device)


def place(t: torch.Tensor, sharding: NamedSharding) -> Placed:
    return Placed(sharding, sharding.shard(t))


def named(mesh: Mesh, spec_tree: Any) -> Any:
    """``spec_tree`` with each spec a ``NamedSharding`` on ``mesh``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, Q8):
        return Q8(named(mesh, spec_tree.q), named(mesh, spec_tree.scale), spec_tree.shape)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    raise TypeError(f"named: a {type(spec_tree).__name__} is no spec")
