"""Checkpointing with a manifest, async save and retention (the torch
counterpart of ``repro/checkpoint/manager.py``; one ``.npy`` per leaf and a
JSON manifest of ``format: 1``).

A tree is a nest of NamedTuples, tuples, lists, dicts (in sorted key
order, as JAX flattens them), ``nn.Module``s (their parameters, in
``named_parameters`` order), ``optim.Q8`` (``q``, ``scale``) and tensors,
the leaves. numpy has no bfloat16: a bf16 leaf is saved as its bits
(uint16) and the manifest records its dtype. A leaf placed on a mesh
(``distribution.sharding.Placed``: a sharding and its ranks' blocks) is
saved whole, its blocks gathered. ``restore`` pairs the target's leaves with
the checkpoint's by name and loads into them in place, each on its own
device and dtype (a placed leaf into its blocks); with ``shardings=`` it
re-places every loaded leaf as that sharding's blocks instead: the
reference's elastic restore onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.distribution.sharding import Placed
from repro_torch.optim.quantized import Q8


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs of ``tree``, named as ``jax.tree_util.keystr``
    names a path (module parameters by their dotted names)."""
    if isinstance(tree, (torch.Tensor, Placed)):
        return [(path, tree)]
    if isinstance(tree, Q8):
        return [(path + ".q", tree.q), (path + ".scale", tree.scale)]
    if isinstance(tree, nn.Module):
        return [(f"{path}.{k}", p) for k, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for k in tree._fields for leaf in _flatten(getattr(tree, k), f"{path}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, x in enumerate(tree) for leaf in _flatten(x, f"{path}[{i}]")]
    raise TypeError(f"{path or 'tree'}: cannot checkpoint a {type(tree).__name__}")


def _canonical(name: str) -> str:
    """A leaf name with dict keys written as attributes: a module's
    parameters (``.params.embed``) and a dict of them (``.params['embed']``,
    as a sharded state holds them) name the same leaf."""
    return name.replace("['", ".").replace("']", "")


def _to_host(t) -> np.ndarray:
    """A copy of ``t`` on the host, taken now (the step goes on updating
    the tensor in place while an async save writes)."""
    t = t.unshard("cpu") if isinstance(t, Placed) else t.detach().to("cpu", copy=True)
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        leaves = _flatten(tree)
        host = [(name, _to_host(t), str(t.dtype).removeprefix("torch."))
                for name, t in leaves]  # device->host copy now

        def _write():
            tmp = tempfile.mkdtemp(dir=self.dir)
            manifest = {"step": step, "leaves": [], "time": time.time(), "format": 1}
            for i, (name, arr, dtype) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"name": name, "file": fn, "shape": list(arr.shape), "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):  # idempotent re-save of the same step
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.rename(tmp, final)  # atomic publish
            self._gc()

        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[int, Any]:
        """Load checkpoint ``step`` (default: the latest); returns (step,
        tree). Without ``shardings`` the leaves of ``target_tree`` are loaded
        in place and it is returned. ``shardings``, one ``NamedSharding`` or
        a tree of them shaped as ``target_tree`` (a module's parameters as a
        dict by name, as ``distribution.named`` gives them), re-places every
        loaded leaf as its sharding's blocks: the tree comes back with each
        leaf a ``Placed`` (a module as a dict of them), the target's leaves
        giving only shapes and dtypes. Leaves pair with the checkpoint's by
        name (a module's parameter and a dict's entry of the same name are
        one leaf, ``_canonical``); a target leaf the checkpoint does not
        name raises."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _flatten(target_tree)
        metas = manifest["leaves"]
        if len(leaves) != len(metas):
            raise ValueError(f"leaf count mismatch: {len(leaves)} vs {len(metas)}")
        by_name = {_canonical(m["name"]): m for m in metas}
        for name, _ in leaves:
            if _canonical(name) not in by_name:
                raise ValueError(f"{name}: no such leaf in checkpoint step {step}")
        metas = [by_name[_canonical(n)] for n, _ in leaves]

        def load(ref, meta) -> torch.Tensor:
            arr = np.load(os.path.join(path, meta["file"]))
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{meta['name']}: {arr.shape} vs {tuple(ref.shape)}")
            t = torch.from_numpy(arr)
            return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t

        if shardings is not None:
            loaded = {n: load(_shape_of(ref), meta) for (n, ref), meta in zip(leaves, metas)}
            return step, _placed_like(target_tree, shardings, loaded, "")
        with torch.no_grad():
            for (_, ref), meta in zip(leaves, metas):
                t = load(_shape_of(ref), meta)
                if isinstance(ref, Placed):
                    for r, blk in enumerate(ref.blocks):
                        blk.copy_(ref.sharding.block(t, r).to(ref.dtype))
                else:
                    ref.copy_(t.to(ref.dtype))
        return step, target_tree


def _shape_of(ref) -> Any:
    """A leaf, or a placed leaf's whole tensor on ``meta`` (its shape and
    dtype, nothing moved)."""
    return ref.unshard("meta") if isinstance(ref, Placed) else ref


def _placed_like(tree: Any, shardings: Any, loaded: dict, path: str) -> Any:
    """``tree``'s structure with each leaf the loaded tensor placed as its
    sharding (``shardings``: one sharding, or a tree shaped as ``tree``)."""
    single = hasattr(shardings, "shard")

    def sub(key):
        return shardings if single else shardings[key]

    if isinstance(tree, (torch.Tensor, Placed)):
        return Placed(shardings, shardings.shard(loaded[path].to(tree.dtype)))
    if isinstance(tree, Q8):
        return Q8(_placed_like(tree.q, shardings if single else shardings.q, loaded, path + ".q"),
                  _placed_like(tree.scale, shardings if single else shardings.scale, loaded,
                               path + ".scale"), tree.shape)
    if isinstance(tree, nn.Module):
        return {k: _placed_like(p, sub(k), loaded, f"{path}.{k}")
                for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _placed_like(tree[k], sub(k), loaded, f"{path}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_placed_like(getattr(tree, k), sub(i), loaded, f"{path}.{k}")
                            for i, k in enumerate(tree._fields)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_placed_like(x, sub(i), loaded, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    raise TypeError(f"{path or 'tree'}: cannot restore a {type(tree).__name__}")
