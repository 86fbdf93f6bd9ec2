"""Checkpointing with a manifest, async save and retention (the torch
counterpart of ``repro/checkpoint/manager.py``; one ``.npy`` per leaf and a
JSON manifest of ``format: 1``).

A tree is a nest of NamedTuples, tuples, lists, dicts (in sorted key
order, as JAX flattens them), ``nn.Module``s (their parameters, in
``named_parameters`` order), ``optim.Q8`` (``q``, ``scale``) and tensors,
the leaves. numpy has no bfloat16: a bf16 leaf is saved as its bits
(uint16) and the manifest records its dtype. ``restore`` loads into the
target's leaves in place, each on its own device and dtype; the
reference's elastic re-placement onto a restart mesh (``shardings=``)
waits for the distributed slice.
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

from repro_torch.optim.quantized import Q8


def _flatten(tree: Any, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) pairs of ``tree``, named as ``jax.tree_util.keystr``
    names a path (module parameters by their dotted names)."""
    if isinstance(tree, torch.Tensor):
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


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host, taken now (the step goes on updating
    the tensor in place while an async save writes)."""
    t = t.detach().to("cpu", copy=True)
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

    def restore(self, target_tree: Any, step: Optional[int] = None) -> tuple[int, Any]:
        """Load checkpoint ``step`` (default: the latest) into the leaves of
        ``target_tree``, in place; returns (step, target_tree)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _flatten(target_tree)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"leaf count mismatch: {len(leaves)} vs {len(manifest['leaves'])}")
        with torch.no_grad():
            for (_, ref), meta in zip(leaves, manifest["leaves"]):
                arr = np.load(os.path.join(path, meta["file"]))
                if list(arr.shape) != list(ref.shape):
                    raise ValueError(f"{meta['name']}: {arr.shape} vs {tuple(ref.shape)}")
                t = torch.from_numpy(arr)
                if meta["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                ref.copy_(t.to(ref.dtype))
        return step, target_tree
