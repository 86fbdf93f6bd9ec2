"""Validation on the PyTorch port: GPipe pipeline_apply == sequential stack,
on a 4-rank "stage" mesh.

The mesh is single-controller: one process drives every rank, and a mesh
may repeat a device, so the 4 stages run on ``--device`` (the CUDA card by
default; without one the entry points raise, there is no CPU fallback; or
``--device cpu``).

    PYTHONPATH=src python examples/torch_check_pipeline.py
"""
import argparse

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.distribution.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_mesh, use_mesh

S, M, MB, D = 4, 6, 8, 32


def stage_fn(w, h):
    return torch.tanh(h @ w)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device every stage runs on (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.standard_normal((S, D, D)) * 0.3).to(dev, torch.float32)
    x = torch.from_numpy(rng.standard_normal((M, MB, D))).to(dev, torch.float32)

    mesh = make_mesh((S,), ("stage",), devices=dev)
    with use_mesh(mesh):
        out = pipeline_apply(stage_fn, ws, x, mesh, axis="stage")

    ref = x
    for i in range(S):
        ref = torch.tanh(ref @ ws[i])

    err = float(torch.max(torch.abs(out - ref)))
    print(f"pipeline vs sequential max err: {err:.2e}")
    assert err < 1e-6
    print("OK: GPipe schedule matches the sequential stack.")
    return err


if __name__ == "__main__":
    main()
