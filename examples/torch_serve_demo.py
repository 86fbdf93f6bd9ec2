"""Serve a small model with batched requests on the PyTorch port: prefill +
decode through the typed KV caches (GQA / MLA / SSM), reporting per-phase
latency. Runs on ``--device``: the CUDA card by default (without one the
entry points raise; there is no CPU fallback), or ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_demo.py --arch mamba2-2.7b

The smoke configs set no ``gemm`` policy, so this demo serves natively;
examples/torch_serve_continuous.py serves under an emulated policy. The
first call's time includes the kernels' build and, under an emulated
policy, the weights' quantization.

NOTE: ``ServeEngine`` is the legacy aligned-batch API, now a thin wrapper
over the continuous-batching engine — see examples/torch_serve_continuous.py
and docs/serving.md for the current interface (in-flight batching, paged
KV, per-request accuracy classes). Like the reference's, it serves
token-only requests: the encoder-decoder and vit-stub configs' side inputs
are built here, and the engine refuses them.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import resolve_device
from repro_torch.models import Model
from repro_torch.serve import ServeEngine


def parser() -> argparse.ArgumentParser:
    """The driver's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, "smoke")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (args.batch, args.prompt_len)))}
    if cfg.frontend == "vit-stub":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.frontend_len, cfg.frontend_dim))).float()
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.frontend_dim))).float()

    engine = ServeEngine(model, params, max_len=args.prompt_len + args.gen + 8)
    t0 = time.perf_counter()
    out = engine.generate(batch, steps=args.gen)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"arch={cfg.name} family={cfg.family} device={dev}")
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. prefill+first call)")
    # decode-only timing
    t0 = time.perf_counter()
    out = engine.generate(batch, steps=args.gen)
    warm = time.perf_counter() - t0
    print(f"warm: {toks / warm:.1f} tok/s")
    assert bool(torch.all(out >= 0)) and bool(torch.all(out < cfg.vocab_size))
    print("OK")
    return {"tokens": out, "first_s": dt, "warm_s": warm}


if __name__ == "__main__":
    main()
