"""Continuous-batching tour on the PyTorch port: requests with mixed accuracy
classes, priorities and deadlines flowing through one BatchingEngine (paged
KV cache, in-flight joins/leaves, policy-grouped adaptive precision —
docs/serving.md). Runs on ``--device``: the CUDA card by default (without
one the entry points raise; there is no CPU fallback), or ``--device cpu``.

Under an emulated fast-mode policy every matmul weight is quantized once
into a residue plan; on the card each of those GEMMs runs on the fused
kernel K2, and a GEMM on a raw operand (a tied lm_head) on K1. The first
call's time includes the kernels' build.

    PYTHONPATH=src python examples/torch_serve_continuous.py
    PYTHONPATH=src python examples/torch_serve_continuous.py --arch mamba2-2.7b \
        --gemm native   # dense slot-pool fallback, no accuracy classes
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import resolve_device
from repro_torch.models import Model
from repro_torch.serve import BatchingEngine, RequestStatus


def parser() -> argparse.ArgumentParser:
    """The driver's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS)
    ap.add_argument("--gemm", default="ozaki2-fp8/fast",
                    help="base precision policy ('native' disables accuracy "
                         "classes: nothing to adapt)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(get_config(args.arch, "smoke"), gemm=args.gemm)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)

    engine = BatchingEngine(model, params, max_len=32, max_slots=args.slots,
                            page_size=8)
    print(f"arch={cfg.name} family={cfg.family} "
          f"{'paged' if engine.paged else 'dense slot pool'} "
          f"base_policy={engine.policy.spec} device={dev}")

    adaptive = engine.policy.supports_plans
    classes = ["relaxed", None] if adaptive else [None]
    rids = {}
    for i in range(args.requests):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size,
                                               int(rng.integers(4, 12)))]
        acc = classes[i % len(classes)]
        # generous deadline: the knob is demonstrated, not (normally) hit
        rids[engine.submit(prompt, max_new_tokens=args.gen, accuracy=acc,
                           priority=i % 3,
                           deadline=None if i % 5 else 600.0)] = acc
    # one request that can never fit: rejected, not deadlocked
    doomed = engine.submit(list(range(1, 30)), max_new_tokens=args.gen)

    t0 = time.perf_counter()
    results = engine.run()
    dt = time.perf_counter() - t0

    assert results[doomed].status is RequestStatus.REJECTED
    done = sum(results[r].status is RequestStatus.FINISHED for r in rids)
    print(f"{done}/{len(rids)} finished (+1 oversized rejected) in {dt:.2f}s "
          f"({done * args.gen / dt:.1f} tok/s incl. first call)")
    for rid, acc in list(rids.items())[:4]:
        res = results[rid]
        print(f"  req {rid}: accuracy={acc or 'base':8s} -> "
              f"policy={res.policy_spec}  ttft={res.ttft * 1e3:6.1f}ms  "
              f"tokens={res.tokens[:4]}...")
    st = engine.stats()
    print(f"groups={list(st['groups'])} "
          f"weight_cache={st['weight_cache_nbytes'] / 1e6:.1f}MB "
          f"steps={st['steps']} decode_tokens={st['decode_tokens']}")
    for spec, g in st["groups"].items():
        print(f"  {spec}: prefill_traces={g['prefill_traces']} "
              f"decode_traces={g['decode_traces']} free_pages={g['free_pages']}")
    print("OK")
    return {"results": results, "requests": rids, "rejected": doomed, "seconds": dt,
            "stats": st}


if __name__ == "__main__":
    main()
