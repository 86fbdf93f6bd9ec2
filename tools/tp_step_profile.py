#!/usr/bin/env python3
"""Profile one training step of qwen2-7b at full width on one card, single
device and tensor-parallel on a (1, 4) mesh of the card, to see where the
tensor-parallel step's extra time goes:

    python3 tools/tp_step_profile.py [--layers 1] [--batch 2] [--seq 256]
                                     [--out experiments/tp_step_profile.json]

The config, policy (ozaki2-fp8/fast), batch and seed are chip_smoke.py
phase 15 (b)'s. Each step runs once to build the kernels and warm the
allocator, then once from a fresh state under ``torch.profiler`` (CPU and
CUDA activity) with CUDA events around it; the state is made and placed
before. For each step the script prints its wall time, the device time the
profiler saw (the sum of the CUDA kernels' and copies' times, and the share
of the wall time the card was idle), the device time by group (the
hand-written kernels by their ``__global__`` names, torch's own kernels),
and the top ops by device and by host time. The last lines
are the card (nvidia-smi name, power limit) and one JSON object; the full
tables go to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, POLICY = "qwen2-7b", "ozaki2-fp8/fast"
#: The hand-written kernels by their ``__global__`` names (csrc/).
KERNELS = {"gemm_core_kernel": "K1/K2 core", "raw_parts_kernel": "K1 prologue",
           "transpose_parts_kernel": "K2 transpose", "residue_gemm_": "K3/K4",
           "requant_garner_kernel": "K5", "quant_residues_kernel": "K6"}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def profile_step(fn, *args) -> tuple[object, dict]:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        t0 = time.perf_counter()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def device_us(e) -> float:  # kernels and copies only: an op's own entry repeats them
        if e.device_type != DeviceType.CUDA:
            return 0.0
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    device = sum(device_us(e) for e in events) / 1e3
    groups: dict = {}
    for e in events:
        t = device_us(e) / 1e3
        if t <= 0:
            continue
        name = next((v for k, v in KERNELS.items() if k in e.key), "torch's kernels and copies")
        g = groups.setdefault(name, {"device_ms": 0.0, "launches": 0})
        g["device_ms"] += t
        g["launches"] += e.count
    kernels = sorted(((device_us(e) / 1e3, e.key, e.count) for e in events if device_us(e) > 0),
                     reverse=True)[:25]
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count) for e in events),
                  reverse=True)[:25]
    rec = {"wall_ms": wall, "events_ms": start.elapsed_time(end), "device_ms": device,
           "idle_share": max(0.0, 1 - device / wall) if device else None,
           "device_by_group": groups,
           "top_device": [{"ms": t, "op": k, "calls": c} for t, k, c in kernels],
           "top_host_self": [{"ms": t, "op": k, "calls": c} for t, k, c in host]}
    return out, rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "experiments" / "tp_step_profile.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.distribution.spmd import make_sharded_train_step
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ARCH, "full"), num_layers=args.layers, gemm=POLICY)
    model = Model(cfg, device=dev)
    opt = AdamWConfig()
    init_state, single_step = make_train_step(model, opt)
    batch = synth_batch(DataConfig(seed=args.seed, batch=args.batch, seq_len=args.seq,
                                   vocab_size=cfg.vocab_size), cfg, 0)

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 16)
        return init_state(gen)

    mesh = make_host_mesh(1, 4, devices=dev)
    shard_state, tp_step, _ = make_sharded_train_step(model, opt, mesh)
    steps = {"single": (lambda: (fresh(), batch), single_step),
             "tp (1, 4)": (lambda: (shard_state(fresh()), batch), tp_step)}
    out = {"config": f"{ARCH} {args.layers} of 28 layers, full width", "policy": POLICY,
           "batch": [args.batch, args.seq]}
    for name, (prepare, step) in steps.items():
        step(*prepare())  # builds the kernels, warms the allocator
        torch.cuda.empty_cache()
        _, rec = profile_step(step, *prepare())
        out[name] = rec
        torch.cuda.empty_cache()
        print(f"{name}: wall {rec['wall_ms']:.1f} ms (events {rec['events_ms']:.1f}), device "
              f"{rec['device_ms']:.1f} ms, idle share "
              + (f"{rec['idle_share']:.3f}" if rec["idle_share"] is not None else "not measured"),
              flush=True)
        for k, v in sorted(rec["device_by_group"].items(), key=lambda kv: -kv[1]["device_ms"]):
            print(f"    {k}: {v['launches']} launches, device {v['device_ms']:.2f} ms",
                  flush=True)
        print("    top device ops: " + "; ".join(f"{d['op'][:48]} {d['ms']:.2f} ms x{d['calls']}"
                                                   for d in rec["top_device"][:10]), flush=True)
        print("    top host ops (self): " + "; ".join(
            f"{d['op'][:48]} {d['ms']:.2f} ms x{d['calls']}" for d in rec["top_host_self"][:10]),
            flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card())
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk in ("wall_ms", "device_ms", "idle_share", "device_by_group")}
                          if isinstance(v, dict) else v) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
