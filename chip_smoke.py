#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its elapsed time; any failed check raises and the
script exits non-zero without printing a result:

1. card: name and power limit; build of the CUDA kernels from csrc/.
2. MMA probe: the fused kernel's own k32 FP8 MMA step on +-16 and mixed
   e4m3 patterns at k up to 65536 against an int64 product; also reports
   whether a plain f32 accumulation across k steps would have been exact.
3. kernel vs plain version, bitwise (torch.equal), at 1024^3, 1000x997x1003
   and the main-path size, for ozaki2-fp8 fast/accurate, ozaki2-karatsuba
   fast and ozaki2-int8 fast; and against the port's '+core' route.
4. main path: ozmm(a, b, "ozaki2-fp8/accurate") and ".../fast" through
   backend auto at the main-path size; the kernel's launch count must move;
   normwise error vs cuBLAS DGEMM <= 2^-44; integer inputs reproduce A @ B
   to rtol 1e-14 (the reference's own gate, tests/core/test_ozmm_accuracy.py:
   the f64-rounded Garner weights leave ~1 ulp) and bit for bit on a rerun.
5. timings: median of 5 CUDA-event-timed runs after a warm-up, for the
   kernel, its plain version and cuBLAS DGEMM (torch.matmul in float64, a
   yardstick the port never calls), with the kernel's roofline bound.

The last two lines are the card (nvidia-smi name, power limit) and
{"ok": true, "device": {...}}; before them a {"kernels": [...]} line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
#: sheet): HBM bytes/s, and FP8 = int8 tensor operations/s.
H100_BYTES_PER_S = 3.35e12
H100_FP8_OPS_PER_S = 1.979e15
POLICIES = ("ozaki2-fp8/fast", "ozaki2-fp8/accurate", "ozaki2-karatsuba/fast",
            "ozaki2-int8/fast")
TIMED = ("ozaki2-fp8/fast", "ozaki2-fp8/accurate", "ozaki2-int8/fast")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[phase] {name} done in {now - t0:.1f} s", flush=True)
    return now


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def lognormal(gen, shape, phi, device):
    """The paper's §V-A generator, (rand - 0.5) * exp(randn * phi), on the card."""
    import torch

    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    return (u - 0.5) * torch.exp(z * phi)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn on the card (CUDA events), after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_equal(x, y, what: str) -> None:
    """Bitwise equality (torch.equal); on failure, name the first difference."""
    import torch

    if torch.equal(x, y):
        return
    if x.shape != y.shape or x.dtype != y.dtype:
        raise SmokeFailure(f"{what}: {x.dtype} {tuple(x.shape)} vs {y.dtype} {tuple(y.shape)}")
    diff = (x != y).nonzero()
    nans = (int(torch.isnan(x).sum()), int(torch.isnan(y).sum()))
    if len(diff) == 0:
        raise SmokeFailure(f"{what}: no element differs but NaNs {nans}")
    idx = tuple(int(i) for i in diff[0])
    raise SmokeFailure(f"{what}: {len(diff)} elements differ, NaNs {nans}; first at "
                       f"{idx}: {x[idx].item()!r} vs {y[idx].item()!r}")


def probe_operands(k: int, device):
    """A (16, k) and B (k, 8) e4m3 patterns: all +16, alternating +-16 (two
    phases), +16 then +1 (a small tail after a large running sum), and
    seeded random integers in [-16, 16]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    idx = np.arange(k)
    alt = np.where(idx % 2 == 0, 16, -16)
    alt2 = np.where((idx // 2) % 2 == 0, 16, -16)
    tail = np.where(idx < k // 2, 16, 1)
    a = rng.integers(-16, 17, (16, k))
    a[0], a[1], a[2], a[3] = 16, alt, tail, alt2
    b = rng.integers(-16, 17, (k, 8))
    b[:, 0], b[:, 1], b[:, 2], b[:, 3] = 16, alt, tail, alt2
    f8 = lambda x: torch.tensor(x, dtype=torch.float32, device=device).to(torch.float8_e4m3fn)
    return f8(a), f8(b), torch.tensor(a) @ torch.tensor(b)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192,
                    help="m = n = k of the main path (default 8192)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    from repro_torch import ozmm
    from repro_torch.core import gemm
    from repro_torch.core.moduli import DEFAULT_NUM_MODULI
    from repro_torch.core.scaling import compute_scaling
    from repro_torch.kernels import build
    from repro_torch.kernels.fused import (KERNEL_TILE, fused_raw_args, kernel,
                                           mma_probe, ozmm_fused_raw,
                                           ozmm_fused_raw_ref)
    from repro_torch.precision import parse_policy

    dev = torch.device("cuda")
    t0 = t_start = time.perf_counter()

    # ---- 1. card + build ------------------------------------------------
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(dev)}", flush=True)
    tb = time.perf_counter()
    kernel._load()
    print(f"build: fused_raw.cu -> {build.library_path('fused_raw.cu').name} "
          f"in {time.perf_counter() - tb:.1f} s", flush=True)
    log = build.library_path("fused_raw.cu").with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    t0 = phase("1 card+build", t0)

    # ---- 2. MMA probe -----------------------------------------------------
    chained_exact = True
    for k in (32, 1024, 4096, 65536):
        a8, b8, want = probe_operands(k, dev)
        exact, chained = mma_probe(a8, b8)
        torch.cuda.synchronize()
        check(torch.equal(exact.cpu().long(), want),
              f"MMA probe k={k}: the kernel's per-step product is not exact")
        chained_ok = torch.equal(chained.cpu().double(), want.double())
        chained_exact &= chained_ok
        worst = (chained.cpu().double() - want.double()).abs().max().item()
        print(f"  probe k={k}: per-k32-step int32 exact; plain f32 chain "
              f"{'exact' if chained_ok else f'NOT exact (max err {worst})'}")
    print(f"B1 probe: plain f32 accumulation across k steps would "
          f"{'also be' if chained_exact else 'NOT be'} exact up to k=65536", flush=True)
    t0 = phase("2 mma-probe", t0)

    # ---- 3. kernel vs plain version vs core, bitwise ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    big = args.size
    for m, k, n in ((1024, 1024, 1024), (1000, 997, 1003), (big, big, big)):
        a = lognormal(gen, (m, k), 0.5, dev)
        b = lognormal(gen, (k, n), 0.5, dev)
        for spec in POLICIES:
            pol = parse_policy(spec)
            ms = pol.moduli_set()
            scal = compute_scaling(a, b, ms, pol.mode)
            fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
            got = ozmm_fused_raw(*fa, ms=ms)
            plain = ozmm_fused_raw_ref(*fa, ms=ms)
            torch.cuda.synchronize()
            check_equal(got, plain, f"{spec} {m}x{k}x{n}: kernel vs plain version")
            core = ozmm(a, b, spec + "+core")
            check_equal(got[:m, :n], core, f"{spec} {m}x{k}x{n}: kernel vs +core")
            print(f"  {spec:24s} {m}x{k}x{n}: kernel == plain == core (bitwise)",
                  flush=True)
            del fa, got, plain, core
        del a, b
        torch.cuda.empty_cache()
    t0 = phase("3 kernel-vs-plain", t0)

    # ---- 4. main path ---------------------------------------------------------
    a = lognormal(gen, (big, big), 0.5, dev)
    b = lognormal(gen, (big, big), 0.5, dev)
    check(gemm._resolve_backend(parse_policy("ozaki2-fp8/accurate"), dev) == "pallas",
          "backend auto did not resolve to the kernel route on this card")
    ozmm_fused_raw.launches = 0
    out = {spec: ozmm(a, b, spec) for spec in ("ozaki2-fp8/accurate", "ozaki2-fp8/fast")}
    torch.cuda.synchronize()
    main_launches = ozmm_fused_raw.launches
    check(main_launches >= 1, "the main path never launched ozmm_fused_raw")
    dgemm = torch.matmul(a, b)
    for spec, c in out.items():
        check(c.shape == (big, big) and bool(torch.isfinite(c).all()),
              f"{spec}: output not finite or of the wrong shape")
        err = (torch.linalg.norm(c - dgemm) / torch.linalg.norm(dgemm)).item()
        print(f"  {spec}: normwise error vs cuBLAS DGEMM {err:.3e} (gate 2^-44)")
        check(err <= 2.0 ** -44, f"{spec}: normwise error {err} > 2^-44")
    del out, dgemm
    gi = torch.Generator(device=dev)
    gi.manual_seed(args.seed + 1)
    ai = torch.randint(-8, 9, (1024, 1024), generator=gi, device=dev).double()
    bi = torch.randint(-8, 9, (1024, 1024), generator=gi, device=dev).double()
    exact = ai @ bi  # |sums| <= 2^16: exact in any order
    for spec in ("ozaki2-fp8/accurate", "ozaki2-fp8/fast"):
        c = ozmm(ai, bi, spec)
        check(bool(((c - exact).abs() <= 1e-14 * exact.abs()).all()),
              f"{spec}: integer inputs not reproduced to rtol 1e-14")
        check(torch.equal(c, ozmm(ai, bi, spec)), f"{spec}: a rerun changed bits")
        rel = ((c - exact).abs() / exact.abs().clamp(min=1)).max().item()
        print(f"  {spec}: integer inputs 1024^3, max rel err {rel:.3e}, "
              f"{int((c != exact).sum())} of {c.numel()} not exact; rerun bitwise")
    print(f"  main path: {main_launches} launches of ozmm_fused_raw for 2 ozmm "
          "calls", flush=True)
    t0 = phase("4 main-path", t0)

    # ---- 5. timings -----------------------------------------------------------
    rows = []
    library_ms = cuda_ms(lambda: torch.matmul(a, b))
    for spec in TIMED:
        pol = parse_policy(spec)
        ms = pol.moduli_set()
        scal = compute_scaling(a, b, ms, pol.mode)
        fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
        got = ozmm_fused_raw(*fa, ms=ms)
        plain = ozmm_fused_raw_ref(*fa, ms=ms)
        max_err = (got - plain).abs().max().item()
        del got, plain
        ms_kernel = cuda_ms(lambda: ozmm_fused_raw(*fa, ms=ms))
        ms_plain = cuda_ms(lambda: ozmm_fused_raw_ref(*fa, ms=ms))
        # where an ozmm call's time goes: scaling, raw frames + padding, kernel
        layers = {"ozmm_ms": cuda_ms(lambda: ozmm(a, b, spec)),
                  "scaling_ms": cuda_ms(lambda: compute_scaling(a, b, ms, pol.mode)),
                  "frames_ms": cuda_ms(lambda: fused_raw_args(a, scal.lmu, b, scal.lnu,
                                                              ms, KERNEL_TILE))}
        n_bytes = sum(t.numel() * t.element_size() for t in fa) + big * big * 8
        products = ms.n if ms.family == "int8" else 3 * ms.n
        n_ops = products * 2 * big ** 3
        t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_FP8_OPS_PER_S * 1e3
        rows.append({
            "name": "ozmm_fused_raw", "policy": spec, "shape": [big, big, big],
            "num_moduli": ms.n, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_raw.cu",
            "replaces": "src/repro/kernels/fused/kernel.py:238",
            "launches": main_launches, "max_abs_err": max_err,
            "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms, **layers})
        print(f"  {spec:20s} kernel {ms_kernel:.2f} ms, plain {ms_plain:.2f} ms, "
              f"bound {max(t_bytes, t_ops):.2f} ms, cuBLAS DGEMM {library_ms:.2f} ms, "
              f"max|kernel-plain| {max_err}; ozmm {layers['ozmm_ms']:.2f} ms = scaling "
              f"{layers['scaling_ms']:.2f} + frames {layers['frames_ms']:.2f} + kernel "
              f"+ rest", flush=True)
        del fa
        torch.cuda.empty_cache()
    check(all(r["max_abs_err"] == 0.0 for r in rows), "kernel and plain version differ")
    t0 = phase("5 timings", t0)
    print(json.dumps({"k1_by_policy": rows}))
    print(f"total {time.perf_counter() - t_start:.1f} s; DEFAULT_NUM_MODULI "
          f"{DEFAULT_NUM_MODULI}", flush=True)

    main = next(r for r in rows if r["policy"] == "ozaki2-fp8/accurate")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: main[k] for k in keys}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
