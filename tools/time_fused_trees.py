#!/usr/bin/env python3
"""Time K1 (ozmm_fused_raw) and K2 (ozmm_fused_parts) under ozaki2-fp8/fast
at n^3 from one or more source trees, each in a process of its own, in the
order given, on one CUDA card.

    python3 tools/time_fused_trees.py PARENT . . PARENT   # from a checkout's root
    python3 tools/time_fused_trees.py --size 4096 .

A tree is a checkout (or an unpacked ``git archive``) whose ``src`` holds
``repro_torch``; each builds its own kernels at first use. Both kernels run
on the same seeded lognormal (phi = 0.5) operands in every tree, timed by
CUDA events (``chip_smoke.cuda_times``: median, min and max of 5 after a
warm-up; the operands ``chip_smoke.lognormal``'s); each tree's line
also gives the sum of its products, so trees that must agree can be seen
to. Compare two versions only within one call, in turns (parent, change,
change, parent): cards and hosts differ between calls.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # chip_smoke's helpers


def one(tree: str, size: int) -> dict:
    """Times K1 and K2 from ``tree``'s ``src`` in this process."""
    sys.path.insert(0, f"{tree}/src")
    import torch

    from chip_smoke import cuda_times, lognormal
    from repro_torch import prepare_operand
    from repro_torch.core.scaling import compute_scaling
    from repro_torch.kernels import stack_parts
    from repro_torch.kernels.fused import (KERNEL_TILE, fused_parts_args, fused_raw_args,
                                           ozmm_fused_parts, ozmm_fused_raw)
    from repro_torch.precision import parse_policy

    def spread(fn) -> list[float]:
        times = cuda_times(fn)
        return [statistics.median(times), min(times), max(times)]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a, b = lognormal(gen, (size, size), 0.5, dev), lognormal(gen, (size, size), 0.5, dev)
    spec = "ozaki2-fp8/fast"
    ms = parse_policy(spec).moduli_set()
    scal = compute_scaling(a, b, ms, "fast")
    fa = fused_raw_args(a, scal.lmu, b, scal.lnu, ms, KERNEL_TILE)
    qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
    fp = fused_parts_args(stack_parts(qa.parts, ms), qa.lscale, stack_parts(qb.parts, ms),
                          qb.lscale, ms, KERNEL_TILE)
    sums = [ozmm_fused_raw(*fa, ms=ms).sum().item(), ozmm_fused_parts(*fp, ms=ms).sum().item()]
    return {"tree": tree, "card": torch.cuda.get_device_name(0), "size": size,
            "k1_ms": spread(lambda: ozmm_fused_raw(*fa, ms=ms)),
            "k2_ms": spread(lambda: ozmm_fused_parts(*fp, ms=ms)), "sums": sums}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", default=["."])
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.size)), flush=True)
        return 0
    failed = 0
    for tree in args.trees:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--one", tree, "--size", str(args.size)],
                              capture_output=True, text=True)
        print(proc.stdout.strip() or proc.stderr[-2000:], flush=True)
        print(f"  ({tree}: {time.perf_counter() - t0:.1f} s, rc {proc.returncode})", flush=True)
        failed |= proc.returncode
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
