"""Quickstart on the PyTorch port: FP64 GEMM emulation on FP8/INT8 paths.

Precision is one compact policy spec: ``"<scheme>/<mode>[@arity]"``
(see docs/precision.md for the grammar, context stack and resolver).
The operands live on ``--device``: the CUDA card by default (without one
the entry points raise; there is no CPU fallback), or ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The route column is read off the kernel counters: "K1" is the fused
Hopper kernel (``ozmm_fused_raw``), "K1 plain" its plain PyTorch version
(a ``+pallas`` spec on the CPU), "core" the torch core executor. A bare
Ozaki-II spec takes the kernel route on a compute-capability-9.0 card and
the core route elsewhere; ``ozaki1-fp8`` always runs on core. So the
closing check spells both routes out: ``+pallas`` against ``+core``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ozmm, resolve_device, use_policy
from repro_torch.kernels import ozmm_fused_raw, ozmm_fused_raw_ref
from repro_torch.precision import parse_policy

M = N = 256
K = 2048
SPECS = [("ozaki2-fp8@12", "37 (3N+1)"),
         ("ozaki2-karatsuba@13", "40 (3N+1)"),
         ("ozaki2-int8@14", "15 (N+1)"),
         ("ozaki1-fp8@11", "121 (S^2)")]


def operands(device):
    """The seeded 256 x 2048 and 2048 x 256 f64 operands on ``device``."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K))
    b = rng.standard_normal((K, N))
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def routed(fn):
    """fn()'s product on the host, and the route it took."""
    before = (ozmm_fused_raw.launches, ozmm_fused_raw_ref.calls)
    c = fn().cpu().numpy()
    if ozmm_fused_raw.launches > before[0]:
        return c, "K1"
    return c, "K1 plain" if ozmm_fused_raw_ref.calls > before[1] else "core"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the operands (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    A, B = operands(dev)
    a, b = A.cpu().numpy(), B.cpu().numpy()
    C_ref = a @ b
    denom = np.abs(a) @ np.abs(b)

    print(f"emulating {M}x{K}x{N} FP64 GEMM via low-precision MMA paths on {dev}\n")
    print(f"{'policy spec':<28} {'#8-bit GEMMs':<13} {'route':<9} norm. error")
    rows = []
    for base, gemms in SPECS:
        scheme, _, arity = base.partition("@")
        for mode in ("fast", "accurate"):
            spec = f"{scheme}/{mode}@{arity}"
            C, route = routed(lambda: ozmm(A, B, spec, device=dev))
            err = float(np.max(np.abs(C - C_ref) / denom))
            rows.append({"spec": spec, "gemms": gemms, "route": route, "err": err, "c": C})
            print(f"{spec:<28} {gemms:<13} {route:<9} 2^{np.log2(err):6.1f}")

    print("\nunit roundoff is 2^-53: the emulation is FP64-grade.")

    # Accuracy-targeted resolution: let the policy pick its modulus count from
    # the operands' exponent-range sketch and a target error.
    pol = parse_policy("ozaki2-fp8/accurate").resolve_for(A, B, target_rel_err=2.0 ** -40)
    C_pol = ozmm(A, B, pol, device=dev).cpu().numpy()
    err = float(np.max(np.abs(C_pol - C_ref) / denom))
    print(f"\nresolve_for(target=2^-40) picked {pol.spec}: err = 2^{np.log2(err):.1f}")

    # Context stack: scope a policy instead of threading kwargs.
    with use_policy("ozaki2-fp8/fast@12+core"):
        C_ctx = ozmm(A, B, device=dev)

    print("Pallas kernel path (bitwise-identical):")
    Cp, route = routed(lambda: ozmm(A, B, "ozaki2-fp8/fast@12+pallas", device=dev))
    equal = torch.equal(torch.from_numpy(Cp), C_ctx.cpu())
    print(f"  pallas ({route}) == core: {equal}")
    return {"rows": rows, "resolved": {"spec": pol.spec, "err": err},
            "pallas_route": route, "pallas_equals_core": equal}


if __name__ == "__main__":
    main()
