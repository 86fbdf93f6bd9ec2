#!/usr/bin/env python3
"""Time variants of K5 (src/repro_torch/csrc/requant_garner.cu, its f64
mode) and K6 (src/repro_torch/csrc/quant_residues.cu, its f64 entry) on one
card, each with one part of its work taken out, to see which part bounds
the kernel:

    python3 tools/kernel_variants.py [--size 8192]

Each variant is the kernel's sources (csrc/, copied) with one line replaced;
the script fails if a line it replaces is not found. K6:
  full        the kernel as it is;
  no_split    the split table left out: the residue itself is stored as the
              part word;
  no_residue  the residue arithmetic left out: the part word is taken for a
              residue made from the element's exponent (the loads, the bit
              decoding, the table read and the stores stay);
  bytes_only  the residue and the table left out: the element's exponent is
              stored as the part word (the loads, the decoding and the
              stores stay);
  no_store    the part words computed and not stored (a store is kept under
              a condition that never holds, so nothing is eliminated).
K5:
  full        the kernel as it is;
  no_garner   the Garner steps left out (each digit is its residue): the
              loads, the combine, the Kahan sum and the stores stay;
  no_load     the product planes not read: each value is made from its
              offset (the arithmetic and the stores stay);
  no_store    C computed and not stored (as K6's);
  four_elem   4 consecutive elements a thread, as one 16-byte load per
              plane and two 16-byte stores of C (the kernel takes 2).

Variants are built with the kernels' own nvcc flags, all in parallel, into
the build directory, and run on the pipeline's own operands of an
m = n = k = size lognormal product under fast scaling, for ozaki2-fp8
(N = 12) and ozaki2-int8 (N = 14): median of 5 CUDA-event runs after a
warm-up, beside each kernel's bytes bound (3.35 TB/s). Each variant is one
launch of the kernel's grid. The last lines are the card (nvidia-smi name,
power limit) and one JSON object of the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12
K6_LOOKUP = "w[u] = part_word<INT8>(residue(x[h][u], k, pw), k, split);"
K6_STORE = ("__stcs(reinterpret_cast<unsigned int*>(dst[q] + plane + at[h]), "
            "plane_word(w, q));")
K5_LOAD = "const uint2 w = __ldcs(reinterpret_cast<const uint2*>(src + o));"
K5_STORE = "__stcs(reinterpret_cast<double2*>(out + i0), make_double2(v[0], v[1]));"
K5_FOUR = [
    ("requant_garner.cu", "constexpr int E = 2; ", "constexpr int E = 4; "),
    ("requant_garner.cu", "sizeof(T) == 4 && E == 2", "sizeof(T) == 4 && E == 4"),
    ("requant_garner.cu", K5_LOAD + """
    x[0] = *reinterpret_cast<const T*>(&w.x);
    x[1] = *reinterpret_cast<const T*>(&w.y);""",
     """const uint4 w = __ldcs(reinterpret_cast<const uint4*>(src + o));
    x[0] = *reinterpret_cast<const T*>(&w.x);
    x[1] = *reinterpret_cast<const T*>(&w.y);
    x[2] = *reinterpret_cast<const T*>(&w.z);
    x[3] = *reinterpret_cast<const T*>(&w.w);"""),
    ("requant_garner.cu", K5_STORE, K5_STORE + " __stcs(reinterpret_cast<double2*>(out + i0) + 1, "
     "make_double2(v[2], v[3]));"),
    ("requant_garner.cu", "aligned8(ci) : aligned8(c1) && aligned8(c2) && aligned8(c3)",
     "aligned16(ci) : aligned16(c1) && aligned16(c2) && aligned16(c3)"),
]
#: kernel -> (source, {variant: [(file, old line, new line)]})
VARIANTS = {
    "K6": ("quant_residues.cu", {
        "full": [],
        "no_split": [("quant_residues.cu", K6_LOOKUP, "w[u] = static_cast<uint32_t>("
                      "ozaki::small_to_int(residue(x[h][u], k, pw)));")],
        "no_residue": [("quant_residues.cu", K6_LOOKUP, "w[u] = part_word<INT8>("
                        "ozaki::small_to_float((x[h][u].e & 127) - 64), k, split);")],
        "bytes_only": [("quant_residues.cu", K6_LOOKUP,
                        "w[u] = static_cast<uint32_t>(x[h][u].e);")],
        "no_store": [("quant_residues.cu", K6_STORE,
                      "if (plane_word(w, q) == 0x01020304u) " + K6_STORE)],
    }),
    "K5": ("requant_garner.cu", {
        "full": [],
        "no_garner": [("fused_common.cuh",
                       "for (int j = 0; j < d; ++j) {  // crt.garner_digits' step",
                       "for (int j = 0; j < 0; ++j) {  // crt.garner_digits' step")],
        "no_load": [("requant_garner.cu", K5_LOAD,
                     "const uint2 w = make_uint2(static_cast<uint32_t>(o) & 0x3FFF, "
                     "static_cast<uint32_t>(o >> 2) & 0x3FFF);")],
        "no_store": [("requant_garner.cu", K5_STORE,
                      "if (v[0] == 1.25 && v[1] == -3.5) " + K5_STORE)],
        "four_elem": K5_FOUR,
    }),
}


def build_variants(out_dir: Path) -> dict:
    """Writes each variant's sources to its own directory and builds them
    all at once; returns {(kernel, variant): library}."""
    from repro_torch.kernels import build

    jobs = {}
    for kernel, (source, variants) in VARIANTS.items():
        for name, patches in variants.items():
            vdir = out_dir / f"{kernel}_{name}"
            if vdir.exists():
                shutil.rmtree(vdir)
            shutil.copytree(build.CSRC, vdir)
            for fname, old, new in patches:
                text = (vdir / fname).read_text()
                if old not in text:
                    raise SystemExit(f"kernel_variants: {kernel} {name}: line not found in "
                                     f"{fname}: {old}")
                (vdir / fname).write_text(text.replace(old, new))
            lib = vdir / "variant.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(vdir / source)]
            jobs[kernel, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: nvcc failed building {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


class Using:
    """Points ``module._load`` at ``lib`` (with the kernel's own argument
    types) while in the block."""

    def __init__(self, module, lib, entry: str):
        main = getattr(module._load(), entry)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = main.argtypes, ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        self.module, self.lib = module, lib

    def __enter__(self):
        self.orig = self.module._load
        self.module._load = lambda: self.lib

    def __exit__(self, *exc):
        self.module._load = self.orig


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=8192)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels as kn
    from repro_torch.core import scaling
    from repro_torch.core.plan import pow2_tables
    from repro_torch.kernels import build, pipeline
    from repro_torch.kernels.crt_reconstruct import kernel as k5
    from repro_torch.kernels.quant_residues import kernel as k6
    from repro_torch.precision import parse_policy

    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, lognormal, nvidia_smi

    card = nvidia_smi()
    libs = build_variants(build.build_dir() / "variants")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = args.size
    a, b = lognormal(gen, (n, n), 0.5, dev), lognormal(gen, (n, n), 0.5, dev)
    results = []
    for spec in ("ozaki2-fp8/fast", "ozaki2-int8/fast"):
        ms = parse_policy(spec).moduli_set()
        scal = scaling.compute_scaling(a, b, ms, "fast")
        tables = pow2_tables(ms, dev)
        sa = kn.quant_residues_f64(a, scal.lmu, tables, ms=ms)
        sbt = kn.quant_residues_f64(pipeline.k_major(b), scal.lnu, tables, ms=ms)
        cparts = pipeline.residue_gemms(sa, sbt, ms)
        n_out = ms.n if ms.family == "int8" else 3 * ms.n
        runs = {"K6": (k6, "quant_residues_launch", (8 + n_out) * n * n,
                       lambda: kn.quant_residues_f64(a, scal.lmu, tables, ms=ms)),
                "K5": (k5, "requant_garner_launch", (4 * n_out + 8) * n * n,
                       lambda: kn.requant_garner(cparts, ms=ms, lmu=scal.lmu, lnu=scal.lnu))}
        for kernel, (module, entry, n_bytes, run) in runs.items():
            row = {"kernel": kernel, "policy": spec, "shape": [n, n, n], "num_moduli": ms.n,
                   "bound_ms": n_bytes / H100_BYTES_PER_S * 1e3}
            want = run()
            for name in VARIANTS[kernel][1]:
                with Using(module, libs[kernel, name], entry):
                    if name == "full":
                        got = run()
                        for g, w in zip(*((x,) if isinstance(x, torch.Tensor) else x
                                          for x in (got, want))):
                            if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                                raise SystemExit(f"kernel_variants: {kernel}'s full variant "
                                                 "differs from the kernel")
                        del got
                    row[f"{name}_ms"] = cuda_ms(run)
            del want
            results.append(row)
            print(f"  {kernel} {spec}: " + ", ".join(
                f"{k[:-3]} {v:.3f} ms" for k, v in row.items() if k.endswith("_ms")), flush=True)
        del sa, sbt, cparts
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"kernel_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
