"""Build the CUDA sources of ``repro_torch/csrc`` into shared libraries with a
plain C interface and load them with ``ctypes``.

``nvcc`` compiles for ``sm_90a`` at first use, into a directory keyed by a
hash of the sources and flags, so a changed source is never served a stale
library; ``build_all`` runs one nvcc per source, all at once, and the first
``load_library`` builds every source of ``SOURCES`` that way. The directory
is ``$REPRO_TORCH_BUILD_DIR`` when set, else ``repro_torch/_build`` beside
the package (listed in ``.gitignore``). Each build leaves ``<name>.log``
beside the library, with ptxas's register, shared-memory and spill report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
#: Every kernel source, one library each.
SOURCES = tuple(sorted(p.name for p in CSRC.glob("*.cu")))

# No --use_fast_math: it brings approximate division and flush-to-zero.
# --fmad=false keeps nvcc from contracting a multiply and an add into an FMA
# where the kernel did not ask for one (__fma_rn), which would change the
# rounding of the f64 epilogue.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    return Path(env) if env else CSRC.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (neither on PATH nor under $CUDA_HOME/bin); "
                       "the CUDA kernels of repro_torch are built at first use")


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` lives for the current sources."""
    src = CSRC / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources) -> None:
    """Build each ``csrc/<source>`` whose library is missing, one nvcc each,
    all started together. Raises RuntimeError with nvcc's output if any
    build fails."""
    jobs = []
    for source in dict.fromkeys(sources):
        out = library_path(source)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, proc in jobs:
        log = proc.communicate()[0]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {source}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: str) -> ctypes.CDLL:
    """Build every source whose library is missing (``build_all(SOURCES)``),
    then load ``csrc/<source>``'s. Raises RuntimeError with nvcc's output if
    a build fails."""
    build_all(SOURCES)
    return ctypes.CDLL(str(library_path(source)))
