"""The PyTorch port stands alone: nothing under src/repro_torch (nor
chip_smoke.py, nor the port's example drivers examples/torch_*.py) imports
JAX or the JAX package, and importing repro_torch leaves both out of
sys.modules."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_imports_in_the_port():
    drivers = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(drivers) == 6
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + drivers
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_modules(f) if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.kernels.fused, repro_torch.kernels.build, "
            "repro_torch.kernels.pipeline, "
            "repro_torch.linalg, repro_torch.precision.resolve, repro_torch.obs, "
            "repro_torch.obs.metrics, repro_torch.obs.trace, repro_torch.obs.export, "
            "repro_torch.obs.health, repro_torch.core.ozaki1, repro_torch.core.perf_model, "
            "repro_torch.models, repro_torch.configs, repro_torch.serve, "
            "repro_torch.serve.batching, repro_torch.train, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.runtime, "
            "repro_torch.core.distributed, repro_torch.launch, repro_torch.launch.mesh, "
            "repro_torch.linalg.dist, repro_torch.optim.compress, repro_torch.perf, "
            "repro_torch.perf.sweep, repro_torch.perf.model, repro_torch.perf.trajectory, "
            "repro_torch.perf.rows, repro_torch.perf.fingerprint, repro_torch.testing, "
            "repro_torch.precision.fastest, repro_torch.configs.shapes, "
            "repro_torch.core.collectives, repro_torch.distribution, "
            "repro_torch.distribution.sharding, repro_torch.distribution.spmd, "
            "repro_torch.distribution.pipeline, repro_torch.distribution.op_cost, "
            "repro_torch.launch.dryrun, repro_torch.analysis, repro_torch.analysis.graph_check, "
            "repro_torch.analysis.registry, repro_torch.analysis.cli; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}))")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
