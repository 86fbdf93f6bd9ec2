"""The port's example drivers (examples/torch_*.py) run to their own OK on
the CPU (``--device cpu``) at small arguments, each with its own
assertions; the quickstart's products equal the reference's ``ozmm`` bit
for bit on the same operands, and its ``resolve_for`` picks the
reference's spec."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ozmm as ref_ozmm
from repro.precision import parse_policy as ref_parse_policy

from _torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]
#: The quickstart's specs held bitwise against the reference.
QUICKSTART_REF_SPECS = ("ozaki2-fp8/fast@12", "ozaki2-int8/fast@14")


def example(name: str):
    """examples/<name>.py as a module (the folder is no package)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    mod = example("torch_quickstart")
    out = mod.main(CPU)
    a, b = (t.numpy() for t in mod.operands("cpu"))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref = {spec: np.asarray(ref_ozmm(ja, jb, spec)) for spec in QUICKSTART_REF_SPECS}
    resolved = ref_parse_policy("ozaki2-fp8/accurate").resolve_for(ja, jb,
                                                                   target_rel_err=2.0 ** -40)
    return out, ref, resolved.spec


@pytest.mark.parametrize("spec", QUICKSTART_REF_SPECS)
def test_quickstart_bitwise_vs_reference(quickstart, spec):
    out, ref, _ = quickstart
    row = next(r for r in out["rows"] if r["spec"] == spec)
    assert row["route"] == "core"  # a bare spec runs core off the card
    assert np.array_equal(row["c"], ref[spec])


def test_quickstart_resolver_and_routes(quickstart):
    out, _, ref_spec = quickstart
    assert out["resolved"]["spec"] == ref_spec
    assert out["resolved"]["err"] <= 2.0 ** -40
    assert all(r["err"] <= 2.0 ** -50 for r in out["rows"])
    assert [r["route"] for r in out["rows"]] == ["core"] * 8
    assert out["pallas_route"] == "K1 plain" and out["pallas_equals_core"] is True


@pytest.mark.parametrize("argv", [["--n", "128", "--block", "64"],
                                  ["--n", "150", "--block", "64", "--grid", "2x2"]],
                         ids=["single", "grid2x2-ragged"])
def test_hpl_lu(argv):
    records = example("torch_hpl_lu").main(argv + CPU)
    assert [r["policy"] for r in records] == ["native", "ozaki2-fp8/accurate",
                                             "ozaki2-int8/accurate"]
    assert all(r["scaled_residual"] <= 16 for r in records)


def test_check_pipeline():
    assert example("torch_check_pipeline").main(CPU) == 0.0  # the schedule is bitwise


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-2.7b"])
def test_serve_demo(arch):
    out = example("torch_serve_demo").main(["--arch", arch, "--batch", "2", "--prompt-len",
                                            "8", "--gen", "3"] + CPU)
    assert out["tokens"].shape == (2, 3)


def test_serve_demo_refuses_side_inputs():
    """As the reference's engine: the vit-stub config's patches are refused."""
    with pytest.raises(ValueError, match="token-only requests"):
        example("torch_serve_demo").main(["--arch", "internvl2-26b", "--batch", "1",
                                          "--prompt-len", "4", "--gen", "1"] + CPU)


@pytest.mark.parametrize("argv", [[], ["--arch", "mamba2-2.7b", "--gemm", "native"]],
                         ids=["qwen2-fp8-fast", "mamba2-native"])
def test_serve_continuous(argv):
    # 4 new tokens: the oversized request (29 prompt tokens) must not fit 32
    out = example("torch_serve_continuous").main(argv + ["--requests", "4", "--gen", "4"] + CPU)
    st = out["stats"]
    assert all(len(out["results"][r].tokens) == 4 for r in out["requests"])
    assert st["decode_tokens"] == 4 * (4 - 1)
    if not argv:  # the relaxed class runs a group of its own, on fewer moduli
        assert list(st["groups"]) == ["ozaki2-fp8/fast", "ozaki2-fp8/fast@6"]
        assert st["weight_cache_nbytes"] > 0


def test_fp64_train(tmp_path):
    """Profile quick, 30 steps (past the 20-step warm-up) of 1 x 64 tokens."""
    out = example("torch_fp64_train").main(["--steps", "30", "--batch", "1", "--seq", "64",
                                            "--ckpt-dir", str(tmp_path)] + CPU)
    assert len(out["losses"]) == 30 and out["losses"][-1] < out["losses"][0]
    assert out["gemms"] == 4 * 7 + 1  # 4 layers of 4 attention and 3 MLP GEMMs, lm_head
    assert out["gemm_of_bound"] <= 1.0 and out["logit_dev"] <= 2.0 ** -23
    assert (tmp_path / "heartbeat.json").exists()


def test_drivers_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        example("torch_check_pipeline").main([])
