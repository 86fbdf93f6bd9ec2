"""repro_torch's training forward and gradients against the JAX reference
on the CPU, on the same numpy weights (``_torch_families_parity``):
``Model.forward_train``'s logits, aux loss and MTP logits for the smoke
config of every family (dense, among them starcoder2's plain GELU MLP and
QKV bias and gemma2's softcaps and post-norms; MoE, MLA + MoE + MTP, SSM,
hybrid, encdec, vlm) to LOGIT_RTOL of max|logit|; ``loss_fn``'s gradient
against ``jax.value_and_grad`` per leaf, normwise, under native f32 (dense and
deepseek); and in an f64 dense model the gradient with every GEMM and both
cotangent GEMMs emulated (ozaki2-fp8/fast, core route) against the port's
native f64 gradient (FP64 grade), which is held against the reference's.

Tolerances: the models keep f32 islands in every dtype (rmsnorm, rope and
attention's logits and softmax cast to f32, in both packages), and XLA's
f32 reductions and transcendentals differ from torch's by ulps (the
reference's own jit and eager runs differ by ulps too), so logits are
held to LOGIT_RTOL of max|logit| and gradients to 1e-5 normwise; zamba2's
SSD raises the exponential of order-dependent segment sums through five
SSM layers to ~1.3e-5 of max|logit| here, and its serving prefill, whose
bits its ``forward_train``'s last position shares, deviates as far.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import DataConfig
from repro.models import Model as RefModel
from repro.data import synth_batch as ref_synth_batch
from repro.train import loss_fn as ref_loss_fn
from repro_torch.models import Model
from repro_torch.models.convert import reference_path, reference_leaves
from repro_torch.train import loss_fn

from _torch_families_parity import family_pair
from _torch_models_parity import LOGIT_RTOL, one_torch_thread  # noqa: F401

FAMILIES = ("qwen2-7b", "starcoder2-15b", "gemma2-27b", "moonshot-v1-16b-a3b",
            "deepseek-v3-671b", "mamba2-2.7b", "zamba2-1.2b", "seamless-m4t-medium",
            "internvl2-26b")
DATA = DataConfig(seed=5, batch=2, seq_len=8, vocab_size=512, mean_doc_len=5)
#: Logits to LOGIT_RTOL of max|logit|, but zamba2's (module docstring).
LOGIT_TOL = {"zamba2-1.2b": 3 * LOGIT_RTOL}


def _batch(ref_model) -> dict:
    return ref_synth_batch(DATA, ref_model.cfg, 1)


def _close(port: torch.Tensor, ref, what: str, rtol: float = LOGIT_RTOL) -> None:
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: max |port - ref| {err}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_as_reference(arch):
    ref_model, ref_params, model, params = family_pair(arch)
    batch = _batch(ref_model)
    want = jax.jit(ref_model.forward_train)(ref_params, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    with torch.no_grad():
        got = model.forward_train(params, batch)
    tol = LOGIT_TOL.get(arch, LOGIT_RTOL)
    _close(got.logits, want.logits, f"{arch} logits", tol)
    assert got.aux_loss.dtype == torch.float32
    _close(got.aux_loss, want.aux_loss, f"{arch} aux", tol)
    assert (got.mtp_logits is None) == (want.mtp_logits is None)
    if want.mtp_logits is not None:
        _close(got.mtp_logits, want.mtp_logits, f"{arch} mtp logits", tol)


def _port_grads(model, params, batch) -> tuple[torch.Tensor, dict]:
    leaves = reference_leaves(params.requires_grad_(True))
    loss, _ = loss_fn(model, params, batch)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _by_port_name(tree, names) -> dict:
    """The reference's gradient tree as numpy arrays under the port's leaf
    names (layer i of a stacked stage leaf: its slice i)."""
    out = {}
    for name in names:
        path, layer = reference_path(name)
        w = tree
        for k in path:
            w = w[k]
        out[name] = np.asarray(w if layer is None else w[layer])
    return out


def _worst(got: dict, want: dict) -> tuple[str, float]:
    """The leaf of the largest ||got - want|| / ||want|| and that error."""
    errs = {}
    for name, g in got.items():
        w = np.asarray(want[name])
        assert g.shape == w.shape, name
        errs[name] = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _reference_grads(ref_model, ref_params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(ref_model, p, b), has_aux=True))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v3-671b"])
def test_loss_gradient_native_f32_as_reference(arch):
    ref_model, ref_params, model, params = family_pair(arch)
    batch = _batch(ref_model)
    ref_loss, ref_grads = _reference_grads(ref_model, ref_params, batch)
    loss, grads = _port_grads(model, params, batch)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    assert all(g.dtype == torch.float32 for g in grads.values())
    worst, err = _worst(grads, _by_port_name(ref_grads, grads))
    assert err <= 1e-5, (worst, err)


def test_loss_gradient_emulated_f64():
    """An f64 dense model: the gradient with every GEMM and both cotangent
    GEMMs emulated (ozaki2-fp8/fast, core route) within 1e-12 of the
    port's native f64 gradient per leaf (FP64 grade), and that within 1e-5
    of the reference's native f64 gradient (the f32 islands)."""
    f64 = dict(dtype="float64", param_dtype="float64")
    ref_model, ref_params, model, params = family_pair("qwen2-7b", gemm="ozaki2-fp8/fast", **f64)
    native = Model(dataclasses.replace(model.cfg, gemm=None), device="cpu")
    params = params.double()
    batch = _batch(ref_model)
    loss, grads = _port_grads(model, params, batch)
    loss_n, grads_n = _port_grads(native, params, batch)
    assert all(g.dtype == torch.float64 for g in grads.values())
    worst, err = _worst(grads, grads_n)
    assert err <= 1e-12, (worst, err)
    assert float(loss) == pytest.approx(float(loss_n), rel=1e-14)
    ref_model = RefModel(dataclasses.replace(ref_model.cfg, gemm=None))
    ref_loss, ref_grads = _reference_grads(
        ref_model, jax.tree.map(lambda a: a.astype(jnp.float64), ref_params), batch)
    assert float(loss_n) == pytest.approx(ref_loss, rel=1e-6)
    worst, err = _worst(grads_n, _by_port_name(ref_grads, grads_n))
    assert err <= 1e-5, (worst, err)
