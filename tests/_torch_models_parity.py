"""Shared by tests/test_torch_models*.py and tests/test_torch_serve.py: the
qwen2-7b smoke config in the JAX reference and in the PyTorch port, with
the same weights (the reference's ``Model.init``, loaded into the port by
``params_from_reference``), and the comparisons the tests hold them to.

Tolerance of the model paths: the port's elementwise f32 passes (rsqrt,
exp, tanh, rope's sin/cos) and attention's einsum sums may differ from
XLA's by an ulp, and the layers propagate it, so logits are held to
``LOGIT_RTOL`` of max|logit| with equal greedy tokens. Everything whose
inputs are equal (prepared matmuls, paged KV, plans) is held bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.core.plan import OperandStats as RefOperandStats
from repro.core.plan import QuantizedMatrix as RefQuantizedMatrix
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.models import Model, params_from_reference

from _torch_threads import one_torch_thread  # noqa: F401 (re-exported)

ARCH = "qwen2-7b"
#: Logits of the model paths: |port - reference| <= LOGIT_RTOL * max|reference|.
LOGIT_RTOL = 1e-5


def smoke_pair(gemm=None):
    """(reference model, its params, port model, the same params) on the
    smoke config, the port on the CPU."""
    ref_cfg = ref_get_config(ARCH, "smoke")
    cfg = get_config(ARCH, "smoke")
    if gemm is not None:
        ref_cfg = dataclasses.replace(ref_cfg, gemm=gemm)
        cfg = dataclasses.replace(cfg, gemm=gemm)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_reference(model, jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def assert_logits_close(port, ref, what: str) -> np.ndarray:
    """Logits within LOGIT_RTOL of max|ref| and the same greedy tokens;
    returns the tokens."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= LOGIT_RTOL * np.abs(ref).max(), f"{what}: max |port - ref| {err}"
    np.testing.assert_array_equal(port.argmax(-1), ref.argmax(-1), err_msg=what)
    return ref.argmax(-1)


def e4m3_or_array(t: torch.Tensor) -> jnp.ndarray:
    """A port plan tensor as a JAX array (e4m3 through its bytes)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def ref_plan(plans: list):
    """The reference's stacked (L, ...) plan of one stage leaf from the
    port's per-layer plans (slice i = layer i), for the reference model's
    scan over the layer axis."""
    q = plans[0]

    def stack(ts):
        return None if ts[0] is None else jnp.stack([e4m3_or_array(t) for t in ts])

    stats = RefOperandStats(*(stack([getattr(p.stats, f) for p in plans])
                              for f in ("row_sq", "row_max", "col_sq", "col_max")))
    parts = tuple(tuple(stack([p.parts[l][i] for p in plans]) for i in range(len(q.parts[l])))
                  for l in range(len(q.parts)))
    return RefQuantizedMatrix(q.role, q.family, q.num_moduli, q.mode, None, stats,
                              stack([p.lscale for p in plans]), parts, None, None)


def ref_params_with_plans(ref_params: dict, serve_params) -> dict:
    """The reference params with each matmul weight replaced by the port's
    fast-mode plans of that weight (stacked over the stage's layers)."""
    out = dict(ref_params)
    stages = []
    for s, sp in enumerate(ref_params["stages"]):
        blocks = serve_params.stages[s]
        stage = dict(sp)
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_gate", "w_up", "w_down"))):
            stage[sub] = dict(sp[sub])
            for name in names:
                if name in sp[sub]:
                    stage[sub][name] = ref_plan([getattr(getattr(b, sub), name) for b in blocks])
        stages.append(stage)
    out["stages"] = tuple(stages)
    q = serve_params.lm_head
    out["lm_head"] = jax.tree.map(lambda x: x[0], ref_plan([q]))
    return out
