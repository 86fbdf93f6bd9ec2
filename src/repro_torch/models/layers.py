"""Core layers (the torch counterpart of ``repro/models/layers.py``): every
matmul routes through ``core.gemm.backend_matmul``, so the paper's
emulated-GEMM backend is a precision-policy switch. Layers take ``policy=``
(PrecisionPolicy | spec string | None) and ``None`` resolves from the
``repro_torch.precision`` context at call time.

Parameters live in ``nn.Module``s whose leaf names are the reference's
(``w_up``, ``w_down``, ``w_gate``, ...): the contract the serve weight cache
(``MATMUL_WEIGHT_NAMES``) reads. Inits draw from an explicit
``torch.Generator`` on the device it belongs to, so the weights are not the
reference's; ``models.convert.params_from_reference`` loads those.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.gemm import backend_matmul, plan_source
from repro_torch.core.plan import QuantizedMatrix
from repro_torch.precision import resolve_policy

from .tensor_parallel import ModelSplit, split_matmul

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter as ``init`` and the converters make it: frozen, as
    serving reads it; the training state makes it require grad."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------- init utils
class _MetaDraws:
    """The generator of an init on the ``meta`` device, where
    ``torch.Generator`` cannot live: shapes and dtypes, no draws."""

    device = torch.device("meta")


META_DRAWS = _MetaDraws()


def randn(gen, shape) -> torch.Tensor:
    """Standard normal draws from ``gen`` on its device (``META_DRAWS``:
    an empty meta tensor)."""
    if gen is META_DRAWS:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return (randn(gen, (d_in, d_out)) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (randn(gen, (vocab, d)) * 0.02).to(dtype)


def zeros(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=device)


# ---------------------------------------------------------------- primitives
def matmul(x: torch.Tensor, w, policy=None, out_dtype=None) -> torch.Tensor:
    """(..., d_in) @ (d_in, d_out) through the precision backend, on x's
    device.

    ``policy`` resolves per repro_torch.precision (per-call > context >
    native). ``w`` may be a prepared ``QuantizedMatrix`` (the serve
    weight-residue cache): its cached quantization phases are skipped and
    only the activation side is quantized per call. The emulated product
    comes back in f64 and is cast to ``out_dtype`` (default: x's), as in
    the reference. ``w`` may be a leaf split over "model"
    (``tensor_parallel.ModelSplit``): then the product is
    column-parallel (x whole, the ranks' blocks out) or row-parallel (x the
    ranks' blocks, their sum out).
    """
    if isinstance(w, ModelSplit):
        return split_matmul(x, w, policy, out_dtype)
    pol = resolve_policy(policy)
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if pol.is_emulated:
        y = backend_matmul(x2, w, pol, preferred_dtype=out_dtype, device=x2.device)
    else:
        wa = plan_source(w) if isinstance(w, QuantizedMatrix) else w
        # native: accumulate in the layer compute dtype, as the reference does
        y = torch.matmul(x2, wa.to(x2.dtype))  # reprolint: disable=RPL005(native policy: accumulates in x2's compute dtype, as the reference's native matmul)
    return y.reshape(*lead, w.shape[-1]).to(out_dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(dt) * (1.0 + gamma.to(dt))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- MLP (SwiGLU or plain 2-mat)
class MLP(nn.Module):
    """Gated (SwiGLU/GeGLU: ``w_gate``, ``w_up``, ``w_down``) or plain
    two-matrix MLP."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: torch.Tensor | None = None):
        super().__init__()
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        if w_gate is not None:
            self.w_gate = frozen(w_gate)

    def forward(self, x: torch.Tensor, act: str, gemm=None) -> torch.Tensor:
        return mlp_apply(self, x, act, gemm)


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype, gated: bool = True) -> MLP:
    w_gate = dense_init(gen, d, d_ff, dtype) if gated else None
    return MLP(dense_init(gen, d, d_ff, dtype), dense_init(gen, d_ff, d, dtype), w_gate)


def mlp_apply(p: MLP, x: torch.Tensor, act: str, gemm=None) -> torch.Tensor:
    """The MLP; with its matrices split over "model", the up and gate
    projections column-parallel, the activation on each rank's block, the
    down projection row-parallel."""
    u = matmul(x, p.w_up, gemm)
    if hasattr(p, "w_gate"):
        g = matmul(x, p.w_gate, gemm)
        h = blockwise(lambda g, u: activation(g, act) * u, g, u)
    else:
        h = blockwise(lambda u: activation(u, act), u)
    return matmul(h, p.w_down, gemm)


def blockwise(fn, *xs):
    """``fn`` on each rank's blocks of activations split over "model"
    (lists), or on whole tensors."""
    if isinstance(xs[0], list):
        return [fn(*b) for b in zip(*xs)]
    return fn(*xs)
