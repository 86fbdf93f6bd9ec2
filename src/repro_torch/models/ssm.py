"""Mamba2 (SSD — state-space duality) block (the torch counterpart of
``repro/models/ssm.py``): chunked scan for prefill and O(1) stateful decode.
Intra-chunk attention-like term + inter-chunk state recurrence, a Python
loop over the chunks where the reference runs ``lax.scan``. Single B/C
group (ngroups=1), scalar-per-head A. The state stays f32 and the products
are plain ``torch.einsum`` calls, as in the reference; only ``in_proj`` and
``out_proj`` go through ``layers.matmul``.

Decode state: {"conv": (B, W-1, dconv), "ssd": (B, H, P, N)}.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense_init, frozen, matmul, randn, rmsnorm


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, W-1, d_conv_channels)
    ssd: torch.Tensor  # (B, H, P, N)


class Mamba2(nn.Module):
    """The mixer: fused ``in_proj`` [z, xBC, dt], depthwise ``conv_w``/
    ``conv_b``, ``A_log``, ``D``, ``dt_bias`` (f32), the gated-norm ``norm``
    and ``out_proj``."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm, out_proj):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = frozen(in_proj), frozen(conv_w), frozen(conv_b)
        self.A_log, self.D, self.dt_bias = frozen(A_log), frozen(D), frozen(dt_bias)
        self.norm, self.out_proj = frozen(norm), frozen(out_proj)


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Mamba2:
    d, dil, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, dev = cfg.ssm_heads, gen.device
    conv_ch = dil + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    return Mamba2(
        dense_init(gen, d, 2 * dil + 2 * n + h, dtype),  # [z (dil), xBC (dil + 2n), dt (h)]
        (randn(gen, (cfg.conv_width, conv_ch)) * 0.1).to(dtype),
        torch.zeros((conv_ch,), dtype=dtype, device=dev),
        torch.zeros((h,), **f32),  # A = -exp(A_log) = -1 init
        torch.ones((h,), **f32),
        torch.full((h,), -2.0, **f32),  # softplus(-2) ~ 0.12
        torch.zeros((dil,), dtype=dtype, device=dev),
        dense_init(gen, dil, d, dtype))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv along seq. xbc (B,S,C); w (W,C). Returns
    (out (B,S,C), new_state (B,W-1,C))."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # (B, S+W-1, C)
    wd = w.to(xbc.dtype)
    out = sum(full[:, i:i + xbc.shape[1], :] * wd[i][None, None, :] for i in range(width))
    new_state = full[:, full.shape[1] - (width - 1):, :]
    return F.silu(out + b.to(out.dtype)[None, None, :]), new_state


def ssd_chunked(x, dt, a_head, bmat, cmat, chunk: int):
    """SSD scan. x (B,S,H,P), dt (B,S,H) [post-softplus], a_head (H,) [<0],
    B/C (B,S,N). Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    bc = bmat.reshape(b, nc, chunk, n).to(f32)
    cc = cmat.reshape(b, nc, chunk, n).to(f32)

    da = dtc * a_head[None, None, None, :]  # (b,nc,q,h), negative
    da_cum = torch.cumsum(da, dim=2)

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
    diff = da_cum[:, :, :, None, :] - da_cum[:, :, None, :, :]  # (b,nc,q,q,h)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.where(tril[None, None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", scores, decay, dtc, xc)

    # chunk-final states and the inter-chunk recurrence
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)  # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqh,bcqh,bcqhp->bchpn", bc, decay_to_end, dtc, xc)
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (b,nc,h)

    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []  # the state BEFORE each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (b,nc,h,p,n)

    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, prev, torch.exp(da_cum))
    return y.reshape(b, s, h, p).to(x.dtype), carry


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, state: Optional[SSMState]):
    """x (B,S,D) -> (y (B,S,D), new_state). state=None => no carry in, the
    final state discarded."""
    b, s, d = x.shape
    dil, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim

    zxbcdt = matmul(x, p.in_proj, cfg.gemm)
    z = zxbcdt[..., :dil]
    xbc = zxbcdt[..., dil:2 * dil + 2 * n]
    dt_raw = zxbcdt[..., 2 * dil + 2 * n:]

    conv_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xs = xbc[..., :dil].reshape(b, s, h, hp)
    bmat = xbc[..., dil:dil + n]
    cmat = xbc[..., dil + n:]

    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)  # (b,s,h)
    a_head = -torch.exp(p.A_log)  # (h,)

    if state is None or s > 1:
        # no state or prefill (fresh state); dt is padded AFTER softplus so
        # padded steps have decay=1, update=0 (state-exact).
        chunk = min(cfg.ssm_chunk, s)
        if s % chunk:  # pad the sequence to a chunk multiple
            pad = chunk - s % chunk
            y, final = ssd_chunked(F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                                   a_head, F.pad(bmat, (0, 0, 0, pad)),
                                   F.pad(cmat, (0, 0, 0, pad)), chunk)
            y = y[:, :s]
        else:
            y, final = ssd_chunked(xs, dt, a_head, bmat, cmat, chunk)
    else:  # decode: one recurrence step
        dt1 = dt[:, 0]  # (b,h)
        xs1 = xs[:, 0].to(torch.float32)  # (b,h,p)
        b1 = bmat[:, 0].to(torch.float32)  # (b,n)
        c1 = cmat[:, 0].to(torch.float32)
        dec = torch.exp(dt1 * a_head[None, :])  # (b,h)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xs1, b1)
        final = state.ssd * dec[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", final, c1)[:, None].to(x.dtype)

    y = y + p.D[None, None, :, None].to(y.dtype) * xs
    y = y.reshape(b, s, dil)
    y = rmsnorm(y * F.silu(z), p.norm, cfg.norm_eps)  # gated norm
    out = matmul(y, p.out_proj, cfg.gemm)
    new_state = SSMState(conv=new_conv, ssd=final) if state is not None else None
    return out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return SSMState(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        ssd=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=device))
