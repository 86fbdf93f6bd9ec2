"""Attention (the torch counterpart of ``repro/models/attention.py``): GQA
(RoPE, QKV bias, softcap, sliding-window/global alternation, head padding,
cross-attention over an encoder memory) and MLA (deepseek-v3's latent
attention with a compressed KV cache and weight absorption).

Cache contract (serve substrate):
  GQA cache: {"k": (B, L, KV, hd), "v": (B, L, KV, hd)}  + a shared "pos"
  MLA cache: {"ckv": (B, L, r_kv), "krope": (B, L, rope)}
Prefill writes [0, S); decode reads [0, pos] and writes slot pos.

Continuous-batching extensions (``repro_torch.serve.batching``): ``t.pos``
may be a per-slot vector (B,) instead of a shared scalar, ``t.lengths``
masks ragged right-padded prefill batches, and ``t.block_tables`` switches
the cache tensors from dense per-slot arrays to shared paged pools
(``paged_kv``): GQA {"k"/"v": (P, ps, KV, hd)}, MLA {"ckv": (P, ps, r_kv),
"krope": (P, ps, rope)}. All three are bitwise-neutral:
gathered pools reproduce the dense layout, and padded key positions carry
exactly-zero softmax weight (exp(-1e30) underflows to 0.0).

Caches are written in place (the reference donates them to its jitted
steps) and returned. The attention products (and MLA's absorbed
``w_uk``/``w_uv``) stay plain ``torch.einsum`` calls, as in the reference,
where they are no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from .config import ModelConfig
from . import tensor_parallel as tp
from .layers import apply_rope, dense_init, frozen, matmul, softcap, zeros
from .paged_kv import paged_gather, paged_update


class AttnTemporal(NamedTuple):
    positions: torch.Tensor  # (B, S) query positions
    cache_len: Optional[int]  # cache length if attending over a cache
    pos: Optional[Union[int, torch.Tensor]]  # int or (B,) length for decode masking
    lengths: Optional[torch.Tensor] = None  # (B,) valid prompt lengths (ragged prefill)
    block_tables: Optional[torch.Tensor] = None  # (B, nb) paged-KV page map


# ------------------------------------------------------------------ GQA
def _h_eff(cfg: ModelConfig) -> int:
    """Effective Q-head count: padded to attn_head_pad_to when set (padded
    wq columns / wo rows are zero, so outputs are exact)."""
    return max(cfg.attn_head_pad_to, cfg.num_heads) if cfg.attn_head_pad_to else cfg.num_heads


class GQAAttention(nn.Module):
    """Grouped-query attention: ``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (frozen(w) for w in (wq, wk, wv, wo))
        if bq is not None:
            self.bq, self.bk, self.bv = (frozen(b) for b in (bq, bk, bv))

    def forward(self, x, cfg: ModelConfig, t: AttnTemporal, layer_window,
                cache: Optional[dict], cross_kv: Optional[torch.Tensor] = None):
        return gqa_apply(self, x, cfg, t, layer_window, cache, cross_kv)


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> GQAAttention:
    h, kv, hd, d = _h_eff(cfg), cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    wq = dense_init(gen, d, h * hd, dtype)
    wk = dense_init(gen, d, kv * hd, dtype)
    wv = dense_init(gen, d, kv * hd, dtype)
    wo = dense_init(gen, h * hd, d, dtype)
    if h != cfg.num_heads:
        # GQA q-heads are KV-group-contiguous: pad slots are zeroed PER GROUP
        g_old, g_eff = cfg.num_heads // kv, h // kv
        mask = torch.zeros((h,), dtype=torch.bool, device=wq.device)
        for kvi in range(kv):
            mask[kvi * g_eff: kvi * g_eff + g_old] = True
        col = torch.repeat_interleave(mask, hd)
        wq = torch.where(col[None, :], wq, torch.zeros_like(wq))
        wo = torch.where(col[:, None], wo, torch.zeros_like(wo))
    biases = ()
    if cfg.qkv_bias:
        biases = (zeros(h * hd, dtype, wq.device), zeros(kv * hd, dtype, wq.device),
                  zeros(kv * hd, dtype, wq.device))
    return GQAAttention(wq, wk, wv, wo, *biases)


def _mask(q_pos, k_pos, window, causal: bool):
    """(B, S_q, S_k) bool validity mask."""
    ok = torch.ones(q_pos.shape[:1] + (q_pos.shape[1], k_pos.shape[1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    return ok


def _sdpa(q, k, v, mask, attn_softcap):
    """q (B,S,H,hd), k/v (B,L,KV,hd) grouped attention, f32 softmax."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, s, kvh, g, hd)
    logits = torch.einsum("bskgd,blkd->bkgsl", q, k).to(torch.float32) * (hd ** -0.5)
    logits = softcap(logits, attn_softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v)
    return out.reshape(b, s, h * hd)


def gqa_apply(p: GQAAttention, x: torch.Tensor, cfg: ModelConfig, t: AttnTemporal,
              layer_window, cache: Optional[dict],
              cross_kv: Optional[torch.Tensor] = None):
    """Returns (out, new_cache); ``cache`` is None when not serving. If
    ``cross_kv`` is given, keys/values come from it (encoder memory) and no
    causal mask / rope is applied. With the projections split over "model"
    (``tensor_parallel.ModelSplit``) it runs tensor-parallel
    (``_gqa_split``)."""
    if isinstance(p.wq, tp.ModelSplit):
        return _gqa_split(p, x, cfg, t, layer_window, cache)
    b, s, _ = x.shape
    h, kvh, hd = _h_eff(cfg), cfg.num_kv_heads, cfg.head_dim
    gemm = cfg.gemm

    q = matmul(x, p.wq, gemm)
    src = cross_kv if cross_kv is not None else x
    k = matmul(src, p.wk, gemm)
    v = matmul(src, p.wv, gemm)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, src.shape[1], kvh, hd)
    v = v.reshape(b, src.shape[1], kvh, hd)

    if cross_kv is not None:
        mask = torch.ones((b, s, src.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.attn_softcap)
        return matmul(out, p.wo, gemm), cache
    return matmul(_attend(q, k, v, cfg, t, layer_window, cache), p.wo, gemm), cache


def _attend(q, k, v, cfg: ModelConfig, t: AttnTemporal, layer_window,
            cache: Optional[dict]) -> torch.Tensor:
    """Causal self-attention of q (B, S, H, hd) over k, v (B, S, KV, hd),
    RoPE applied here: over the sequence (training, ``cache`` None), or
    with the keys and values written into ``cache`` in place (serving).
    Returns (B, S, H * hd)."""
    b, s = q.shape[:2]
    dev = q.device
    q = apply_rope(q, t.positions, cfg.rope_theta)
    k = apply_rope(k, t.positions, cfg.rope_theta)

    if cache is None:  # training: self-attention over the sequence
        mask = _mask(t.positions, t.positions, layer_window, causal=True)
        return _sdpa(q, k, v, mask, cfg.attn_softcap)

    # serving: write into the cache (in place), attend over its valid prefix
    paged = t.block_tables is not None
    if s == 1:  # decode
        idx = t.pos
        per_slot = torch.is_tensor(idx) and idx.ndim == 1
        if paged:  # per-slot depths into shared page pools
            idx = idx.to(torch.int32)
            paged_update(cache["k"], k, t.block_tables, idx[:, None])
            paged_update(cache["v"], v, t.block_tables, idx[:, None])
            k_all = paged_gather(cache["k"], t.block_tables)
            v_all = paged_gather(cache["v"], t.block_tables)
        elif per_slot:  # dense slot cache, per-slot depths: row scatter
            rows = torch.arange(b, device=dev)
            idx = idx.long()
            cache["k"][rows, idx] = k[:, 0]
            cache["v"][rows, idx] = v[:, 0]
            k_all, v_all = cache["k"], cache["v"]
        else:  # aligned batch, shared scalar position
            idx = int(idx)
            cache["k"][:, idx:idx + 1] = k
            cache["v"][:, idx:idx + 1] = v
            k_all, v_all = cache["k"], cache["v"]
        L = k_all.shape[1]
        k_pos = torch.arange(L, dtype=torch.int32, device=dev).expand(b, L)
        valid = k_pos <= (idx[:, None] if per_slot or paged else idx)
        mask = _mask(t.positions, k_pos, layer_window, causal=False) & valid[:, None, :]
        return _sdpa(q, k_all, v_all, mask, cfg.attn_softcap)
    # prefill
    if paged:  # ragged right-padded bucket: rows own disjoint pages
        paged_update(cache["k"], k, t.block_tables, t.positions)
        paged_update(cache["v"], v, t.block_tables, t.positions)
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    mask = _mask(t.positions, t.positions, layer_window, causal=True)
    if t.lengths is not None:  # mask keys past each row's prompt
        key_ok = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
                  < t.lengths[:, None])
        mask &= key_ok[:, None, :]
    return _sdpa(q, k, v, mask, cfg.attn_softcap)


def head_local(cfg: ModelConfig, model: int) -> bool:
    """Whether attention runs head-local on ``model`` ranks: both head
    counts divide it. ``_sdpa`` orders the query heads kv-major, so rank j's
    q columns are then exactly the query heads of its kv heads."""
    return _h_eff(cfg) % model == 0 and cfg.num_kv_heads % model == 0


def _on(t: AttnTemporal, dev: torch.device) -> AttnTemporal:
    """``t``'s tensors on ``dev`` (a model rank's device)."""
    return AttnTemporal(*(x.to(dev) if torch.is_tensor(x) else x for x in t))


def _gqa_split(p: GQAAttention, x: torch.Tensor, cfg: ModelConfig, t: AttnTemporal,
               layer_window, cache: Optional[dict]):
    """GQA with its projections split over "model" (tensor-parallel): q, k
    and v column-parallel, ``wo`` row-parallel. Where ``head_local`` holds,
    each rank attends with its own heads over its own cache block.
    Otherwise q, k and v are all-gathered over "model", attention runs
    whole (so does the cache: its blocks gathered, written, and each rank's
    block written back), and each rank takes its columns of the output for
    its row block of ``wo``. A cache is the ranks' kv-head blocks
    (``tensor_parallel.split_cache``)."""
    axis = p.wq.axis
    b, s, _ = x.shape
    hd, gemm = cfg.head_dim, cfg.gemm
    q, k, v = (matmul(x, w, gemm) for w in (p.wq, p.wk, p.wv))
    if cfg.qkv_bias:
        q, k, v = ([y + bias.to(y.dtype) for y, bias in zip(ys, bb.blocks)]
                   for ys, bb in ((q, p.bq), (k, p.bk), (v, p.bv)))
    if head_local(cfg, axis.size):
        if cfg.num_kv_heads == axis.size > 1 and b > 1:
            k = [tp.keys_cotangent_as_whole(kj) for kj in k]
        out = []
        for j, (qj, kj, vj) in enumerate(zip(q, k, v)):
            cj = None if cache is None else {n: cache[n][j] for n in ("k", "v")}
            out.append(_attend(qj.reshape(b, s, -1, hd), kj.reshape(b, s, -1, hd),
                               vj.reshape(b, s, -1, hd), cfg, _on(t, qj.device),
                               layer_window, cj))
        return matmul(out, p.wo, gemm), cache
    q, k, v = (tp.gather(y, axis, w.sizes).reshape(b, s, -1, hd)
               for y, w in ((q, p.wq), (k, p.wk), (v, p.wv)))
    whole = None
    if cache is not None:
        kv_sizes = tp.block_sizes(cfg.num_kv_heads, axis.size)
        whole = {n: tp.gather(cache[n], axis, kv_sizes, -2) for n in ("k", "v")}
    out = _attend(q, k, v, cfg, t, layer_window, whole)
    if cache is not None:
        for n in ("k", "v"):
            for blk, mine in zip(cache[n], tp.scatter(whole[n], axis, kv_sizes, -2)):
                blk.copy_(mine)
    return matmul(tp.scatter(out, axis, p.wo.sizes), p.wo, gemm), cache


# ------------------------------------------------------------------ MLA
class MLAAttention(nn.Module):
    """Latent attention: ``w_dkv`` (down-projection + shared k_rope),
    ``w_uk``/``w_uv`` (absorbed into the scores and the output, never
    ``layers.matmul`` operands), ``wo``, and either ``w_dq``/``w_uq`` (with a
    q LoRA rank) or ``w_q``."""

    def __init__(self, w_dkv, w_uk, w_uv, wo, w_dq=None, w_uq=None, w_q=None):
        super().__init__()
        self.w_dkv, self.w_uk, self.w_uv, self.wo = (frozen(w) for w in (w_dkv, w_uk, w_uv, wo))
        if w_dq is not None:
            self.w_dq, self.w_uq = frozen(w_dq), frozen(w_uq)
        else:
            self.w_q = frozen(w_q)

    def forward(self, x, cfg: ModelConfig, t: AttnTemporal, cache: Optional[dict]):
        return mla_apply(self, x, cfg, t, cache)


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> MLAAttention:
    d, h = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    rope, nope, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    w = [dense_init(gen, d, r_kv + rope, dtype), dense_init(gen, r_kv, h * nope, dtype),
         dense_init(gen, r_kv, h * vd, dtype), dense_init(gen, h * vd, d, dtype)]
    if r_q:
        return MLAAttention(*w, w_dq=dense_init(gen, d, r_q, dtype),
                            w_uq=dense_init(gen, r_q, h * (nope + rope), dtype))
    return MLAAttention(*w, w_q=dense_init(gen, d, h * (nope + rope), dtype))


def mla_apply(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig, t: AttnTemporal,
              cache: Optional[dict]):
    """Returns (out, new_cache); the cache is written in place."""
    b, s, _ = x.shape
    h = cfg.num_heads
    rope, nope, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    gemm = cfg.gemm

    if cfg.q_lora_rank:
        q = matmul(matmul(x, p.w_dq, gemm), p.w_uq, gemm)
    else:
        q = matmul(x, p.w_q, gemm)
    q = q.reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, t.positions, cfg.rope_theta)

    dkv = matmul(x, p.w_dkv, gemm)
    ckv, krope = dkv[..., :r_kv], dkv[..., r_kv:]
    krope = apply_rope(krope[:, :, None, :], t.positions, cfg.rope_theta)[:, :, 0, :]

    if cache is not None:
        paged = t.block_tables is not None
        if s == 1:  # decode
            idx = t.pos
            per_slot = torch.is_tensor(idx) and idx.ndim == 1
            if paged:
                idx = idx.to(torch.int32)
                paged_update(cache["ckv"], ckv, t.block_tables, idx[:, None])
                paged_update(cache["krope"], krope, t.block_tables, idx[:, None])
                ckv_all = paged_gather(cache["ckv"], t.block_tables)
                krope_all = paged_gather(cache["krope"], t.block_tables)
            elif per_slot:  # dense slot cache, per-slot depths
                rows = torch.arange(b, device=x.device)
                idx = idx.long()
                cache["ckv"][rows, idx] = ckv[:, 0]
                cache["krope"][rows, idx] = krope[:, 0]
                ckv_all, krope_all = cache["ckv"], cache["krope"]
            else:  # aligned batch, shared scalar position
                idx = int(idx)
                cache["ckv"][:, idx:idx + 1] = ckv
                cache["krope"][:, idx:idx + 1] = krope
                ckv_all, krope_all = cache["ckv"], cache["krope"]
            L = ckv_all.shape[1]
            k_pos = torch.arange(L, dtype=torch.int32, device=x.device).expand(b, L)
            mask = k_pos[:, None, :] <= (idx[:, None, None] if per_slot or paged else idx)
            ckv_src, krope_src = ckv_all, krope_all
        else:  # prefill
            if paged:
                paged_update(cache["ckv"], ckv, t.block_tables, t.positions)
                paged_update(cache["krope"], krope, t.block_tables, t.positions)
            else:
                cache["ckv"][:, :s] = ckv
                cache["krope"][:, :s] = krope
            mask = t.positions[:, :, None] >= t.positions[:, None, :]
            if t.lengths is not None:  # mask keys past each row's prompt
                key_ok = (torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
                          < t.lengths[:, None])
                mask = mask & key_ok[:, None, :]
            ckv_src, krope_src = ckv, krope
    else:
        mask = t.positions[:, :, None] >= t.positions[:, None, :]
        ckv_src, krope_src = ckv, krope

    # weight absorption: score = q_nope^T W_uk ckv + q_rope^T k_rope
    w_uk = p.w_uk.reshape(r_kv, h, nope)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk.to(q_nope.dtype))
    scale = (nope + rope) ** -0.5
    logits = (torch.einsum("bshr,blr->bhsl", q_abs, ckv_src)
              + torch.einsum("bshd,bld->bhsl", q_rope, krope_src)).to(torch.float32) * scale
    logits = torch.where(mask[:, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhsl,blr->bshr", w, ckv_src)  # attention in latent space
    w_uv = p.w_uv.reshape(r_kv, h, vd)
    out = torch.einsum("bshr,rhv->bshv", ctx, w_uv.to(ctx.dtype)).reshape(b, s, h * vd)
    return matmul(out, p.wo, gemm), cache


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.Module:
    return mla_init(gen, cfg, dtype) if cfg.use_mla else gqa_init(gen, cfg, dtype)


def apply_attention(p, x, cfg: ModelConfig, t: AttnTemporal, layer_window, cache,
                    cross_kv=None):
    if cfg.use_mla:
        assert cross_kv is None
        return mla_apply(p, x, cfg, t, cache)
    return gqa_apply(p, x, cfg, t, layer_window, cache, cross_kv)
