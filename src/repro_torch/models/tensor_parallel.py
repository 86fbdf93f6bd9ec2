"""Tensor parallelism over "model" for the dense family: the port's
counterpart of GSPMD's split of each GEMM when the reference jits its
train step, prefill and decode with ``distribution.sharding``'s rules
(Megatron-style column- and row-parallel products, the vocab-parallel
embedding, the gathered logits).

One data rank's program drives its model ranks together (a single
controller): a leaf the rules split over "model" is a ``ModelSplit``, the
model ranks' blocks of it (each gathered over the data axes alone by
``spmd.sharded_programs``), and an activation split over "model" is a list
of the ranks' blocks. ``ModelAxis`` says which model ranks a call runs:
all of them, or some (the dry run runs rank 0's program); the collectives
then see only those ranks' parts, so such a call is for counting, not for
its values.

* Column-parallel (``attn/wq|wk|wv`` and their biases, ``mlp/w_gate|w_up``,
  ``lm_head``): rank j computes ``x @ W[:, j]``; the result stays split.
* Row-parallel (``attn/wo``, ``mlp/w_down``): rank j computes
  ``x_j @ W[j, :]`` and the partial products are summed over "model" in
  ascending rank order (an all-reduce).
* Embedding (vocab rows over "model"): each rank looks up its rows and
  writes zeros for the others; the ranks psum (exact: one term is nonzero).
* Logits: column-parallel, then all-gathered over "model" (an exact
  concatenation) before the softcap, the pad mask and the loss.

Products: under a native policy each block's product runs in the compute
dtype (``core.gemm.backend_matmul``) and a row-parallel sum is a psum in
that dtype, as GSPMD's all-reduce of the dot output is. Under an Ozaki-II
policy every product is exact:

* an mn block (the whole contraction) is ``core.distributed.mn_shard`` on
  the route the policy resolves to on the block's device (on an H100 K2 in
  fast mode, ``pair_exponents`` + K1 in accurate mode; the core's plans on
  the CPU);
* a contraction split over "model" is ``core.distributed.
  k_sharded_product``: the global exponents, each rank's int32 residue
  partials (K6 + 3N K3, or N K4 for int8, on an H100), one psum of those
  planes, then the centring, Garner and the reconstruction once.

Ozaki-II scales per row of A and per column of B, so an mn block is the
matching block of the single-device product, bit for bit. A k split is the
single-device product wherever its global fast-mode exponents agree (the
squared norms are summed over the ranks in f64: an exponent can flip at a
power of two); in accurate mode it is held to DGEMM's componentwise bound
(the f32 bound partials are summed in rank order). Other emulated schemes
(Ozaki-I) have no exact k split and are refused.

Backward: each product is a ``torch.autograd.Function`` with
``core.gemm._UnpreparedVJP``'s orientation (dA = dC @ B^T, dB = A^T @ dC):
column-parallel's dX is a contraction split over "model" (the same exact
route) and dW_j = X^T dY_j a column block; row-parallel's dX_j = dY W_j^T
is a column block and dW_j = X_j^T dY a row block. A row-parallel product
packs its operands before it runs (``_RowOperands``), so a remat "full"
recompute stops before it, as before a native GEMM. An explicit ``+pallas``
policy is forward-only, as for ``ozmm``.

Layout: two places keep a split program's sums in the single device's
order, since a torch sum adds in memory order: ``keys_cotangent_as_whole``
(the keys' cotangent of a rank with one kv head) and
``optim.adamw.global_norm`` (each leaf summed row-major, so a gradient
gathered from blocks adds as the whole leaf autograd made, as a tied
embedding's transposed gradient is). Each is pinned by a bitwise step that
fails without it: tests/test_torch_distribution_spmd.py's (1, 4) fast step
(4 kv heads on 4 ranks) and tests/test_torch_distribution_tp.py's gemma2-27b
fast step (tied embeddings).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collectives, gemm
from repro_torch.core.distributed import k_sharded_product, mn_shard
from repro_torch.precision import resolve_policy
from repro_torch.precision.policy import PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis as one data rank's program runs it: ``size`` ranks,
    of which the call runs ``ranks`` (ascending), rank ``ranks[i]`` on
    ``devices[i]``. What the model ranks replicate lives on the first's
    device (``device``)."""
    size: int
    ranks: tuple
    devices: tuple

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def block_sizes(n: int, parts: int) -> list[int]:
    """``n`` cut into ``parts`` blocks as ``NamedSharding`` cuts it:
    ceil(n / parts) long, the last ones shorter or empty."""
    size = -(-n // parts)
    return [min((i + 1) * size, n) - min(i * size, n) for i in range(parts)]


def _starts(sizes: list[int]) -> list[int]:
    out, at = [], 0
    for n in sizes:
        out.append(at)
        at += n
    return out


class ModelSplit:
    """A leaf split over "model" as one data rank's program holds it: the
    blocks of the model ranks ``axis`` runs (each a tensor of its own, which
    autograd gives a gradient), cut along ``dim`` of a tensor of ``shape``."""

    def __init__(self, blocks, dim: int, shape, axis: ModelAxis):
        self.blocks = list(blocks)
        self.dim = dim
        self.shape = torch.Size(shape)
        self.axis = axis

    @property
    def sizes(self) -> list[int]:
        """Every model rank's block length along ``dim``."""
        return block_sizes(self.shape[self.dim], self.axis.size)

    @property
    def T(self) -> "ModelSplit":
        """The transpose of a 2-D leaf (a tied embedding as the lm_head)."""
        return ModelSplit([b.T for b in self.blocks], 1 - self.dim, self.shape[::-1], self.axis)


# ------------------------------------------------------------------ products
class _Products:
    """The two products of a policy: an mn block and a contraction split
    over "model" (module docstring)."""

    def __init__(self, pol: PrecisionPolicy):
        if pol.is_emulated and not pol.supports_plans:
            raise ValueError(f"policy {pol.spec!r}: tensor-parallel products run native or "
                             "Ozaki-II policies (a contraction split over 'model' needs the "
                             "exact residue psum)")
        self.pol = pol
        self.dtype = torch.float64 if pol.is_emulated else None
        self.ms = pol.moduli_set() if pol.is_emulated else None

    def _route(self, dev: torch.device) -> str:
        route = gemm._resolve_backend(self.pol, dev)
        if route == "pallas":
            gemm._check_kernel_route(self.pol, dev)
        return route

    def mn(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.ms is None:
            return gemm.backend_matmul(a, b, self.pol, device=a.device)
        return mn_shard(a, b, self.ms, self.pol.mode, self._route(a.device))

    def k(self, a_sh: list, b_sh: list, axis: ModelAxis, k: int) -> torch.Tensor:
        if self.ms is None:
            return collectives.psum([gemm.backend_matmul(a, b, self.pol, device=a.device)
                                     for a, b in zip(a_sh, b_sh)], axis.device, axis.size)
        return k_sharded_product(a_sh, b_sh, self.ms, self.pol.mode,
                                 [self._route(a.device) for a in a_sh], axis.device,
                                 axis.size, k)


class _ColumnParallel(torch.autograd.Function):
    """(x, W_j for the ranks run) -> the blocks x @ W_j."""

    @staticmethod
    def forward(ctx, prod: _Products, axis: ModelAxis, k: int, x, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.prod, ctx.axis, ctx.k = prod, axis, k
        return tuple(gemm._product(prod.mn, x.to(w.device), w) for w in ws)

    @staticmethod
    def backward(ctx, *gys):
        prod, need = ctx.prod, ctx.needs_input_grad
        gemm.refuse_explicit_pallas_vjp(prod.pol)
        x, *ws = ctx.saved_tensors
        # dX = sum_j dY_j W_j^T: the contraction over the out features,
        # split over "model"; dW_j = X^T dY_j: a column block
        gx = prod.k(list(gys), [w.T for w in ws], ctx.axis, ctx.k) if need[3] else None
        gws = [prod.mn(x.T.to(g.device), g) if need[4 + i] else None
               for i, g in enumerate(gys)]
        return (None, None, None, gx, *gws)


class _RowOperands(torch.autograd.Function):
    """Holds a row-parallel product's operands for its backward (x_j for the
    ranks run, then W_j) and returns a stand-in of the product's shape (one
    element, expanded), which ``_Tie`` gives the product's value. The
    operands are packed when this returns, before the product runs, so
    under remat "full" a checkpoint's recompute stops here, once every saved
    tensor is back: the layer's last product is not run again, as a native
    GEMM's is not (torch packs a native op's inputs before its kernel)."""

    @staticmethod
    def forward(ctx, prod: _Products, shape, *xw):
        ctx.save_for_backward(*xw)
        ctx.prod = prod
        return xw[0].new_empty(()).expand(shape)

    @staticmethod
    def backward(ctx, gy):
        prod, need = ctx.prod, ctx.needs_input_grad
        gemm.refuse_explicit_pallas_vjp(prod.pol)
        saved = ctx.saved_tensors
        n = len(saved) // 2
        # dX_j = dY W_j^T: a column block; dW_j = X_j^T dY: a row block
        gxs = [prod.mn(gy.to(w.device), w.T) if need[2 + i] else None
               for i, w in enumerate(saved[n:])]
        gws = [prod.mn(x.T, gy.to(x.device)) if need[2 + n + i] else None
               for i, x in enumerate(saved[:n])]
        return (None, None, *gxs, *gws)


class _Tie(torch.autograd.Function):
    """(``_RowOperands``' stand-in, the product run outside autograd) -> the
    product; its cotangent goes to the stand-in's node."""

    @staticmethod
    def forward(ctx, stand_in, y):
        return y

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def column_parallel(x: torch.Tensor, w: ModelSplit, policy=None,
                    out_dtype=None) -> list[torch.Tensor]:
    """(..., d_in) @ a column-split (d_in, d_out) leaf: the ranks' blocks
    (..., d_out_j), each cast to ``out_dtype`` (default: x's), as
    ``models.layers.matmul`` casts its product."""
    prod = _Products(resolve_policy(policy))
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    dt = prod.dtype or x.dtype
    ys = _ColumnParallel.apply(prod, w.axis, w.shape[1], x.reshape(-1, x.shape[-1]).to(dt),
                               *(b.to(dt) for b in w.blocks))
    return [y.reshape(*lead, y.shape[-1]).to(out_dtype) for y in ys]


def row_parallel(xs: list[torch.Tensor], w: ModelSplit, policy=None,
                 out_dtype=None) -> torch.Tensor:
    """The blocks (..., d_in_j) of an activation split over "model" @ a
    row-split (d_in, d_out) leaf: the sum over the ranks, on the axis'
    device, cast to ``out_dtype`` (default: the blocks' dtype)."""
    prod = _Products(resolve_policy(policy))
    out_dtype = out_dtype or xs[0].dtype
    lead = xs[0].shape[:-1]
    dt = prod.dtype or xs[0].dtype
    xs = [x.reshape(-1, x.shape[-1]).to(dt) for x in xs]
    ws = [b.to(dt) for b in w.blocks]
    stand_in = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*xs, *ws)):
        stand_in = _RowOperands.apply(prod, (xs[0].shape[0], w.shape[1]), *xs, *ws)
    with torch.no_grad():
        y = gemm._product(lambda *_: prod.k(xs, ws, w.axis, w.shape[0]), None, None)
    if stand_in is not None:
        y = _Tie.apply(stand_in, y)
    return y.reshape(*lead, w.shape[1]).to(out_dtype)


def split_matmul(x, w: ModelSplit, policy=None, out_dtype=None):
    """``models.layers.matmul`` on a leaf split over "model": column- or
    row-parallel by the split's dimension."""
    if w.dim == 1:
        return column_parallel(x, w, policy, out_dtype)
    return row_parallel(x, w, policy, out_dtype)


# ------------------------------------------------------------- the model's ends
def gather(blocks: list, axis: ModelAxis, sizes: list[int], dim: int = -1) -> torch.Tensor:
    """The whole activation from the ranks' blocks: an all-gather over
    "model" onto the axis' device (``core.collectives.gather_blocks``)."""
    full = [None] * axis.size
    for r, b in zip(axis.ranks, blocks):
        full[r] = b
    return collectives.gather_blocks(full, dim, axis.device, sizes)


def scatter(t: torch.Tensor, axis: ModelAxis, sizes: list[int], dim: int = -1) -> list:
    """The ranks' blocks of a tensor every model rank holds whole (each
    rank's slice, on its device; no collective)."""
    starts = _starts(sizes)
    return [t.narrow(dim, starts[r], sizes[r]).to(d) for r, d in zip(axis.ranks, axis.devices)]


def vocab_parallel_embed(w: ModelSplit, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]`` from a leaf whose vocab rows are split over
    "model": each rank looks up the tokens in its rows and writes zeros for
    the rest, then the ranks psum (exact)."""
    starts = _starts(w.sizes)
    parts = []
    for r, blk in zip(w.axis.ranks, w.blocks):
        local = tokens.to(blk.device) - starts[r]
        ok = (local >= 0) & (local < blk.shape[0])
        rows = blk[local.clamp(0, max(blk.shape[0] - 1, 0))]
        parts.append(torch.where(ok[..., None], rows, torch.zeros((), dtype=blk.dtype,
                                                                  device=blk.device)))
    return collectives.psum(parts, w.axis.device, w.axis.size)


def gathered_logits(x: torch.Tensor, head: ModelSplit, policy=None) -> torch.Tensor:
    """f32 logits of ``x`` through a column-split lm_head, all-gathered
    over "model"."""
    return gather(column_parallel(x, head, policy, out_dtype=torch.float32), head.axis,
                  head.sizes)


def split_cache(cache: dict, axis: ModelAxis) -> dict:
    """A serving cache (``Model.init_cache``) as the model ranks hold it:
    each GQA k/v leaf cut along its kv-head axis into the ranks' blocks
    (``sharding.cache_specs``' "model" split), each a copy the rank writes
    in place."""
    def leaf(name, x):
        if name not in ("k", "v"):
            return x
        return [b.clone() for b in scatter(x, axis, block_sizes(x.shape[-2], axis.size), -2)]

    return dict(cache, stages=[[{n: leaf(n, x) for n, x in layer.items()} for layer in stage]
                               for stage in cache["stages"]])


# ------------------------------------------------------------------ layout
class _KeysCotangent(torch.autograd.Function):
    """The identity on a rank's keys (B, S, C) whose cotangent comes back
    sequence-innermost ((B, C, S) in memory)."""

    @staticmethod
    def forward(ctx, k):
        return k.view_as(k)

    @staticmethod
    def backward(ctx, g):
        return g.transpose(1, 2).contiguous().transpose(1, 2)


def keys_cotangent_as_whole(k: torch.Tensor) -> torch.Tensor:
    """A rank's keys, their cotangent laid out as the whole model's. Where a
    rank attends with one kv head and the batch exceeds one,
    ``attention._sdpa``'s einsum squeezes the head and hands the keys'
    cotangent back row-major; with more kv heads, as on the whole model, it
    comes back sequence-innermost. The key bias' gradient is a sum over
    (B, S) in memory order, so without this it adds in another order than
    the whole's (module docstring, Layout)."""
    return _KeysCotangent.apply(k)
