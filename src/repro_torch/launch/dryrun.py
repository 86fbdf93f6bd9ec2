"""Multi-pod dry run: every (arch x shape x mesh) cell traced on the ``meta``
device, with its per-rank cost (the torch counterpart of
``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k

The reference lowers and compiles each cell for 256 or 512 fake host
devices and reads per-device FLOPs, bytes and collective bytes from the
post-SPMD HLO. The port has no compiler to ask: it builds the model on
``meta`` at full width, places the state by ``param_specs`` on a
production mesh of ``meta`` devices, and runs rank 0's program (the
sharded train step, prefill or decode, each on its local block shapes)
under ``distribution.op_cost``'s counter. Every rank runs the same program
on blocks of the same shape, so rank 0's numbers are every rank's. Nothing
is computed and nothing is allocated.

On the dense family the program is tensor-parallel over "model", as
GSPMD's is (``models.tensor_parallel``): rank 0 holds its blocks of
the leaves split over "model", gathered over the data axes alone, and
computes its column and row blocks of each GEMM, its heads of attention
(or the whole attention on all-gathered q/k/v where the head counts do
not divide "model"), its cache block, and psums the row-parallel partials.
``model_flops`` is that program's analytic count. The other families
gather their leaves over "model" (``distribution.spmd``), so on a mesh
with a "model" axis their FLOPs, bytes and collective bytes differ from
the reference's by design: per rank, the port runs its data rank's whole
GEMMs of those leaves and all-gathers each.

One departure stays in the tensor-parallel train step: it all-gathers
each gradient leaf split over "model", one at a time, for the clipping norm
(``spmd``: the single-device norm's bits), where GSPMD psums partial sums
of squares. Those bytes are in ``collective_bytes_per_device``'s
all-gather and again, on their own, in ``clip_norm_gather_bytes_per_device``
(with the largest leaf's, ``clip_norm_largest_gather_bytes``: the
transient a rank holds for it), so a pod-fit answer can be read without
them. Under remat "full" the recompute skips each layer's MLP down
projection, on one device and tensor-parallel alike, but after a
post-norm (gemma2), which saves its output (``model_flops``).

Records keep the reference's keys, with ``trace_s`` in place of
``lower_s`` and ``compile_s`` and ``entry_flops`` None (XLA's entry
computation alone has no counterpart). ``memory.peak_bytes`` is the rank's
argument bytes plus the counter's high-water mark of the storages the
program created (a lower bound: storages that ops outside the aten
dispatcher make, and allocator slack, are not seen). Artifacts (JSON, no
HLO) go to ``experiments/dryrun/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, input_specs
from repro_torch.core import collectives
from repro_torch.distribution import batch_specs, cache_specs, named, param_specs
from repro_torch.distribution.op_cost import analyze
from repro_torch.distribution.sharding import P
from repro_torch.distribution.sharding import model_split
from repro_torch.distribution.spmd import (bind, data_size, make_sharded_train_step, place,
                                           rank_leaf, sharded_programs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as opt_init
from repro_torch.precision import PrecisionPolicy
from repro_torch.train.step import TrainState

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

#: per-arch dry-run training overrides: big models need bf16 params + 8-bit
#: Adam moments (the reference's).
BIG_ARCHS = {"deepseek-v3-671b": dict(param_dtype="bfloat16"),
             "gemma2-27b": dict(param_dtype="bfloat16"),
             "internvl2-26b": dict(param_dtype="bfloat16")}
EIGHTBIT_ADAM = {"deepseek-v3-671b"}


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _rank_state_bytes(tree, rank: int) -> int:
    """Bytes of ``rank``'s blocks in a tree of ``Placed`` leaves."""
    if hasattr(tree, "blocks"):
        return _nbytes(tree.blocks[rank])
    if isinstance(tree, dict):
        return sum(_rank_state_bytes(v, rank) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_rank_state_bytes(v, rank) for v in tree)
    return 0


def _cache_block(cache, specs, mesh, rank: int, rows: P, split_kv: bool, name: str = ""):
    """Rank ``rank``'s cache in its program: the rows of its batch block
    (``rows``: the batch's spec; every cache leaf is batch-major), whole
    along every other axis but, with ``split_kv`` (tensor-parallel
    attention), a k/v leaf's kv heads: the rank's block of them, as the
    list of the one model rank run. Where the block ``cache_specs`` stores
    on the rank holds less, the rank gathers it (recorded as an all-gather
    of the block it runs on)."""
    if isinstance(cache, torch.Tensor):
        kv = split_kv and name in ("k", "v")
        tail = [None] * (cache.dim() - len(rows))
        if kv:
            tail[-2] = "model"
        need = named(mesh, P(*rows, *tail)).block(cache, rank)
        if named(mesh, specs).block(cache, rank).numel() < need.numel():
            with collectives.collective("all-gather") as done:
                done(_nbytes(need))
        return [need.clone()] if kv else need.clone()
    if isinstance(cache, dict):
        return {k: _cache_block(v, specs[k], mesh, rank, rows, split_kv, k)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_cache_block(v, s, mesh, rank, rows, split_kv) for v, s in zip(cache, specs)]
    return cache


def _stored_bytes(cache, specs, mesh, rank: int) -> int:
    """Bytes of the cache blocks ``cache_specs`` stores on ``rank``."""
    if isinstance(cache, torch.Tensor):
        return _nbytes(named(mesh, specs).block(cache, rank))
    if isinstance(cache, dict):
        return sum(_stored_bytes(v, specs[k], mesh, rank) for k, v in cache.items())
    if isinstance(cache, list):
        return sum(_stored_bytes(v, s, mesh, rank) for v, s in zip(cache, specs))
    return 0


def model_flops(cfg, kind: str, batch: int, seq_len: int, cache_len: int | None = None,
                model: int = 1) -> float:
    """The analytic dot FLOPs of one rank's program on ``batch`` sequences
    for a dense GQA config under a native policy, in the port's
    decomposition, tensor-parallel over ``model`` ranks (the rank's block,
    ceil(n / model) of n, of each split dimension): per layer the q, k, v,
    o projections, attention's two einsums over the whole key length (bmm;
    on the rank's heads where ``head_local``, else on all of them) and the
    MLP's GEMMs; the lm_head on every position (train) or the last
    (prefill, decode). Training adds the two cotangent GEMMs of each (3x the
    forward) and, under remat "full", each layer's forward again but its
    last GEMM, the MLP's down projection (torch's non-reentrant checkpoint
    stops its recompute once every tensor saved for the backward is back;
    a row-parallel product packs its operands before it runs,
    ``tensor_parallel._RowOperands``). A post-norm (gemma2) saves that
    GEMM's output: then the recompute runs the whole layer."""
    from repro_torch.models.attention import _h_eff, head_local

    if cfg.family not in ("dense",) or cfg.use_mla:
        raise ValueError(f"model_flops counts dense GQA configs, not {cfg.family!r}")
    d, h, kv, hd = cfg.d_model, _h_eff(cfg), cfg.num_kv_heads, cfg.head_dim
    blk = lambda n: -(-n // model)  # noqa: E731 - rank 0's block, the longest
    tokens = batch * (1 if kind == "decode" else seq_len)
    keys = cache_len if kind == "decode" else seq_len
    queries = 1 if kind == "decode" else seq_len
    proj = 2 * tokens * d * (2 * blk(h * hd) + 2 * blk(kv * hd))
    down = 2 * tokens * d * blk(cfg.d_ff)
    mlp = (3 if cfg.gated_mlp else 2) * down
    heads = h // model if head_local(cfg, model) else h
    attn = 2 * 2 * batch * heads * queries * keys * hd
    layer = proj + mlp + attn
    head_rows = tokens if kind == "train" else batch
    head = 2 * head_rows * d * blk(cfg.padded_vocab)
    fwd = cfg.num_layers * layer + head
    if kind != "train":
        return float(fwd)
    recompute = layer if cfg.post_norms else layer - down
    return float(3 * fwd + (cfg.num_layers * recompute if cfg.remat == "full" else 0))


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, gemm_backend: str = "native",
                overrides: dict | None = None, expert_mode: str = "fsdp",
                gemm_mode: str = "fast", *, variant: str = "full", mesh=None) -> dict:
    """One cell's record (the reference's keys, ``trace_s`` for its lower and
    compile times). ``variant`` and ``mesh`` (default: the production mesh
    of ``meta`` devices) size a cell down for tests."""
    cfg = get_config(arch, variant, **BIG_ARCHS.get(arch, {}))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if gemm_backend != "native":  # on meta only the core route runs
        cfg = dataclasses.replace(cfg, gemm=PrecisionPolicy(scheme=gemm_backend, mode=gemm_mode,
                                                            backend="core"))
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                             devices="meta")
    model = Model(cfg, device="meta")
    t0 = time.time()
    params = model.init()
    specs = input_specs(cfg, shape)
    n_data = data_size(mesh, multi_pod)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(eightbit=arch in EIGHTBIT_ADAM)
        params.requires_grad_(True)
        state = TrainState(params, opt_init(opt_cfg, reference_leaves(params)))
        shard_state, step, _ = make_sharded_train_step(
            model, opt_cfg, mesh, fsdp=True, multi_pod=multi_pod, expert_mode=expert_mode)
        sharded = shard_state(state)
        del state
        arg_bytes = _rank_state_bytes(sharded, 0) + sum(
            _nbytes(named(mesh, s).block(specs[k], 0))
            for k, s in batch_specs(specs, multi_pod).items())
        cost = analyze(step, sharded, specs, ranks=[0])
        out_bytes = _rank_state_bytes(sharded, 0) + _nbytes(cost["result"][1])
    else:
        b = shape.global_batch
        psh_specs = param_specs(params, fsdp=True, multi_pod=multi_pod,
                                expert_mode=expert_mode)
        psh = named(mesh, psh_specs)
        placed = {k: place(p.detach(), psh[k]) for k, p in reference_leaves(params).items()}
        if shape.kind == "prefill":
            batch, max_len = specs, shape.seq_len
        else:  # decode: one token a sequence against a cache of seq_len
            batch = {"tokens": torch.empty((b, shape.seq_len), dtype=torch.int32,
                                           device="meta")}
            if cfg.frontend == "vit-stub":
                batch["patch_embeds"] = torch.empty((b, cfg.frontend_len, cfg.frontend_dim),
                                                    dtype=torch.bfloat16, device="meta")
            if cfg.family == "encdec":
                batch["frames"] = torch.empty((b, shape.seq_len, cfg.frontend_dim),
                                              dtype=torch.bfloat16, device="meta")
            max_len = shape.seq_len + 8
        cache = model.init_cache(params, batch, max_len)
        cspecs = cache_specs(cache, cfg, mesh, multi_pod)
        token = torch.empty((b,), dtype=torch.int32, device="meta")
        dp = P(("pod", "data") if multi_pod else "data")
        tok_spec = dp if b % n_data == 0 else P()
        rows = dp if shape.kind == "prefill" else tok_spec
        skeleton = Model(cfg, device="meta").init()
        split = model_split(psh_specs, cfg, mesh)

        def program(placed, batch, cache):
            outs = []
            for _, _, leaves, block in sharded_programs(mesh, placed, batch, multi_pod=multi_pod,
                                                        ranks=[0], split=split):
                bind(skeleton, {k: rank_leaf(t, False) for k, t in leaves.items()})
                rank_cache = _cache_block(cache, cspecs, mesh, 0, rows, bool(split))
                with torch.no_grad():
                    if shape.kind == "prefill":
                        outs.append(model.prefill(skeleton, block, rank_cache))
                    else:
                        tok = named(mesh, tok_spec).block(token, 0)
                        outs.append(model.decode_step(skeleton, tok, rank_cache))
            return outs[0]

        arg_bytes = (_rank_state_bytes(placed, 0)
                     + _stored_bytes(cache, cspecs, mesh, 0)
                     + (sum(_nbytes(named(mesh, s).block(specs[k], 0))
                            for k, s in batch_specs(specs, multi_pod).items())
                        if shape.kind == "prefill"
                        else _nbytes(named(mesh, tok_spec).block(token, 0))))
        cost = analyze(program, placed, batch if shape.kind == "prefill" else {}, cache)
        out_bytes = _nbytes(cost["result"][0]) + _nbytes(cost["result"][1])
    trace_s = time.time() - t0
    clip = cost["collective_purposes"].get("clip-norm", {"bytes": 0.0, "largest": 0.0})
    return {
        "status": "ok",
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "gemm_backend": gemm_backend,
        "num_devices": int(mesh.devices.size),
        "trace_s": round(trace_s, 1),
        "entry_flops": None,  # no entry computation: the port counts the whole program
        "flops_per_device": cost["dot_flops"],
        "bytes_per_device": cost["bytes_written"],
        "collective_bytes_per_device": cost["collective_bytes"],
        "collective_total_per_device": cost["collective_total"],
        "clip_norm_gather_bytes_per_device": clip["bytes"],
        "clip_norm_largest_gather_bytes": clip["largest"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": cost["peak_bytes"],
            "peak_bytes": arg_bytes + cost["peak_bytes"],
        },
        "model_params": cfg.param_count(),
        "model_active_params": cfg.active_param_count(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--gemm-backend", default="native")
    ap.add_argument("--gemm-mode", default="fast")
    ap.add_argument("--expert-sharding", default="fsdp", choices=["fsdp", "ep"])
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=int (hillclimb knobs)")
    ap.add_argument("--tag", default="", help="artifact name suffix")
    ap.add_argument("--out-dir", default=ART_DIR)
    args = ap.parse_args()

    os.makedirs(args.out_dir, exist_ok=True)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
                if args.gemm_backend != "native":
                    tag += f"__{args.gemm_backend}-{args.gemm_mode}"
                if args.tag:
                    tag += f"__{args.tag}"
                out_path = os.path.join(args.out_dir, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[skip cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    overrides = {}
                    for kv in args.set:
                        key, val = kv.split("=")
                        overrides[key] = int(val)
                    res = dryrun_cell(arch, shape, mp, args.gemm_backend,
                                      overrides=overrides,
                                      expert_mode=args.expert_sharding,
                                      gemm_mode=args.gemm_mode)
                    res["tag"] = args.tag
                except Exception as e:  # noqa: BLE001 - record and continue
                    res = {"status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"  -> {res['status']}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
