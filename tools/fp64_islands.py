#!/usr/bin/env python3
"""Where does an emulated f64 model first leave the native f64 model?

Trains examples/torch_fp64_train.py's model as that driver does (its
profile, steps, batch and sequence length; no checkpoints), then runs the
forward of the f64 copy twice, natively and under ozaki2-fp8/accurate,
recording in call order every GEMM (``matmul``) and every f32 island the
models pass through (``rmsnorm`` and ``apply_rope`` cast their input to
float32; attention's scores come from rope's float32 values). Prints the
logits' deviation by the reference example's measure, the first island
whose float32 input differs between the two runs, and at its first
differing elements the two f64 values, their distance in f64 ulps and
their distance from the f32 rounding boundary between them.

    python3 tools/fp64_islands.py                 # the card, profile paper, 200 steps
    python3 tools/fp64_islands.py --device cpu --profile quick --steps 30 --batch 1 --seq 64
"""
import copy
import dataclasses
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data import DataConfig, synth_batch  # noqa: E402
from repro_torch.models import Model, attention, blocks, layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

#: (module attribute, whether it is an island: casts its input to float32)
RECORDED = {"matmul": False, "rmsnorm": True, "apply_rope": True}


def driver():
    spec = importlib.util.spec_from_file_location(
        "torch_fp64_train", ROOT / "examples" / "torch_fp64_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record_calls(records: list) -> None:
    """Wraps every recorded function where the model modules call it."""
    for mod in (attention, blocks, model_mod, layers):
        for name in RECORDED:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                records.append((_name, a[0].detach().clone(), out.detach().clone()))
                return out

            setattr(mod, name, wrapped)


def main() -> None:
    fp = driver()
    ap = fp.parser()
    ap.set_defaults(profile="paper")
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    cfg = fp.model_cfg(args.profile)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size)
    trainer = Trainer(Model(cfg, device=dev),
                      AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps), dcfg,
                      TrainerConfig(steps=args.steps, ckpt_dir=None,
                                    ckpt_every=max(args.steps // 4, 10), log_every=10))
    params64 = copy.deepcopy(trainer.run().params).to(torch.float64)
    batch = synth_batch(dcfg, cfg, step=10_000)

    records: list = []
    record_calls(records)
    runs = {}
    for gemm in ("native", fp.EMULATED):
        records.clear()
        m = Model(dataclasses.replace(cfg, gemm=gemm, dtype="float64", param_dtype="float64"),
                  device=dev)
        with torch.no_grad():
            logits = m.forward_train(params64, batch).logits.double()
        runs[gemm] = (list(records), logits)
    (nat, lg_nat), (emu, lg_emu) = runs["native"], runs[fp.EMULATED]
    dev_max = ((lg_nat - lg_emu).abs() / (lg_nat.abs() + 1e-6)).max().item()
    print(f"{args.profile}, {args.steps} steps, {args.batch} x {args.seq} tokens on {dev}: "
          f"logits max |d| / (|ref| + 1e-6) = {dev_max:.3e}, "
          f"{(lg_nat == lg_emu).double().mean().item():.4%} bitwise equal")

    islands = 0
    for i, ((name, x_nat, _), (_, x_emu, _)) in enumerate(zip(nat, emu)):
        if not RECORDED[name]:
            continue
        islands += 1
        f_nat, f_emu = x_nat.to(torch.float32), x_emu.to(torch.float32)
        if torch.equal(f_nat, f_emu):
            continue
        gemms = [r[2] for r in nat[:i] if r[0] == "matmul"]
        worst = max(((g - e[2]).abs() / g.abs().clamp(min=1e-300)).max().item()
                    for g, e in zip(gemms, [r for r in emu[:i] if r[0] == "matmul"]))
        where = (f_nat != f_emu).nonzero()
        print(f"first island that rounds differently: call {i} ({name}), island {islands}; "
              f"{len(where)} elements of {tuple(x_nat.shape)}; the GEMMs before it differ "
              f"by at most {worst:.3e} relative, elementwise")
        for idx in where[:3]:
            j = tuple(idx.tolist())
            a, b = x_nat[j].item(), x_emu[j].item()
            ulp = abs(a) * 2.0 ** -52
            mid = (f_nat[j].item() + f_emu[j].item()) / 2
            print(f"  at {j}: native {a!r}, emulated {b!r} ({(b - a) / ulp:+.2f} f64 ulps); f32 "
                  f"{f_nat[j].item()!r} vs {f_emu[j].item()!r}; the f32 rounding boundary "
                  f"{mid!r}: native {(a - mid) / ulp:+.2f}, emulated {(b - mid) / ulp:+.2f} "
                  "f64 ulps from it")
        return
    print(f"no island rounds differently ({islands} island calls)")


if __name__ == "__main__":
    main()
