"""Per-rank cost of a program, counted as it runs (the torch counterpart of
``repro/distribution/hlo_cost.py`` and ``hlo_analysis.py``).

The reference parses the compiled post-SPMD HLO text of a step: its call
graph, the while loops' trip counts, each dot's shapes. The port has no
compiled graph to parse; it runs its own loops. So ``analyze(fn, *args)``
runs ``fn`` under a ``TorchDispatchMode`` that sees every aten op, on real
or ``meta`` tensors (on ``meta`` nothing is computed or stored), and
returns the reference's keys:

  * ``dot_flops``: 2 * prod(result) * prod(contracting dims) for ``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, ``_scaled_mm`` and ``_int_mm``;
    convolutions as the reference counts them, 2 * prod(result) *
    max(prod(kernel) // result channels, 1);
  * ``bytes_written``: the bytes of every op's result (in-place ops'
    included; views write none);
  * ``collective_bytes``: bytes by kind, as the port's collectives
    (``core.collectives``) record them: the result as one rank holds it;
  * ``collective_total``, and ``collective_counts`` by kind;
  * ``collective_purposes``: for each purpose a program named around some
    of its collectives (``collectives.purpose``), their total bytes and
    the largest one's (already counted by kind too).

Beside them: ``peak_bytes``, the high-water mark of the bytes of live
storages that ops created during the call (the arguments' own storages
are not in it), and ``ops``, the count of ops seen. A run inside a
collective is the collective's, not the program's: it is not counted.
The ops of a CUDA kernel launched through ``ctypes`` (K1-K6) are not aten
ops and are not seen; on ``meta`` an Ozaki-II policy runs on ``+core``.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import collectives

_aten = torch.ops.aten
#: dot ops -> the position of their left operand (``addmm``'s and
#: ``baddbmm``'s first argument is the added one)
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten._int_mm.default: 0,
         _aten.addmm.default: 1, _aten.baddbmm.default: 1}
_CONVS = (_aten.convolution.default, _aten.convolution_backward.default)


def _dot_flops(func, args, out) -> float:
    lhs = _DOTS.get(func, 0 if func.overloadpacket is _aten._scaled_mm else None)
    if lhs is None:
        return 0.0
    return 2.0 * out.numel() * args[lhs].shape[-1]


def _conv(res: torch.Tensor, ker: torch.Tensor) -> float:
    """The reference's count of one convolution: 2 * prod(result) *
    max(prod(kernel) // result channels, 1) (channels: dim 1 in torch)."""
    res_ch = res.shape[1] if res.dim() > 1 else 1
    return 2.0 * res.numel() * max(ker.numel() // max(res_ch, 1), 1)


def _conv_flops(func, args, out) -> float:
    if func is _aten.convolution.default:
        return _conv(out[0], args[1])
    if func is _aten.convolution_backward.default:
        # the input's gradient convolves the output's with the weight; the
        # weight's convolves it with the input (each a convolution in HLO)
        grad_out, _, weight = args[:3]
        g_in, g_w = out[0], out[1]
        return ((_conv(g_in, weight) if g_in is not None else 0.0)
                + (_conv(g_w, grad_out) if g_w is not None else 0.0))
    return 0.0


class CostCounter(TorchDispatchMode):
    """The dispatch mode behind ``analyze``; also usable directly as a
    context manager (``with CostCounter() as c: ...; c.result()``)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.bytes_written = 0.0
        self.coll = defaultdict(float)
        self.coll_counts = defaultdict(int)
        self.purposes: dict = {}  # purpose -> {"bytes", "largest"}
        self.ops = 0
        self._live: dict = {}  # storage key -> bytes, until the storage dies
        self._live_bytes = 0
        self.peak_bytes = 0

    def add_collective(self, kind: str, nbytes: int, purpose: str | None = None) -> None:
        self.coll[kind] += nbytes
        self.coll_counts[kind] += 1
        if purpose is not None:
            rec = self.purposes.setdefault(purpose, {"bytes": 0.0, "largest": 0.0})
            rec["bytes"] += nbytes
            rec["largest"] = max(rec["largest"], float(nbytes))

    def __enter__(self):
        self._counting = collectives.counting(self)
        self._counting.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._counting.__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if collectives.inside():
            return out
        self.ops += 1
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs:
            self.dot_flops += _dot_flops(func, args, outs[0])
        if func in _CONVS:
            self.dot_flops += _conv_flops(func, args, out if isinstance(out, tuple) else (out,))
        aliases = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in aliases):
            return out  # a view writes nothing
        for t in outs:
            self.bytes_written += t.numel() * t.element_size()
            if not any(a is not None for a in aliases):  # in place: no new storage
                self._track(t)
        return out

    def result(self) -> dict:
        coll = {k: float(v) for k, v in self.coll.items()}
        return {"dot_flops": self.dot_flops, "bytes_written": self.bytes_written,
                "collective_bytes": coll, "collective_total": float(sum(coll.values())),
                "collective_counts": dict(self.coll_counts),
                "collective_purposes": {k: dict(v) for k, v in self.purposes.items()},
                "peak_bytes": self.peak_bytes, "ops": self.ops}


def analyze(fn, *args, **kwargs) -> dict:
    """The cost of ``fn(*args, **kwargs)`` (the module docstring's keys),
    with its return value under ``"result"``."""
    with CostCounter() as c:
        res = fn(*args, **kwargs)
    out = c.result()
    out["result"] = res
    return out


def collective_bytes(cost: dict) -> dict:
    """{"bytes", "counts", "total_bytes"} of the collectives of an
    ``analyze`` result (the counterpart of ``hlo_analysis.collective_bytes``
    over HLO text)."""
    coll = dict(cost.get("collective_bytes", {}))
    return {"bytes": coll, "counts": dict(cost.get("collective_counts", {})),
            "total_bytes": sum(coll.values())}


def flops_and_bytes(cost: dict) -> tuple[float, float]:
    """(flops, bytes) of an ``analyze`` result (the counterpart of
    ``hlo_analysis.flops_and_bytes`` over ``cost_analysis()``)."""
    return float(cost.get("dot_flops", 0.0)), float(cost.get("bytes_written", 0.0))
