"""Layer 2: the graph invariant checker (the torch counterpart of
``repro/analysis/jaxpr_check.py``): run real entry points under a
``TorchDispatchMode`` recorder, build the dataflow graph of the aten ops
they run, and flag the numeric-bug classes that only show in the dataflow:

* **RPJ001 narrowing downcast**: a float64 -> float32/bf16/f16 ``_to_copy``
  (or ``copy_``) on dataflow that reaches an output. On CUDA also a float32
  ``mm``/``bmm``/``addmm`` run while ``torch.backends.cuda.matmul.allow_tf32``
  is on: the tensor cores round its operands to TF32.
* **RPJ002 int32 overflow chain**: an int32 multiply (Python-int scalars
  count as int32, as the reference's weak-typed literals do; in-place
  variants too) feeding an int32 add/sub/sum/mm-family op.
* **RPJ003 in-place hazards**: entries declare the arguments they update in
  place (``inplace=``, the reference's ``donate=``). A declared argument no
  op writes means the update went to a copy (memory doubles and the
  caller's buffer is stale); one returned unwritten is flagged too.
* **RPJ004 nondeterministic-order reduction**: on ``bitwise=True`` entries,
  a float ``index_add``, ``scatter_add``, ``scatter_reduce`` (sum/mean),
  ``index_put(accumulate=True)`` or ``embedding_dense_backward``: CUDA
  accumulates them with atomics. The port's psum (``core.collectives``) is
  an explicit fold in ascending rank order and is not flagged, where the
  reference flags ``psum``.

The port's code is eager and reads the host, so it is traced by running
it. Tensors are keyed by storage, so a view aliases its base; an op whose
schema writes an argument (``alias_info.is_write``: ``add_``,
``index_put_``, ``flat[idx] = vals``) makes a new version of the storage;
storages no recorded op made (``torch.as_tensor`` of numpy, constants) and
the scalars of ``.item()`` are leaves. A hand-written kernel launched
through ``ctypes`` is not an aten op: its wrapper and plain version are
scopes (``kernels.launch.kernel_scope``), and a launched call becomes one
node from its input tensors to its output tensors. Findings remember the
outermost scope they sit in, so a plain version's findings are told from
the glue's.

Findings are keyed by a *signature* in the reference's vocabulary (check,
primitive, dtypes, shape: ``RPJ001:convert:float64->float32:8x16``,
``RPJ002:mul->add:int32:8x8``, ``RPJ004:scatter-add:float64:8``) and
deduplicated, so port keys and reference keys compare as strings.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import launch

_NARROW_FLOATS = ("float32", "bfloat16", "float16")
#: aten op -> the reference's primitive of an accumulation fed by a multiply.
_ACCUM = {"add": "add", "sub": "sub", "rsub": "sub", "sum": "reduce_sum",
          "mm": "dot_general", "bmm": "dot_general", "addmm": "dot_general",
          "baddbmm": "dot_general", "dot": "dot_general", "mv": "dot_general",
          "_int_mm": "dot_general"}
#: The cuBLAS GEMMs that run on TF32 tensor cores when the switch is on.
_TF32_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm"})
_CASTS = frozenset({"_to_copy", "copy"})


@dataclasses.dataclass(frozen=True)
class GraphFinding:
    entry: str
    check: str
    signature: str
    message: str
    #: the outermost kernel scope (wrapper or plain version) the op ran in
    scope: str | None = None

    @property
    def key(self) -> str:
        return f"{self.entry}:{self.signature}"

    def render(self) -> str:
        where = f" (in {self.scope})" if self.scope else ""
        return f"[{self.entry}] {self.check}{where}: {self.message}"


@dataclasses.dataclass
class Node:
    """One recorded op: ``op`` the aten packet without a trailing ``_``
    (``mul`` for ``mul_.Tensor``), ``kernel:<name>`` for a launched kernel,
    ``input``/``leaf`` for values no op made."""
    op: str
    inputs: tuple = ()       # producer node of each tensor input, in order
    in_types: tuple = ()     # (dtype, shape) of each tensor input
    out_types: tuple = ()    # (dtype, shape) of each tensor output
    int_scalars: bool = True  # no Python float among the arguments
    scope: str | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Scope:
    """A finished outermost kernel scope: launched on the card, or the plain
    version (no launch); the dtypes and shapes of its tensors in and out."""
    name: str
    launched: bool
    in_types: tuple
    out_types: tuple


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _meta(t: torch.Tensor) -> tuple:
    return (_dtype(t), tuple(t.shape))


def _shape(shape) -> str:
    return "x".join(str(d) for d in shape)


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def leaves(x) -> list:
    """The tensors of an argument in a fixed order: tensors, sequences,
    dicts (by insertion), dataclasses (by field) and modules (parameters and
    buffers by name)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.state_dict(keep_vars=True).values())
    if isinstance(x, dict):
        return [t for v in x.values() for t in leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in leaves(getattr(x, f.name))]
    return []


def _arg(func, args, kwargs, name: str, default=None):
    """The value of schema argument ``name`` of one call."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            if i < len(args):
                return args[i]
            return kwargs.get(name, default)
    return default


class GraphRecorder(TorchDispatchMode):
    """Records the dataflow graph of what runs in its block; also the scope
    sink of ``kernels.launch`` while active."""

    def __init__(self):
        super().__init__()
        self.nodes: list[Node] = []
        self.scopes: list[Scope] = []
        self._writer: dict = {}    # storage key -> node that wrote its last version
        self._open: list = []      # open kernel scopes, outermost first
        self._inputs: dict = {}    # storage key -> input node
        self._finalizers: list = []  # drop a dead storage's key (detached on exit)

    # -- values -------------------------------------------------------------
    def _key(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._writer:
            self._finalizers.append(weakref.finalize(st, self._writer.pop, key, None))
        return key

    def _add(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def _read(self, t: torch.Tensor) -> int:
        key = self._key(t)
        if key not in self._writer:
            self._writer[key] = self._add(Node("leaf", out_types=(_meta(t),)))
        return self._writer[key]

    def _write(self, t: torch.Tensor, node: int) -> None:
        self._writer[self._key(t)] = node

    def add_input(self, t: torch.Tensor, index: int) -> None:
        nid = self._add(Node("input", out_types=(_meta(t),), attrs={"index": index}))
        self._write(t, nid)
        self._inputs[self._key(t)] = nid

    # -- kernel scopes ------------------------------------------------------
    def enter_scope(self, name: str, args, kwargs) -> None:
        ins = _tensors((args, kwargs))
        self._open.append({"name": name, "launched": False,
                           "inputs": tuple(self._read(t) for t in ins),
                           "in_types": tuple(_meta(t) for t in ins)})

    def launched(self) -> None:
        if self._open:
            self._open[0]["launched"] = True

    def exit_scope(self, name: str, out) -> None:
        frame = self._open.pop()
        if self._open:
            return  # nested: the outermost scope stands for the call
        outs = _tensors(out)
        out_types = tuple(_meta(t) for t in outs)
        if frame["launched"]:
            nid = self._add(Node(f"kernel:{name}", frame["inputs"], frame["in_types"],
                                 out_types, scope=name))
            for t in outs:
                self._write(t, nid)
        self.scopes.append(Scope(name, frame["launched"], frame["in_types"], out_types))

    def __enter__(self):
        launch.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            launch.RECORDERS.remove(self)
            for f in self._finalizers:
                f.detach()

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        inputs = tuple(self._read(t) for t in ins)
        out = func(*args, **kwargs)
        aliases = [r.alias_info for r in func._schema.returns]
        if aliases and all(a is not None and not a.is_write for a in aliases):
            return out  # a view: it aliases its base and writes nothing
        outs = _tensors(out)
        op = func.overloadpacket.__name__.removesuffix("_")
        node = Node(op, inputs, tuple(_meta(t) for t in ins), tuple(_meta(t) for t in outs),
                    not any(isinstance(a, float) for a in flat),
                    self._open[0]["name"] if self._open else None)
        if op in _TF32_DOTS and ins and ins[0].is_cuda and ins[0].dtype == torch.float32:
            node.attrs["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
        elif op in ("index_put", "_index_put_impl"):
            node.attrs["accumulate"] = bool(_arg(func, args, kwargs, "accumulate", False))
        elif op in ("scatter_reduce", "scatter"):
            node.attrs["reduce"] = _arg(func, args, kwargs, "reduce")
        nid = self._add(node)
        for t in outs:
            self._write(t, nid)
        return out


@dataclasses.dataclass
class Trace:
    """What ``trace_fn`` recorded: the nodes in execution order, the nodes
    that wrote the outputs (the returned tensors and every argument storage
    written in place), each declared in-place argument's state, the kernel
    scopes, and the call's result."""
    nodes: list
    outputs: set
    inplace: list            # (flat index, dtype, shape, written, returned)
    scopes: list
    result: object


def trace_fn(fn, args, *, inplace: tuple[int, ...] = ()) -> Trace:
    """Run ``fn(*args)`` under the recorder (without autograd) and return
    its graph. ``inplace``: the positions of ``args`` that ``fn`` updates in
    place."""
    rec = GraphRecorder()
    flat_args = [leaves(a) for a in args]
    with torch.no_grad(), rec:
        index = 0
        declared = []
        for i, ts in enumerate(flat_args):
            for t in ts:
                rec.add_input(t, index)
                if i in inplace:
                    declared.append((index, t))
                index += 1
        result = fn(*args)
        returned = {rec._key(t) for t in leaves(result)}
        outputs = {rec._read(t) for t in leaves(result)}
        outputs |= {w for k, w in rec._writer.items()
                    if k in rec._inputs and w != rec._inputs[k]}
        state = [(i, _dtype(t), _shape(t.shape), rec._read(t) != rec._inputs[rec._key(t)],
                  rec._key(t) in returned) for i, t in declared]
    return Trace(rec.nodes, outputs, state, rec.scopes, result)


# ---------------------------------------------------------------------------
# the four checks
# ---------------------------------------------------------------------------
def _live(trace: Trace) -> set:
    """Nodes whose dataflow reaches an output (backward closure; nodes are
    in execution order, so one reversed pass)."""
    live = set(trace.outputs)
    for i in range(len(trace.nodes) - 1, -1, -1):
        if i in live:
            live.update(trace.nodes[i].inputs)
    return live


def check_narrowing(entry_name: str, trace: Trace) -> list[GraphFinding]:
    """RPJ001: f64 -> narrower-float conversions, and TF32 products, on
    output-reaching paths."""
    found = []
    live = _live(trace)
    for i, node in enumerate(trace.nodes):
        if i not in live:
            continue
        if node.op in _CASTS and node.out_types:
            # _to_copy(src) -> out; copy_(dst, src) writes dst's dtype
            (src, src_shape) = node.in_types[-1]
            dst = node.out_types[0][0]
            if src != "float64" or dst not in _NARROW_FLOATS:
                continue
            found.append(GraphFinding(
                entry_name, "RPJ001", f"RPJ001:convert:{src}->{dst}:{_shape(src_shape)}",
                f"float64 -> {dst} downcast of a {_shape(src_shape)} value on "
                "dataflow reaching an output — precision silently drops below "
                "the emulation target unless the value is bounded (then "
                "baseline with the bound as the note)", node.scope))
        elif node.attrs.get("tf32"):
            lhs = _shape(node.in_types[-2][1])
            found.append(GraphFinding(
                entry_name, "RPJ001", f"RPJ001:dot_general:float32->tf32:{lhs}",
                f"float32 {node.op} ({lhs} lhs) run while "
                "torch.backends.cuda.matmul.allow_tf32 is on: the tensor cores "
                "round its operands to TF32 (10-bit mantissa)", node.scope))
    return found


def check_int32_chain(entry_name: str, trace: Trace) -> list[GraphFinding]:
    """RPJ002: int32 mul feeding an int32 add/reduction without widening."""
    consumers: dict = {}
    for i, node in enumerate(trace.nodes):
        for j in set(node.inputs):
            consumers.setdefault(j, []).append(node)
    found = []
    for i, node in enumerate(trace.nodes):
        if node.op != "mul" or not node.int_scalars or not node.out_types:
            continue
        if not all(d == "int32" for d, _ in (*node.in_types, *node.out_types)):
            continue
        shape = _shape(node.out_types[0][1])
        for consumer in consumers.get(i, ()):
            prim = _ACCUM.get(consumer.op)
            if prim and consumer.out_types and consumer.out_types[0][0] == "int32":
                found.append(GraphFinding(
                    entry_name, "RPJ002", f"RPJ002:mul->{prim}:int32:{shape}",
                    f"int32 multiply ({shape}) feeds an int32 {prim} — the "
                    "residue-MMA overflow class; widen to int64 or baseline "
                    "with the magnitude proof", node.scope))
                break
    return found


def check_inplace(entry_name: str, trace: Trace) -> list[GraphFinding]:
    """RPJ003: declared in-place arguments must be written, not copied."""
    found = []
    for i, dtype, shape, written, returned in trace.inplace:
        if written:
            continue
        if returned:
            found.append(GraphFinding(
                entry_name, "RPJ003", f"RPJ003:passthrough-donated:{i}",
                f"in-place input #{i} ({dtype} {shape}) is returned unwritten — "
                "the caller's buffer comes back without the update"))
        else:
            found.append(GraphFinding(
                entry_name, "RPJ003", f"RPJ003:unused-donated:{i}",
                f"in-place input #{i} ({dtype} {shape}) is never written — "
                "the update went to a copy: memory doubles and the caller's "
                "buffer is stale"))
    return found


def _unordered(node: Node) -> bool:
    if node.op in ("index_add", "scatter_add", "embedding_dense_backward"):
        return True
    if node.op in ("index_put", "_index_put_impl"):
        return node.attrs.get("accumulate", False)
    if node.op in ("scatter_reduce", "scatter"):
        return node.attrs.get("reduce") in ("sum", "mean", "add")
    return False


def check_nondeterministic_reductions(entry_name: str, trace: Trace) -> list[GraphFinding]:
    """RPJ004: unordered float accumulation on bitwise-contract paths."""
    found = []
    for node in trace.nodes:
        if not _unordered(node) or not node.out_types:
            continue
        dt, shape = node.out_types[0]
        if not dt.startswith(("float", "bfloat")):
            continue
        found.append(GraphFinding(
            entry_name, "RPJ004", f"RPJ004:scatter-add:{dt}:{_shape(shape)}",
            f"float {node.op} on a bitwise-contract entry point: CUDA "
            "accumulates it with atomics in a scheduled order, so results "
            "are not reproducible across the contract's paths", node.scope))
    return found


# ---------------------------------------------------------------------------
# running the checks
# ---------------------------------------------------------------------------
def _dedupe(findings: list[GraphFinding]) -> list[GraphFinding]:
    """One finding a key; an occurrence outside every kernel scope wins."""
    seen: dict[str, GraphFinding] = {}
    for f in findings:
        if f.key not in seen or (seen[f.key].scope and not f.scope):
            seen[f.key] = f
    return list(seen.values())


def check_trace(name: str, trace: Trace, *, bitwise: bool = False) -> list[GraphFinding]:
    """Every invariant check on a recorded trace."""
    findings = []
    findings += check_narrowing(name, trace)
    findings += check_int32_chain(name, trace)
    findings += check_inplace(name, trace)
    if bitwise:
        findings += check_nondeterministic_reductions(name, trace)
    return _dedupe(findings)


def check_fn(name: str, fn, args, *, bitwise: bool = False,
             inplace: tuple[int, ...] = ()) -> list[GraphFinding]:
    """Run ``fn(*args)`` under the recorder and run every invariant check."""
    return check_trace(name, trace_fn(fn, args, inplace=inplace), bitwise=bitwise)


def trace_entry(entry, device=None, suffix: str = "") -> Trace:
    """Build one :class:`repro_torch.analysis.registry.EntryPoint` on
    ``device`` (None: the card) and trace it; ``suffix`` is appended to the
    specs of the ``ozmm`` entries (``"+pallas"``: the kernel route)."""
    fn, args = entry.build(device, suffix)
    return trace_fn(fn, args, inplace=entry.inplace)


def check_entry(entry, device=None) -> list[GraphFinding]:
    """Check one registry entry on ``device`` (None: the card)."""
    return check_trace(entry.name, trace_entry(entry, device), bitwise=entry.bitwise)


def check_registry(entries=None, device=None) -> tuple[list[GraphFinding], list[str]]:
    """Check every registered entry point on ``device`` (None: the card);
    returns (findings, names)."""
    from .registry import ENTRY_POINTS

    entries = ENTRY_POINTS if entries is None else entries
    findings: list[GraphFinding] = []
    names: list[str] = []
    for entry in entries:
        findings.extend(check_entry(entry, device))
        names.append(entry.name)
    return findings, names
