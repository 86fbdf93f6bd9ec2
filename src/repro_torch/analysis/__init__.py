"""repro_torch.analysis — numerical-safety static analysis of the port (the
torch counterpart of ``repro.analysis``).

Two layers, both gated against a shared findings baseline:

* **AST rule pack** (:mod:`rules`, :mod:`astlint`): the reference's RPL
  rules retargeted to torch spellings: raw ``ldexp``/``2**e`` scale
  overflow, fold-order breaks of the bitwise contracts, host math inside
  traced functions, deprecated precision plumbing, products without a
  pinned accumulator dtype (TF32 on the card). Suppressible inline with
  ``# reprolint: disable=RPLxxx(reason)`` (reason mandatory).
* **graph invariant checker** (:mod:`graph_check`, :mod:`registry`): runs
  real entry points under a ``TorchDispatchMode`` recorder, on the card or
  the CPU, and walks the aten dataflow for narrowing downcasts (and TF32
  products) on output paths, int32 overflow chains, in-place hazards, and
  atomic-order float reductions on bitwise-contract paths. The kernels are
  opaque nodes of the graph.

Console entry point: ``reprolint-torch`` (:mod:`cli`), baseline in
``baseline.json`` next to this file.
"""
from .astlint import Finding, lint_file, lint_paths, lint_source, package_relpath
from .baseline import (DEFAULT_BASELINE, baseline_keys, load_baseline,
                       new_findings, save_baseline, update_section)
from .graph_check import (GraphFinding, GraphRecorder, check_entry, check_fn,
                          check_registry, check_trace, trace_entry, trace_fn)
from .registry import ENTRY_POINTS, EntryPoint
from .rules import RULES, Rule

__all__ = [
    "Finding", "lint_file", "lint_paths", "lint_source", "package_relpath",
    "DEFAULT_BASELINE", "baseline_keys", "load_baseline", "new_findings",
    "save_baseline", "update_section",
    "GraphFinding", "GraphRecorder", "check_entry", "check_fn", "check_registry",
    "check_trace", "trace_entry", "trace_fn",
    "ENTRY_POINTS", "EntryPoint", "RULES", "Rule",
]
