"""``reprolint-torch`` console entry point (also ``python -m
repro_torch.analysis``), the torch counterpart of ``repro/analysis/cli.py``.

    reprolint-torch                               # AST rule pack over the port
    reprolint-torch src/repro_torch --graph       # + the graph checker, on the card
    reprolint-torch --graph-only --device cpu     # just the traced entry points, CPU
    reprolint-torch --graph-only --device cpu --update-baseline
    reprolint-torch --list-rules                  # rule catalog

Exit status: 0 when every finding is baselined (or suppressed with a
reason), 1 on any new finding, 2 on usage errors. The baseline defaults to
the packaged ``src/repro_torch/analysis/baseline.json``; the paths default
to the installed ``repro_torch`` package. The graph layer runs its entries
on ``--device`` (default ``cuda``): without a card it raises, and it runs
on the CPU only when asked (``--device cpu``).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import astlint, baseline as baseline_mod
from .rules import RULES

#: The installed package: what a bare run lints.
PACKAGE_DIR = Path(__file__).resolve().parents[1]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="reprolint-torch",
        description="numerical-safety static analysis for the repro_torch tree "
                    "(AST rule pack + dispatch-traced graph checker)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the repro_torch package)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline JSON (default: the packaged baseline)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline section(s) for the layer(s) "
                        "run, keeping notes on surviving keys")
    p.add_argument("--graph", action="store_true",
                   help="also run the entry-point registry and the graph "
                        "invariant checks")
    p.add_argument("--graph-only", action="store_true",
                   help="run only the graph invariant checker")
    p.add_argument("--device", default="cuda",
                   help="device of the graph checker's entries (default: cuda)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _print_rules() -> None:
    for rule in RULES.values():
        print(f"{rule.code} [{rule.name}]")
        print(f"    {rule.summary}")
        print(f"    fix: {rule.fix_hint}")


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        _print_rules()
        return 0

    data = baseline_mod.load_baseline(args.baseline)
    baseline_path = args.baseline or baseline_mod.DEFAULT_BASELINE
    failed = False
    ran_sections: dict[str, list] = {}

    if not args.graph_only:
        paths = args.paths or [PACKAGE_DIR]
        findings = astlint.lint_paths(paths)
        ran_sections["astlint"] = findings
        new = baseline_mod.new_findings(findings, data, "astlint")
        for f in new:
            print(f.render())
        n_base = len(findings) - len(new)
        print(f"astlint: {len(new)} new finding(s), {n_base} baselined "
              f"({sum(1 for _ in astlint.iter_python_files(paths))} files)")
        failed |= bool(new)

    if args.graph or args.graph_only:
        from . import graph_check

        findings, names = graph_check.check_registry(device=args.device)
        ran_sections["graph"] = findings
        new = baseline_mod.new_findings(findings, data, "graph")
        for f in new:
            print(f.render())
        n_base = len(findings) - len(new)
        print(f"graph ({args.device}): {len(new)} new finding(s), {n_base} baselined "
              f"across {len(names)} entry points ({', '.join(names)})")
        failed |= bool(new)

    if args.update_baseline:
        for section, findings in ran_sections.items():
            data = baseline_mod.update_section(data, section, findings)
        baseline_mod.save_baseline(data, baseline_path)
        print(f"baseline written: {baseline_path}")
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
