"""AST lint engine: file walking, suppression handling, findings (the torch
counterpart of ``repro/analysis/astlint.py``).

Runs the :mod:`repro_torch.analysis.rules` pack over Python sources. Rule
scoping is by *package-relative* path (``repro_torch/linalg/blas3.py``) so
the same engine lints the real tree (paths under ``src/repro_torch/``) and
test sources (which pass an explicit ``relpath``).

Suppressions are inline comments of the form

    # reprolint: disable=RPL002(order-independent: assembly by block index)

scoped to their line. The reason string is mandatory: ``disable=RPL002``
without one does not suppress anything and is itself reported as RPL000 —
a suppression is a claim, and the claim must be written down.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from .rules import RULES

#: ``disable=RPL001(reason)`` — reason must be non-empty to suppress.
_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*disable=(?P<code>RPL\d{3})"
    r"(?:\((?P<reason>[^)]*)\))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    relpath: str
    line: int
    col: int
    message: str
    fix_hint: str

    @property
    def key(self) -> str:
        """Stable identity used by the baseline (line-anchored; refresh the
        baseline when in-scope code moves)."""
        return f"{self.code}:{self.relpath}:{self.line}"

    def render(self) -> str:
        return (f"{self.relpath}:{self.line}:{self.col}: {self.code} "
                f"{self.message}\n    fix: {self.fix_hint}")


@dataclasses.dataclass(frozen=True)
class Suppression:
    code: str
    line: int
    reason: str | None


def _parse_suppressions(source: str) -> list[Suppression]:
    out = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        for m in _SUPPRESS_RE.finditer(text):
            reason = m.group("reason")
            reason = reason.strip() if reason is not None else None
            out.append(Suppression(m.group("code"), lineno, reason or None))
    return out


def package_relpath(path: str | Path) -> str:
    """Map a filesystem path to the rule-scoping path (``repro_torch/...``).

    Looks for the ``repro_torch`` package root (``src/repro_torch/`` or a
    leading ``repro_torch/`` component); files outside it keep their path
    as-is, which matches no package-scoped rule.
    """
    parts = Path(path).as_posix().split("/")
    for i, part in enumerate(parts[:-1]):
        if part == "repro_torch" and (i == 0 or parts[i - 1] == "src"):
            return "/".join(parts[i:])
    return Path(path).as_posix()


def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one file's source under rule-scoping path ``relpath``."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("RPL000", relpath, e.lineno or 1, 0,
                        f"file does not parse: {e.msg}",
                        RULES["RPL000"].fix_hint)]
    raw: list[Finding] = []
    for rule in RULES.values():
        for node, message in rule.check(tree, relpath):
            raw.append(Finding(rule.code, relpath,
                               getattr(node, "lineno", 1),
                               getattr(node, "col_offset", 0),
                               message, rule.fix_hint))

    suppressions = _parse_suppressions(source)
    valid = {(s.code, s.line) for s in suppressions if s.reason}
    findings = [f for f in raw if (f.code, f.line) not in valid]
    for s in suppressions:
        if s.reason is None:
            findings.append(Finding(
                "RPL000", relpath, s.line, 0,
                f"suppression of {s.code} carries no reason — a bare "
                "disable suppresses nothing", RULES["RPL000"].fix_hint))
        elif s.code not in RULES:
            findings.append(Finding(
                "RPL000", relpath, s.line, 0,
                f"suppression names unknown rule {s.code}",
                RULES["RPL000"].fix_hint))
    findings.sort(key=lambda f: (f.relpath, f.line, f.col, f.code))
    return findings


def lint_file(path: str | Path, relpath: str | None = None) -> list[Finding]:
    source = Path(path).read_text()
    return lint_source(source, relpath or package_relpath(path))


def iter_python_files(paths: Iterable[str | Path]):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Iterable[str | Path]) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_file(f))
    return findings
