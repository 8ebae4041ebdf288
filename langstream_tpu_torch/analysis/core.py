"""Shared frame for the port's lstpu-check passes: file discovery under
``langstream_tpu_torch/``, parsed files with parent-annotated ASTs,
suppression comments, the port's own baseline, and the runner the CLI and
the tier-1 test drive.

Suppression syntax (docs/ANALYSIS.md):

    x = 1  # lstpu: ignore[LSA101]
    # lstpu: ignore[LSA101, LSA502] — applies to the NEXT line too

A suppression names the exact code(s) it silences; a bare ``lstpu:
ignore`` without codes silences nothing (an unscoped waiver is how
invariants rot). The port's baseline is a file of its own,
``langstream_tpu_torch/analysis/baseline.json`` (the root
``.lstpu-baseline.json`` is the JAX package's), and grandfathers findings
by ``path::code`` count. It ships EMPTY: the mechanism exists so a future
emergency revert does not have to fight the linter.

The passes scan ``langstream_tpu_torch/`` only, never ``langstream_tpu/``;
the coverage evidence of the registry-drift pass is the port's tests,
``tests/test_torch_*.py``, only (a JAX test naming a fault site does not
cover the port's).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

#: repo-relative directory the passes scan (tests are read only by the
#: registry-drift pass, as evidence — never linted themselves)
SOURCE_ROOT = "langstream_tpu_torch"
#: this package's own files, which no pass lints
ANALYSIS_PREFIX = SOURCE_ROOT + "/analysis/"
#: repo-relative path of the port's baseline
BASELINE_FILE = SOURCE_ROOT + "/analysis/baseline.json"

_SUPPRESS_RE = re.compile(r"#\s*lstpu:\s*ignore\[([A-Z0-9,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    """One checker hit: a stable code, a repo-relative path, a 1-based
    line, and the human sentence. Sorting groups by file then line so
    the CLI output reads like a compiler's."""

    code: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    @property
    def key(self) -> str:
        return f"{self.path}::{self.code}"


class _ParentVisitor(ast.NodeVisitor):
    def generic_visit(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            child._lstpu_parent = node  # type: ignore[attr-defined]
        super().generic_visit(node)


def parents(node: ast.AST) -> Iterable[ast.AST]:
    """Walk ancestors root-ward (requires a ParsedFile tree)."""
    cur = getattr(node, "_lstpu_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lstpu_parent", None)


@dataclass
class ParsedFile:
    """One source file: text, lines, a parent-annotated AST, and the
    per-line suppression map."""

    path: str  # absolute
    rel: str  # repo-relative, '/' separators
    source: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)
    suppressed: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, rel: str) -> "ParsedFile":
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=rel)
        _ParentVisitor().visit(tree)
        lines = source.splitlines()
        suppressed: dict[int, set[str]] = {}
        for i, text in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            # a suppression covers its own line and, when the line is
            # the comment alone, the line below it
            suppressed.setdefault(i, set()).update(codes)
            if text.lstrip().startswith("#"):
                suppressed.setdefault(i + 1, set()).update(codes)
        return cls(
            path=path, rel=rel, source=source, tree=tree,
            lines=lines, suppressed=suppressed,
        )

    def is_suppressed(self, code: str, line: int) -> bool:
        return code in self.suppressed.get(line, ())


@dataclass
class Repo:
    """The parsed tree every checker receives. ``files`` carries the
    scanned source; ``root`` lets cross-artifact passes (registry drift)
    read tests, docs and dashboards as evidence."""

    root: str
    files: list[ParsedFile]

    _by_rel: Optional[dict[str, ParsedFile]] = None

    @classmethod
    def load(
        cls, root: str, subdirs: tuple[str, ...] = (SOURCE_ROOT,),
        exclude: tuple[str, ...] = ("__pycache__",),
    ) -> "Repo":
        files: list[ParsedFile] = []
        errors: list[str] = []
        for sub in subdirs:
            base = os.path.join(root, sub)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in exclude
                )
                for name in sorted(filenames):
                    if not name.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, name)
                    rel = os.path.relpath(path, root).replace(os.sep, "/")
                    try:
                        files.append(ParsedFile.parse(path, rel))
                    except SyntaxError as e:
                        errors.append(f"{rel}: unparseable ({e})")
        if errors:
            raise RuntimeError(
                "analysis cannot parse the tree:\n" + "\n".join(errors)
            )
        return cls(root=root, files=files)

    def get(self, rel: str) -> Optional[ParsedFile]:
        if self._by_rel is None:
            self._by_rel = {f.rel: f for f in self.files}
        return self._by_rel.get(rel)


# ---------------------------------------------------------------------------
# Small AST helpers shared by the passes
# ---------------------------------------------------------------------------


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    """``self.<attr>`` (any attr when ``attr`` is None)."""
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and (attr is None or node.attr == attr)
    )


def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def dict_literal_str_keys(node: ast.Dict) -> list[tuple[str, int]]:
    """The string keys of a dict literal with their lines (``**spread``
    entries have no key and are skipped — the taint pass follows the
    spread's source separately when it can)."""
    out: list[tuple[str, int]] = []
    for key in node.keys:
        s = literal_str(key) if key is not None else None
        if s is not None:
            out.append((s, key.lineno))
    return out


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


def call_name(call: ast.Call) -> str:
    """Trailing name of the called expression: ``a.b.dump`` → ``dump``,
    ``emit_request_spans`` → itself."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

CheckerFn = Callable[[Repo], list[Finding]]


def all_checkers() -> dict[str, CheckerFn]:
    # imported here so `import langstream_tpu_torch.analysis.core` stays cheap
    # and cycle-free for the passes themselves
    from langstream_tpu_torch.analysis import (
        compile_surface,
        locks,
        redaction,
        registry_drift,
        threads,
    )

    return {
        "locks": locks.check,
        "redaction": redaction.check,
        "compile-surface": compile_surface.check,
        "registry-drift": registry_drift.check,
        "threads": threads.check,
    }


def load_baseline(root: str) -> dict[str, int]:
    path = os.path.join(root, BASELINE_FILE)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise RuntimeError(f"{BASELINE_FILE} must be a JSON object")
    return {str(k): int(v) for k, v in doc.items()}


def apply_suppressions(
    repo: Repo, findings: list[Finding]
) -> list[Finding]:
    out = []
    for f in findings:
        pf = repo.get(f.path)
        if pf is not None and pf.is_suppressed(f.code, f.line):
            continue
        out.append(f)
    return out


def apply_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], dict[str, int]]:
    """Drop up to ``baseline[path::code]`` findings per key; return the
    survivors plus the STALE baseline entries (keys whose budget the
    tree no longer uses — strict mode fails on them so the baseline only
    ever shrinks)."""
    used: dict[str, int] = {}
    survivors: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        budget = baseline.get(f.key, 0)
        if used.get(f.key, 0) < budget:
            used[f.key] = used.get(f.key, 0) + 1
            continue
        survivors.append(f)
    stale = {
        k: v - used.get(k, 0)
        for k, v in baseline.items()
        if used.get(k, 0) < v
    }
    return survivors, stale


def checker_name(name: str) -> str:
    """A pass name as the registry spells it: ``compile_surface`` and
    ``compile-surface`` name the same pass."""
    return name.replace("_", "-")


def run_checks(
    root: str,
    only: Optional[Iterable[str]] = None,
    repo: Optional[Repo] = None,
) -> tuple[Repo, list[Finding]]:
    """Parse the tree and run the selected passes. Returns suppression-
    filtered findings, sorted; baseline handling is the caller's (the
    CLI applies it, the whole-repo-clean test wants raw findings)."""
    repo = repo or Repo.load(root)
    checkers = all_checkers()
    names = [checker_name(n) for n in only] if only else list(checkers)
    unknown = [n for n in names if n not in checkers]
    if unknown:
        raise RuntimeError(
            f"unknown checker(s) {', '.join(unknown)}; "
            f"known: {', '.join(checkers)}"
        )
    findings: list[Finding] = []
    for name in names:
        findings.extend(checkers[name](repo))
    findings = apply_suppressions(repo, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return repo, findings


def repo_root_from_here() -> str:
    """The repo root, derived from this file's location (three levels up
    from ``langstream_tpu_torch/analysis/core.py``)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def summarize(findings: list[Finding]) -> dict[str, Any]:
    by_code: dict[str, int] = {}
    for f in findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    return {"total": len(findings), "by_code": by_code}
