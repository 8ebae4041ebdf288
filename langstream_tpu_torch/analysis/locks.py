"""LSA1xx — lock discipline via the ``_GUARDED`` class registry.

The convention (docs/ANALYSIS.md): a class whose counters/state are
mutated from more than one thread declares, at class level,

    _GUARDED = {
        "_stats_lock": ("shed_total", "cancelled_total", ...),
    }

mapping each lock attribute to the attributes it guards. A MODULE whose
globals cross threads (serving/lifecycle.py) declares the same registry
at module level, mapping a module-global lock to the globals it guards.
This checker then flags every write to a registered attribute that is
not lexically inside a ``with self.<lock>:`` (or module-level
``with <lock>:``) block for the matching lock:

- LSA101  guarded attribute written outside its lock's ``with`` scope
          (direct assignment, ``+=``, item-store/delete on the guarded
          container). Writes in ``__init__``/``__new__`` are exempt
          (no second thread exists yet), as are methods whose name ends
          with ``_locked`` (the documented called-with-lock-held
          convention, e.g. ``Engine._stats_locked``).
- LSA102  malformed registry: a ``_GUARDED`` lock never created in the
          class, a non-literal registry, or an attribute guarded twice.

A write inside a nested function defined in a method is checked with an
EMPTY held-set even when the enclosing statement holds the lock: the
closure may run after the ``with`` exits (this is exactly the
finish-waker teardown-race shape CHANGES.md records). Suppress with
``# lstpu: ignore[LSA101]`` where the closure provably runs inline.
"""

from __future__ import annotations

import ast
from typing import Optional

from langstream_tpu_torch.analysis.core import (
    Finding,
    ParsedFile,
    Repo,
    is_self_attr,
    literal_str,
)

EXEMPT_METHODS = ("__init__", "__new__")
LOCKED_SUFFIX = "_locked"


def _parse_guarded(scope) -> Optional[tuple[ast.AST, dict]]:
    """The ``_GUARDED`` assignment in ``scope.body`` (a ClassDef or a
    Module), if any: returns the assignment node and
    {lock_name: [attr, ...]} — or an empty dict when the literal is
    malformed."""
    for stmt in scope.body:
        target = None
        value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            target, value = stmt.target, stmt.value
        if not (isinstance(target, ast.Name) and target.id == "_GUARDED"):
            continue
        if not isinstance(value, ast.Dict):
            return stmt, {}
        out: dict = {}
        for k, v in zip(value.keys, value.values):
            lock = literal_str(k) if k is not None else None
            if lock is None:
                return stmt, {}
            attrs = []
            if isinstance(v, (ast.Tuple, ast.List)):
                for el in v.elts:
                    s = literal_str(el)
                    if s is None:
                        return stmt, {}
                    attrs.append(s)
            else:
                return stmt, {}
            out[lock] = attrs
        return stmt, out
    return None


def _class_assigns_attr(cls: ast.ClassDef, attr: str) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if is_self_attr(t, attr):
                    return True
    return False


def _with_locks(stmt: ast.With, module_mode: bool = False) -> set[str]:
    held = set()
    for item in stmt.items:
        expr = item.context_expr
        if is_self_attr(expr):
            held.add(expr.attr)  # type: ignore[union-attr]
        elif module_mode and isinstance(expr, ast.Name):
            held.add(expr.id)
    return held


class _MethodChecker:
    def __init__(
        self,
        pf: ParsedFile,
        cls_name: str,
        guard_of: dict[str, str],
        module_mode: bool = False,
    ) -> None:
        self.pf = pf
        self.cls_name = cls_name
        self.guard_of = guard_of  # attr -> lock
        self.module_mode = module_mode
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, attr: str, nested: bool) -> None:
        lock = self.guard_of[attr]
        ref = lock if self.module_mode else f"self.{lock}"
        why = (
            "from a nested function (the closure may outlive the lock)"
            if nested
            else f"outside `with {ref}:`"
        )
        self.findings.append(
            Finding(
                code="LSA101",
                path=self.pf.rel,
                line=node.lineno,
                message=(
                    f"{self.cls_name}.{attr} is guarded by "
                    f"{ref} but is written {why}"
                ),
            )
        )

    def _match(self, target: ast.AST) -> Optional[str]:
        """The guarded attribute a bare write target refers to, if any."""
        if self.module_mode:
            if isinstance(target, ast.Name):
                return target.id
            return None
        if is_self_attr(target):
            return target.attr  # type: ignore[union-attr]
        return None

    def _check_write_target(
        self, target: ast.AST, held: set[str], nested: bool, node: ast.AST
    ) -> None:
        # self.attr = / +=   (module mode: NAME = / +=)
        attr = self._match(target)
        if attr is None and isinstance(target, ast.Subscript):
            # self.attr[k] = / del self.attr[k]
            attr = self._match(target.value)
        if attr is not None:
            if attr in self.guard_of and self.guard_of[attr] not in held:
                self._flag(node, attr, nested)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._check_write_target(el, held, nested, node)

    def walk(
        self, stmts: list[ast.stmt], held: set[str], nested: bool
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    self._check_write_target(t, held, nested, stmt)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                self._check_write_target(stmt.target, held, nested, stmt)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    self._check_write_target(t, held, nested, stmt)

            if isinstance(stmt, ast.With):
                self.walk(
                    stmt.body,
                    held | _with_locks(stmt, self.module_mode),
                    nested,
                )
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closures start from an empty held-set: they may run
                # after the enclosing `with` released the lock
                self.walk(stmt.body, set(), True)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self.walk(stmt.body, held, nested)
                self.walk(stmt.orelse, held, nested)
            elif isinstance(stmt, ast.If):
                self.walk(stmt.body, held, nested)
                self.walk(stmt.orelse, held, nested)
            elif isinstance(stmt, ast.Try):
                self.walk(stmt.body, held, nested)
                for h in stmt.handlers:
                    self.walk(h.body, held, nested)
                self.walk(stmt.orelse, held, nested)
                self.walk(stmt.finalbody, held, nested)
            elif isinstance(stmt, ast.ClassDef):
                self.walk(stmt.body, set(), nested)


def _module_assigns_name(tree: ast.Module, name: str) -> bool:
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in stmt.targets
        ):
            return True
        if isinstance(stmt, ast.AnnAssign) and (
            isinstance(stmt.target, ast.Name) and stmt.target.id == name
        ):
            return True
    return False


def _check_module_registry(pf: ParsedFile, findings: list[Finding]) -> None:
    parsed = _parse_guarded(pf.tree)
    if parsed is None:
        return
    reg_node, registry = parsed
    if not registry:
        findings.append(
            Finding(
                code="LSA102",
                path=pf.rel,
                line=reg_node.lineno,
                message=(
                    "module-level _GUARDED must be a literal dict of "
                    "lock name -> tuple of global names"
                ),
            )
        )
        return
    guard_of: dict[str, str] = {}
    for lock, attrs in registry.items():
        if not _module_assigns_name(pf.tree, lock):
            findings.append(
                Finding(
                    code="LSA102",
                    path=pf.rel,
                    line=reg_node.lineno,
                    message=(
                        f"module _GUARDED names lock {lock!r} but the "
                        "module never creates it"
                    ),
                )
            )
            return
        for attr in attrs:
            if attr in guard_of:
                findings.append(
                    Finding(
                        code="LSA102",
                        path=pf.rel,
                        line=reg_node.lineno,
                        message=(
                            f"module _GUARDED lists {attr!r} under two "
                            "locks"
                        ),
                    )
                )
                return
            guard_of[attr] = lock
    mod_name = pf.rel.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    for stmt in pf.tree.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in EXEMPT_METHODS or stmt.name.endswith(LOCKED_SUFFIX):
            continue
        mc = _MethodChecker(pf, mod_name, guard_of, module_mode=True)
        mc.walk(stmt.body, set(), False)
        findings.extend(mc.findings)


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    for pf in repo.files:
        _check_module_registry(pf, findings)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            parsed = _parse_guarded(node)
            if parsed is None:
                continue
            reg_node, registry = parsed
            if not registry:
                findings.append(
                    Finding(
                        code="LSA102",
                        path=pf.rel,
                        line=reg_node.lineno,
                        message=(
                            f"{node.name}._GUARDED must be a literal "
                            "dict of lock name -> tuple of attribute "
                            "names"
                        ),
                    )
                )
                continue
            guard_of: dict[str, str] = {}
            ok = True
            for lock, attrs in registry.items():
                if not _class_assigns_attr(node, lock):
                    findings.append(
                        Finding(
                            code="LSA102",
                            path=pf.rel,
                            line=reg_node.lineno,
                            message=(
                                f"{node.name}._GUARDED names lock "
                                f"self.{lock!s} but the class never "
                                "creates it"
                            ),
                        )
                    )
                    ok = False
                for attr in attrs:
                    if attr in guard_of:
                        findings.append(
                            Finding(
                                code="LSA102",
                                path=pf.rel,
                                line=reg_node.lineno,
                                message=(
                                    f"{node.name}._GUARDED lists "
                                    f"{attr!r} under two locks"
                                ),
                            )
                        )
                        ok = False
                    guard_of[attr] = lock
            if not ok:
                continue
            for stmt in node.body:
                if not isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if stmt.name in EXEMPT_METHODS or stmt.name.endswith(
                    LOCKED_SUFFIX
                ):
                    continue
                mc = _MethodChecker(pf, node.name, guard_of)
                mc.walk(stmt.body, set(), False)
                findings.extend(mc.findings)
    return findings
