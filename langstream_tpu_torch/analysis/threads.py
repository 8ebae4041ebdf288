"""LSA5xx — thread-shutdown hygiene.

The repo's worker threads (engine loop, token fetcher, spill/durable
workers, beacon refresher, SPMD receiver…) all follow one contract:
``daemon`` is set EXPLICITLY at construction (an implicit non-daemon
thread turns process exit into a hang; an implicit daemon thread hides
the decision), and a thread the owner keeps a handle to has a reachable
``join`` on the owner's close path (the spill-worker wedged-join arena
hazard in CHANGES.md is what happens when teardown hopes instead of
joining).

- LSA501  ``threading.Thread(...)`` constructed without an explicit
          ``daemon=`` keyword
- LSA502  a thread stored on ``self`` whose class never joins it, or a
          fire-and-forget local thread that is neither ``daemon=True``
          nor joined in the same function

One reading is wider than the JAX package's pass: an async close path
that hands the join to a worker thread, ``await
asyncio.to_thread(<thread>.join)``, counts as a join (the port's broker
fakes stop their server threads so, without blocking their event loop).
"""

from __future__ import annotations

import ast
from typing import Optional

from langstream_tpu_torch.analysis.core import (
    ANALYSIS_PREFIX,
    Finding,
    Repo,
    is_self_attr,
    parents,
)


def _is_thread_ctor(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return isinstance(f.value, ast.Name) and f.value.id.endswith(
            "threading"
        )
    return False


def _daemon_kwarg(node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "daemon":
            return kw.value
    return None


def _enclosing(node: ast.AST, kind) -> Optional[ast.AST]:
    for p in parents(node):
        if isinstance(p, kind):
            return p
    return None


def _joined_expr(node: ast.AST) -> Optional[ast.AST]:
    """The thread expression ``node`` joins, if it is a join: ``t.join(...)``
    or ``asyncio.to_thread(t.join, ...)`` (the join handed to a worker
    thread so an event loop keeps running) → ``t``."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "join":
        return f.value
    is_to_thread = (isinstance(f, ast.Attribute) and f.attr == "to_thread") or (
        isinstance(f, ast.Name) and f.id == "to_thread"
    )
    if is_to_thread and node.args:
        target = node.args[0]
        if isinstance(target, ast.Attribute) and target.attr == "join":
            return target.value
    return None


def _class_joins(cls: ast.ClassDef, attr: str) -> bool:
    """True if any method in ``cls`` joins ``self.<attr>`` — directly, or
    through a local alias (``t = self._thread; …; t.join(timeout=…)``,
    the shape every stop() in engine.py uses so the join target cannot
    be swapped out from under it mid-teardown)."""
    for fn in ast.walk(cls):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        aliases: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and is_self_attr(
                node.value, attr
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
        for node in ast.walk(fn):
            v = _joined_expr(node)
            if v is None:
                continue
            if is_self_attr(v, attr):
                return True
            if isinstance(v, ast.Name) and v.id in aliases:
                return True
    return False


def _fn_joins_name(fn: ast.AST, name: str) -> bool:
    for node in ast.walk(fn):
        v = _joined_expr(node)
        if isinstance(v, ast.Name) and v.id == name:
            return True
    return False


def check(repo: Repo) -> list[Finding]:
    findings: list[Finding] = []
    for pf in repo.files:
        if pf.rel.startswith(ANALYSIS_PREFIX):
            continue
        for node in ast.walk(pf.tree):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                continue
            daemon = _daemon_kwarg(node)
            if daemon is None:
                findings.append(
                    Finding(
                        code="LSA501",
                        path=pf.rel,
                        line=node.lineno,
                        message=(
                            "threading.Thread without an explicit "
                            "daemon= — say whether process exit may "
                            "abandon this thread"
                        ),
                    )
                )
            parent = getattr(node, "_lstpu_parent", None)
            # ownership: self._x = Thread(...)
            self_attr: Optional[str] = None
            local_name: Optional[str] = None
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    if is_self_attr(t):
                        self_attr = t.attr  # type: ignore[union-attr]
                    elif isinstance(t, ast.Name):
                        local_name = t.id
            if self_attr is not None:
                cls = _enclosing(node, ast.ClassDef)
                if cls is not None and not _class_joins(cls, self_attr):
                    findings.append(
                        Finding(
                            code="LSA502",
                            path=pf.rel,
                            line=node.lineno,
                            message=(
                                f"{cls.name}.{self_attr} is a thread "
                                "handle this class never joins — the "
                                "close path must join (or document why "
                                "leaking is safe with an inline "
                                "suppression)"
                            ),
                        )
                    )
            elif local_name is not None or isinstance(parent, ast.Attribute):
                fn = _enclosing(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                is_daemon_true = (
                    isinstance(daemon, ast.Constant) and daemon.value is True
                )
                joined = (
                    local_name is not None
                    and fn is not None
                    and _fn_joins_name(fn, local_name)
                )
                if not is_daemon_true and not joined:
                    findings.append(
                        Finding(
                            code="LSA502",
                            path=pf.rel,
                            line=node.lineno,
                            message=(
                                "non-daemon thread with no reachable "
                                "join in this scope — process exit will "
                                "hang on it"
                            ),
                        )
                    )
    return findings
