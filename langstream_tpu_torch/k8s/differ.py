"""Semantic spec diffing (the port's own copy of
``langstream_tpu/k8s/differ.py``; reference SpecDiffer /
JSONAssertComparator): decide whether a generated manifest differs from the
stored one, ignoring server-managed metadata — the guard that avoids
needless pod restarts (reference AgentController "last-applied diffing")."""

from __future__ import annotations

import copy
from typing import Any

_SERVER_MANAGED_METADATA = ("resourceVersion", "generation", "creationTimestamp", "uid")


def _normalized(manifest: dict[str, Any]) -> dict[str, Any]:
    out = copy.deepcopy(manifest)
    meta = out.get("metadata", {})
    for key in _SERVER_MANAGED_METADATA:
        meta.pop(key, None)
    out.pop("status", None)
    return out


def specs_equal(a: dict[str, Any], b: dict[str, Any]) -> bool:
    return _normalized(a) == _normalized(b)


def diff_paths(a: dict[str, Any], b: dict[str, Any], prefix: str = "") -> list[str]:
    """Human-readable list of differing paths (for operator logs/tests)."""
    a, b = _normalized(a), _normalized(b)

    def walk(x: Any, y: Any, path: str, out: list[str]) -> None:
        if isinstance(x, dict) and isinstance(y, dict):
            for key in sorted(set(x) | set(y)):
                walk(x.get(key), y.get(key), f"{path}.{key}" if path else key, out)
        elif isinstance(x, list) and isinstance(y, list):
            if len(x) != len(y):
                out.append(f"{path} (length {len(x)} != {len(y)})")
            else:
                for i, (xi, yi) in enumerate(zip(x, y)):
                    walk(xi, yi, f"{path}[{i}]", out)
        elif x != y:
            out.append(path)

    result: list[str] = []
    walk(a, b, prefix, result)
    return result
