"""Placeholder resolution: ``${secrets.x.y}`` / ``${globals.*}`` templating.

Parity: reference `impl/common/ApplicationPlaceholderResolver.java:59,279-300`.
Resolves over the whole application model; a value that is exactly one
placeholder keeps its native type (numbers/dicts survive), otherwise values are
interpolated as strings. ``\\${...}`` escapes to a literal ``${...}``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from langstream_tpu_torch.api.model import Application

_PLACEHOLDER = re.compile(r"(?<!\\)\$\{\s*([a-zA-Z0-9_.\- ]+?)\s*\}")
_ESCAPED = re.compile(r"\\(\$\{[^}]*\})")


class PlaceholderError(ValueError):
    pass


def _lookup(context: dict[str, Any], path: str) -> Any:
    cur: Any = context
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise PlaceholderError(f"unresolved placeholder '${{{path}}}'")
    return cur


def resolve_string(value: str, context: dict[str, Any]) -> Any:
    m = _PLACEHOLDER.fullmatch(value.strip())
    if m:
        return _lookup(context, m.group(1))

    def sub(match: re.Match) -> str:
        v = _lookup(context, match.group(1))
        return "" if v is None else str(v)

    out = _PLACEHOLDER.sub(sub, value)
    return _ESCAPED.sub(r"\1", out)


def resolve_value(value: Any, context: dict[str, Any]) -> Any:
    if isinstance(value, str):
        return resolve_string(value, context)
    if isinstance(value, dict):
        return {k: resolve_value(v, context) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(resolve_value(v, context) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        changes = {
            f.name: resolve_value(getattr(value, f.name), context)
            for f in dataclasses.fields(value)
        }
        return dataclasses.replace(value, **changes)
    return value


def build_context(application: Application, env: dict[str, str] | None = None) -> dict[str, Any]:
    secrets_ctx = {sid: dict(s.data) for sid, s in application.secrets.secrets.items()}
    return {
        "secrets": secrets_ctx,
        "globals": dict(application.instance.globals_),
        "env": dict(env or {}),
        "cluster": {
            "streaming": {"type": application.instance.streaming_cluster.type},
            "compute": {"type": application.instance.compute_cluster.type},
        },
    }


def resolve_placeholders(application: Application, env: dict[str, str] | None = None) -> Application:
    """Return a new Application with all ``${...}`` placeholders substituted.

    Secrets themselves and the instance globals are left verbatim (they are the
    sources of truth), mirroring the reference's exclusion list.
    """
    import dataclasses

    context = build_context(application, env)
    # dataclasses.replace: fields NOT resolved here (code_directory, any
    # future addition) carry over automatically instead of silently
    # dropping — rebuilding field-by-field is what once lost code_directory
    # and broke python-agent subprocess imports
    return dataclasses.replace(
        application,
        modules={
            mid: resolve_value(mod, context) for mid, mod in application.modules.items()
        },
        resources={
            rid: resolve_value(r, context) for rid, r in application.resources.items()
        },
        assets=[resolve_value(a, context) for a in application.assets],
        gateways=[resolve_value(g, context) for g in application.gateways],
    )
