"""Minimal Helm-template renderer for the chart's own templates (the
port's own copy of ``langstream_tpu/k8s/helm_render.py``).

The reference proves its deployer output with YAML-assert tests on the
generated manifests and installs the real chart on k3s in its top e2e tier
(BaseEndToEndTest.java:92). Neither helm nor a cluster exists here, so this
module implements exactly the Go-template subset the `helm/langstream-tpu`
chart uses — `.Release.*`, `.Values.*` lookups, `| quote`, and non-nested
`{{- if }} … {{- end }}` blocks — so the chart renders to real YAML in tests
and the rendered manifests can boot the platform roles as subprocesses. It
is NOT a general Helm implementation: any other construct raises (an
unrendered `{{`, or a pipe into another function than `quote`). The YAML is read with the port's reader
(``core/yaml_reader.py``), one document at a time: a rendered file is split
on its `---` lines, since the reader refuses a second document.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from langstream_tpu_torch.core.yaml_reader import safe_load


def _lookup(context: dict[str, Any], dotted: str) -> Any:
    node: Any = context
    for part in dotted.strip().lstrip(".").split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _truthy(v: Any) -> bool:
    return bool(v) and v != "" and v != {}


def render_template(
    text: str, values: dict[str, Any], release: dict[str, Any]
) -> str:
    context = {"Values": values, "Release": release}

    # {{- if .X }} body {{- end }} (non-nested; `-` chomps preceding space)
    def replace_if(m: re.Match) -> str:
        return m.group(2) if _truthy(_lookup(context, m.group(1))) else ""

    text = re.sub(
        r"\{\{-?\s*if\s+([^}]+?)\s*-?\}\}(.*?)\{\{-?\s*end\s*-?\}\}",
        replace_if,
        text,
        flags=re.S,
    )

    # {{ .a.b.c }} / {{ .a.b | quote }}
    def replace_expr(m: re.Match) -> str:
        dotted, pipe = m.group(1), m.group(2)
        value = _lookup(context, dotted)
        value = "" if value is None else value
        if pipe is None:
            return str(value)
        # `quote` is the one function the subset has (the JAX renderer
        # drops any other pipe silently)
        if pipe.strip("| \t") != "quote":
            raise ValueError(f"unsupported template function: {m.group(0)!r}")
        return '"%s"' % str(value).replace('"', '\\"')

    text = re.sub(
        r"\{\{-?\s*(\.[\w.]+)\s*(\|\s*\w+\s*)?-?\}\}", replace_expr, text
    )
    # chomp whitespace-only lines left by removed blocks
    text = "\n".join(
        line for line in text.splitlines() if line.strip() or line == ""
    )
    if "{{" in text:
        snippet = text[text.index("{{") : text.index("{{") + 60]
        raise ValueError(f"unrendered template construct: {snippet!r}")
    return text


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _documents(text: str) -> list[str]:
    """A multi-document stream split on its ``---`` separator lines."""
    docs, lines = [], []
    for line in text.splitlines():
        if re.match(r"^---\s*(#.*)?$", line):
            docs.append("\n".join(lines))
            lines = []
        else:
            lines.append(line)
    docs.append("\n".join(lines))
    return docs


def render_chart(
    chart_dir: str | Path,
    release_name: str = "ls",
    namespace: str = "default",
    value_overrides: dict[str, Any] | None = None,
    include_crds: bool = True,
) -> list[dict[str, Any]]:
    """Render every template (and optionally crds/) of a chart directory to
    parsed manifest dicts — the `helm template` equivalent for tests."""
    chart_dir = Path(chart_dir)
    values = safe_load((chart_dir / "values.yaml").read_text()) or {}
    if value_overrides:
        values = _deep_merge(values, value_overrides)
    release = {"Name": release_name, "Namespace": namespace}
    docs: list[dict[str, Any]] = []
    sources: list[Path] = sorted((chart_dir / "templates").glob("*.yaml"))
    if include_crds and (chart_dir / "crds").is_dir():
        sources = sorted((chart_dir / "crds").glob("*.yaml")) + sources
    for path in sources:
        rendered = render_template(path.read_text(), values, release)
        for text in _documents(rendered):
            doc = safe_load(text)
            if doc:
                docs.append(doc)
    return docs
