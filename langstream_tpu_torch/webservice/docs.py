"""Configuration documentation generator (the port's own copy of
``langstream_tpu/webservice/docs.py``, over the port's registry).

Parity: reference ``DocumentationGeneratorStarter`` — dumps every registered
agent / resource / asset configuration model to JSON (the docs-site input and
the machine-readable API catalog). Served at ``GET /api/docs`` and via
``langstream-tpu docs``.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty


def _property_doc(p: ConfigProperty) -> dict[str, Any]:
    out: dict[str, Any] = {"description": p.description, "type": p.type}
    if p.required:
        out["required"] = True
    if p.default is not None:
        out["default"] = p.default
    return out


def _model_doc(model: ConfigModel | None, description: str) -> dict[str, Any]:
    out: dict[str, Any] = {"description": description}
    if model is not None:
        out["properties"] = {
            name: _property_doc(p) for name, p in sorted(model.properties.items())
        }
        if model.allow_unknown:
            out["allow-unknown-fields"] = True
    return out


def generate_documentation_model() -> dict[str, Any]:
    from langstream_tpu_torch.core.registry import REGISTRY

    REGISTRY._ensure_builtins()
    agents = {}
    seen = set()
    for type_, info in sorted(REGISTRY.agents.items()):
        if id(info) in seen and type_ != info.type:
            continue  # aliases fold into the canonical entry
        seen.add(id(info))
        doc = _model_doc(info.config_model, info.description)
        doc["component-type"] = info.component_type.value
        if info.aliases:
            doc["aliases"] = list(info.aliases)
        agents[info.type] = doc
    resources = {
        type_: _model_doc(info.config_model, info.description)
        for type_, info in sorted(REGISTRY.resources.items())
    }
    assets = {
        type_: _model_doc(info.config_model, info.description)
        for type_, info in sorted(REGISTRY.assets.items())
    }
    return {"agents": agents, "resources": resources, "assets": assets}
