"""The resource-type registry — the part of ``langstream_tpu/core/
registry.py`` the provider and the datasource need: a process-wide map of
``configuration.resources`` ``type:`` strings to a factory (an AI service
provider, a datasource client) and the type's config schema. The port's
built-in types register on first lookup: ``tpu-serving``
(``ai.register_providers``) and the ``datasource`` / ``vector-database``
types served by the local vector store (``agents.vector``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from langstream_tpu_torch.api.doc import ConfigModel


@dataclass
class ResourceTypeInfo:
    type: str
    config_model: Optional[ConfigModel] = None
    description: str = ""
    # the runtime factory (an AI service provider, a datasource client)
    factory: Optional[Callable[[dict[str, Any]], Any]] = None


@dataclass
class _Registry:
    resources: dict[str, ResourceTypeInfo] = field(default_factory=dict)
    _builtins_loaded: bool = False

    def register_resource(self, info: ResourceTypeInfo) -> None:
        self.resources[info.type] = info

    def resource(self, type_: str) -> Optional[ResourceTypeInfo]:
        self._ensure_builtins()
        return self.resources.get(type_)

    def _ensure_builtins(self) -> None:
        if not self._builtins_loaded:
            self._builtins_loaded = True
            from langstream_tpu_torch.agents import vector
            from langstream_tpu_torch.ai import register_providers

            register_providers()
            vector.register()


REGISTRY = _Registry()
