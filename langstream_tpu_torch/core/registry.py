"""Agent, resource and asset type registries (the port's own copy of
``langstream_tpu/core/registry.py``): one process-wide map of YAML
``type:`` strings to

  - for an agent: its component type (source / processor / sink /
    service) for planning, the factory of its runtime ``AgentCode``, its
    config schema, and ``composable`` (adjacent composable agents are
    fused into one processor by the planner);
  - for a ``configuration.resources`` entry: a factory (an AI service
    provider, a datasource client) and its config schema;
  - for an asset: the factory of its manager (the deployer skips an
    asset whose type has none, as JAX's does).

The port's built-in types register on first lookup: the agents of
``agents/`` (identity, list-source, collect-sink, the text agents, the
GenAI steps, ``webcrawler-source``, the RAG agents, the flow, HTTP and
object-storage agents), the AI resource types (``ai.register_providers``:
``tpu-serving``, the remote providers and the mock), the ``datasource`` /
``vector-database`` types with every service JAX resolves, and the asset
types (``agents.vector``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from langstream_tpu_torch.api.agent import AgentCode, ComponentType
from langstream_tpu_torch.api.doc import ConfigModel


@dataclass
class AgentTypeInfo:
    type: str
    component_type: ComponentType
    factory: Callable[[], AgentCode]
    config_model: Optional[ConfigModel] = None
    composable: bool = False
    description: str = ""
    aliases: tuple[str, ...] = ()


@dataclass
class ResourceTypeInfo:
    type: str
    config_model: Optional[ConfigModel] = None
    description: str = ""
    # the runtime factory (an AI service provider, a datasource client)
    factory: Optional[Callable[[dict[str, Any]], Any]] = None


@dataclass
class AssetTypeInfo:
    type: str
    factory: Callable[[], Any]
    config_model: Optional[ConfigModel] = None
    description: str = ""


class UnknownAgentType(ValueError):
    pass


@dataclass
class _Registry:
    agents: dict[str, AgentTypeInfo] = field(default_factory=dict)
    resources: dict[str, ResourceTypeInfo] = field(default_factory=dict)
    assets: dict[str, AssetTypeInfo] = field(default_factory=dict)
    _builtins_loaded: bool = False

    def register_agent(self, info: AgentTypeInfo) -> None:
        self.agents[info.type] = info
        for a in info.aliases:
            self.agents[a] = info

    def register_resource(self, info: ResourceTypeInfo) -> None:
        self.resources[info.type] = info

    def register_asset(self, info: AssetTypeInfo) -> None:
        self.assets[info.type] = info

    def agent(self, type_: str) -> AgentTypeInfo:
        self._ensure_builtins()
        info = self.agents.get(type_)
        if info is None:
            known = ", ".join(sorted(self.agents))
            raise UnknownAgentType(f"unknown agent type {type_!r}; known: {known}")
        return info

    def resource(self, type_: str) -> Optional[ResourceTypeInfo]:
        self._ensure_builtins()
        return self.resources.get(type_)

    def asset(self, type_: str) -> Optional[AssetTypeInfo]:
        self._ensure_builtins()
        return self.assets.get(type_)

    def has_agent(self, type_: str) -> bool:
        self._ensure_builtins()
        return type_ in self.agents

    def _ensure_builtins(self) -> None:
        if not self._builtins_loaded:
            self._builtins_loaded = True
            from langstream_tpu_torch.agents import register_builtins

            register_builtins()


REGISTRY = _Registry()
