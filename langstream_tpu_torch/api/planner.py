"""Planner SPI: logical app → physical execution plan.

Parity: reference `api/runtime/` (ExecutionPlan.java:32-160, AgentNode,
ConnectionImplementation, ExecutionPlanOptimiser.java:22, ComputeClusterRuntime,
StreamingClusterRuntime). TPU-native addition: each AgentNode carries a
resolved ``TpuSpec`` so deployers can schedule device meshes (SURVEY §2.11).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.api.model import (
    Application,
    AssetDefinition,
    ErrorsSpec,
    ResourcesSpec,
    TopicDefinition,
)


@dataclass
class Connection:
    """Physical endpoint of an agent: a topic or an in-process link after fusion."""

    TOPIC = "topic"
    INTERNAL = "internal"

    kind: str
    topic: Optional[str] = None

    @staticmethod
    def to_topic(name: str) -> "Connection":
        return Connection(kind=Connection.TOPIC, topic=name)

    @staticmethod
    def internal() -> "Connection":
        return Connection(kind=Connection.INTERNAL)


@dataclass
class AgentNode:
    """Physical agent (reference DefaultAgentNode). After fusion one node may
    host several logical agents (composite), mirroring
    ComposableAgentExecutionPlanOptimiser.mergeAgents:76."""

    id: str
    agent_type: str
    component_type: str  # source|processor|sink|service
    module_id: str
    pipeline_id: str
    configuration: dict[str, Any] = field(default_factory=dict)
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec = field(default_factory=ErrorsSpec)
    input: Optional[Connection] = None
    output: Optional[Connection] = None
    composite: list["AgentNode"] = field(default_factory=list)
    disk: bool = False
    signals_from: Optional[str] = None

    @property
    def is_composite(self) -> bool:
        return bool(self.composite)

    def logical_agents(self) -> list["AgentNode"]:
        return self.composite if self.composite else [self]


@dataclass
class ExecutionPlan:
    """Physical plan (reference ExecutionPlan.java:32-160)."""

    application_id: str
    topics: dict[str, TopicDefinition] = field(default_factory=dict)
    agents: dict[str, AgentNode] = field(default_factory=dict)
    assets: list[AssetDefinition] = field(default_factory=list)
    application: Optional[Application] = None

    def register_topic(self, topic: TopicDefinition) -> TopicDefinition:
        existing = self.topics.get(topic.name)
        if existing is not None:
            return existing
        self.topics[topic.name] = topic
        return topic

    def add_agent(self, node: AgentNode) -> None:
        if node.id in self.agents:
            raise ValueError(f"duplicate physical agent id {node.id!r}")
        self.agents[node.id] = node

    def agent_sequence(self) -> list[AgentNode]:
        return list(self.agents.values())


class ExecutionPlanOptimiser(abc.ABC):
    """Reference ExecutionPlanOptimiser.java:22."""

    @abc.abstractmethod
    def can_merge(self, previous: AgentNode, agent: AgentNode) -> bool: ...

    @abc.abstractmethod
    def merge(self, previous: AgentNode, agent: AgentNode, plan: ExecutionPlan) -> AgentNode: ...


@dataclass
class AgentNodeMetadata:
    """Deployer-specific placement metadata (k8s namespace, TPU node pool…)."""

    data: dict[str, Any] = field(default_factory=dict)


class ComputeClusterRuntime(abc.ABC):
    """Builds and deploys execution plans (reference ComputeClusterRuntime)."""

    @abc.abstractmethod
    def build_execution_plan(
        self, application_id: str, application: Application
    ) -> ExecutionPlan: ...

    async def deploy(self, plan: ExecutionPlan) -> None:  # noqa: B027
        pass

    async def delete(self, plan: ExecutionPlan) -> None:  # noqa: B027
        pass


class StreamingClusterRuntime(abc.ABC):
    """Topic naming/creation policy side (reference StreamingClusterRuntime)."""

    def pick_topic_name(self, topic: TopicDefinition) -> str:
        return topic.name

    async def deploy_topics(self, plan: ExecutionPlan) -> None:  # noqa: B027
        pass

    async def delete_topics(self, plan: ExecutionPlan) -> None:  # noqa: B027
        pass
