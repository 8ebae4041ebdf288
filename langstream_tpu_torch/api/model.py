"""Typed application model: modules → pipelines → agents, topics, gateways.

Parity: reference `langstream-api/src/main/java/ai/langstream/api/model/`
(Application.java, Module.java, Pipeline.java, AgentConfiguration.java,
TopicDefinition.java, Gateway.java:31-160, ResourcesSpec.java:22,
ErrorsSpec.java:26-44, DiskSpec.java:22). TPU-native addition: ``TpuSpec`` on
``ResourcesSpec`` — the reference has no device topology concept (SURVEY §2.11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Resource / error specs (cascading defaults: agent → pipeline → app)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiskSpec:
    """Persistent state disk for an agent (reference DiskSpec.java:22)."""

    enabled: bool = False
    type: str = "default"
    size: str = "256M"

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["DiskSpec"]:
        if d is None:
            return None
        if isinstance(d, bool):
            return DiskSpec(enabled=d)
        return DiskSpec(
            enabled=bool(d.get("enabled", True)),
            type=str(d.get("type", "default")),
            size=str(d.get("size", "256M")),
        )


@dataclass(frozen=True)
class TpuSpec:
    """TPU topology request for an agent replica — new, no reference counterpart.

    One agent replica maps to one JAX process group over ``topology`` (e.g.
    "v5e-8"); ``mesh`` names logical axes and sizes, e.g. {"data":1,"model":8}.
    The planner validates that the mesh factorises the topology's chip count.

    ``hosts > 1`` declares a MULTI-HOST slice: the replica is still ONE
    logical broker consumer, but it spans ``hosts`` pods that form a single
    ``jax.distributed`` process group (replica-vs-shard distinction, SURVEY
    §7 — shard parallelism spans pods; replica parallelism multiplies
    consumers). The k8s factory emits hosts×parallelism StatefulSet pods and
    the entrypoint derives process_index/coordinator from the pod ordinal.
    """

    type: str = "v5e"
    topology: str = "1"  # chips per replica, e.g. "8" or "2x4"
    mesh: dict[str, int] = field(default_factory=dict)
    hosts: int = 1  # pods (JAX processes) forming one logical replica

    @staticmethod
    def normalized_topology(topology: str) -> str:
        """Strip a generation prefix: "8", "2x4", "v5e-8", "v5p-2x2" → bare
        "8" / "2x4" form (the single accept-forms contract — GKE label values
        and chip counting both derive from this)."""
        import re

        return re.sub(r"^[a-z0-9]*?-", "", str(topology).lower().strip())

    @property
    def chips(self) -> int:
        topo = self.normalized_topology(self.topology)
        n = 1
        for part in topo.split("x"):
            if part.strip().isdigit():
                n *= int(part)
        return max(n, 1)

    @property
    def chips_per_host(self) -> int:
        return self.chips // max(self.hosts, 1)

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["TpuSpec"]:
        if d is None:
            return None
        return TpuSpec(
            type=str(d.get("type", "v5e")),
            topology=str(d.get("topology", "1")),
            mesh=dict(d.get("mesh", {})),
            hosts=int(d.get("hosts", 1)),
        )


@dataclass(frozen=True)
class ResourcesSpec:
    """Scaling spec (reference ResourcesSpec.java:22) + TPU topology.

    parallelism → replica count (consumer-group data parallelism);
    size → cpu/mem units; tpu → per-replica device mesh (shard parallelism).
    """

    parallelism: Optional[int] = None
    size: Optional[int] = None
    disk: Optional[DiskSpec] = None
    tpu: Optional[TpuSpec] = None

    DEFAULT_PARALLELISM = 1
    DEFAULT_SIZE = 1

    def with_defaults_from(self, higher: Optional["ResourcesSpec"]) -> "ResourcesSpec":
        """Cascade (reference ResourcesSpec.withDefaultsFrom:30)."""
        if higher is None:
            return self
        return ResourcesSpec(
            parallelism=self.parallelism if self.parallelism is not None else higher.parallelism,
            size=self.size if self.size is not None else higher.size,
            disk=self.disk if self.disk is not None else higher.disk,
            tpu=self.tpu if self.tpu is not None else higher.tpu,
        )

    def resolved_parallelism(self) -> int:
        return self.parallelism if self.parallelism is not None else self.DEFAULT_PARALLELISM

    def resolved_size(self) -> int:
        return self.size if self.size is not None else self.DEFAULT_SIZE

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ResourcesSpec":
        if not d:
            return ResourcesSpec()
        return ResourcesSpec(
            parallelism=d.get("parallelism"),
            size=d.get("size"),
            disk=DiskSpec.from_dict(d.get("disk")),
            tpu=TpuSpec.from_dict(d.get("tpu")),
        )


VALID_ON_FAILURE = ("fail", "skip", "dead-letter")


@dataclass(frozen=True)
class ErrorsSpec:
    """Record-level error policy (reference ErrorsSpec.java:26-44)."""

    retries: Optional[int] = None
    on_failure: Optional[str] = None  # fail | skip | dead-letter

    DEFAULT_RETRIES = 0
    DEFAULT_ON_FAILURE = "fail"

    def with_defaults_from(self, higher: Optional["ErrorsSpec"]) -> "ErrorsSpec":
        if higher is None:
            return self
        return ErrorsSpec(
            retries=self.retries if self.retries is not None else higher.retries,
            on_failure=self.on_failure if self.on_failure is not None else higher.on_failure,
        )

    def resolved_retries(self) -> int:
        return self.retries if self.retries is not None else self.DEFAULT_RETRIES

    def resolved_on_failure(self) -> str:
        return self.on_failure if self.on_failure is not None else self.DEFAULT_ON_FAILURE

    def validate(self) -> None:
        if self.on_failure is not None and self.on_failure not in VALID_ON_FAILURE:
            raise ValueError(
                f"errors.on-failure must be one of {VALID_ON_FAILURE}, got {self.on_failure!r}"
            )
        if self.retries is not None and self.retries < 0:
            raise ValueError(f"errors.retries must be >= 0, got {self.retries}")

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ErrorsSpec":
        if not d:
            return ErrorsSpec()
        spec = ErrorsSpec(retries=d.get("retries"), on_failure=d.get("on-failure"))
        spec.validate()
        return spec


# ---------------------------------------------------------------------------
# Topics
# ---------------------------------------------------------------------------


@dataclass
class SchemaDefinition:
    type: str = "string"  # string | bytes | json | avro
    schema: Optional[str] = None
    name: Optional[str] = None

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["SchemaDefinition"]:
        if d is None:
            return None
        return SchemaDefinition(
            type=str(d.get("type", "string")),
            schema=d.get("schema"),
            name=d.get("name"),
        )


CREATE_MODE_NONE = "none"
CREATE_MODE_CREATE_IF_NOT_EXISTS = "create-if-not-exists"
DELETE_MODE_NONE = "none"
DELETE_MODE_DELETE = "delete"


@dataclass
class TopicDefinition:
    """Reference TopicDefinition.java. ``implicit`` marks planner-created topics."""

    name: str
    creation_mode: str = CREATE_MODE_NONE
    deletion_mode: str = DELETE_MODE_NONE
    partitions: int = 0
    implicit: bool = False
    key_schema: Optional[SchemaDefinition] = None
    value_schema: Optional[SchemaDefinition] = None
    options: dict[str, Any] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "TopicDefinition":
        name = d.get("name")
        if not name:
            raise ValueError("topic definition requires a 'name'")
        creation_mode = d.get("creation-mode", CREATE_MODE_NONE)
        if creation_mode not in (CREATE_MODE_NONE, CREATE_MODE_CREATE_IF_NOT_EXISTS):
            raise ValueError(f"unknown topic creation-mode {creation_mode!r}")
        deletion_mode = d.get("deletion-mode", DELETE_MODE_NONE)
        if deletion_mode not in (DELETE_MODE_NONE, DELETE_MODE_DELETE):
            raise ValueError(f"unknown topic deletion-mode {deletion_mode!r}")
        return TopicDefinition(
            name=name,
            creation_mode=creation_mode,
            deletion_mode=deletion_mode,
            partitions=int(d.get("partitions", 0)),
            key_schema=SchemaDefinition.from_dict(d.get("keySchema") or d.get("key-schema")),
            value_schema=SchemaDefinition.from_dict(d.get("schema") or d.get("value-schema")),
            options=dict(d.get("options", {})),
            config=dict(d.get("config", {})),
        )

    def copy(self) -> "TopicDefinition":
        return dataclasses.replace(self)


# ---------------------------------------------------------------------------
# Agents / pipelines / modules
# ---------------------------------------------------------------------------


@dataclass
class AgentConfiguration:
    """One agent step in a pipeline (reference AgentConfiguration.java)."""

    type: str
    id: Optional[str] = None
    name: Optional[str] = None
    input: Optional[str] = None  # topic name or implicit connection to previous
    output: Optional[str] = None
    configuration: dict[str, Any] = field(default_factory=dict)
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec = field(default_factory=ErrorsSpec)
    signals_from: Optional[str] = None
    deletion_mode: str = "none"


@dataclass
class Pipeline:
    id: str
    module: str
    name: Optional[str] = None
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec = field(default_factory=ErrorsSpec)
    agents: list[AgentConfiguration] = field(default_factory=list)


@dataclass
class Module:
    DEFAULT_MODULE = "default"

    id: str = DEFAULT_MODULE
    pipelines: dict[str, Pipeline] = field(default_factory=dict)
    topics: dict[str, TopicDefinition] = field(default_factory=dict)

    def add_topic(self, topic: TopicDefinition) -> TopicDefinition:
        existing = self.topics.get(topic.name)
        if existing is not None:
            return existing
        self.topics[topic.name] = topic
        return topic


# ---------------------------------------------------------------------------
# Gateways
# ---------------------------------------------------------------------------


@dataclass
class GatewayAuth:
    provider: str = ""
    configuration: dict[str, Any] = field(default_factory=dict)
    allow_test_mode: bool = True

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["GatewayAuth"]:
        if d is None:
            return None
        return GatewayAuth(
            provider=str(d.get("provider", "")),
            configuration=dict(d.get("configuration", {})),
            allow_test_mode=bool(d.get("allow-test-mode", True)),
        )


@dataclass
class ProduceOptions:
    headers: list[dict[str, Any]] = field(default_factory=list)


@dataclass
class ConsumeOptions:
    filters: dict[str, Any] = field(default_factory=dict)


@dataclass
class ChatOptions:
    """Reference Gateway.ChatOptions:135 — one socket, produce + filtered consume."""

    questions_topic: Optional[str] = None
    answers_topic: Optional[str] = None
    headers: list[dict[str, Any]] = field(default_factory=list)


@dataclass
class ServiceOptions:
    """Reference Gateway.ServiceOptions:149 — request/reply or agent proxy."""

    input_topic: Optional[str] = None
    output_topic: Optional[str] = None
    agent_id: Optional[str] = None
    headers: list[dict[str, Any]] = field(default_factory=list)


GATEWAY_TYPES = ("produce", "consume", "chat", "service")


@dataclass
class Gateway:
    """Reference Gateway.java:31-160; types :54-58."""

    id: str
    type: str
    topic: Optional[str] = None
    authentication: Optional[GatewayAuth] = None
    parameters: list[str] = field(default_factory=list)
    produce_options: Optional[ProduceOptions] = None
    consume_options: Optional[ConsumeOptions] = None
    chat_options: Optional[ChatOptions] = None
    service_options: Optional[ServiceOptions] = None
    events_topic: Optional[str] = None

    def __post_init__(self) -> None:
        if self.type not in GATEWAY_TYPES:
            raise ValueError(f"gateway type must be one of {GATEWAY_TYPES}, got {self.type!r}")


# ---------------------------------------------------------------------------
# Instance / resources / secrets
# ---------------------------------------------------------------------------


@dataclass
class StreamingCluster:
    type: str = "memory"  # memory | kafka | pulsar | pravega
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class ComputeCluster:
    type: str = "local"  # local | kubernetes
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class Instance:
    streaming_cluster: StreamingCluster = field(default_factory=StreamingCluster)
    compute_cluster: ComputeCluster = field(default_factory=ComputeCluster)
    globals_: dict[str, Any] = field(default_factory=dict)


@dataclass
class Resource:
    """configuration.resources entry — AI providers, datasources."""

    id: str
    type: str
    name: Optional[str] = None
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class AssetDefinition:
    id: str
    name: Optional[str] = None
    asset_type: str = ""
    creation_mode: str = CREATE_MODE_NONE
    deletion_mode: str = DELETE_MODE_NONE
    config: dict[str, Any] = field(default_factory=dict)


@dataclass
class Secret:
    id: str
    name: Optional[str] = None
    data: dict[str, Any] = field(default_factory=dict)


@dataclass
class Secrets:
    secrets: dict[str, Secret] = field(default_factory=dict)


@dataclass
class Dependency:
    """configuration.dependencies entry (jar/nar download in the reference)."""

    name: str
    url: str
    sha512sum: str = ""
    type: str = "java-library"


# ---------------------------------------------------------------------------
# Application root
# ---------------------------------------------------------------------------


@dataclass
class Application:
    """Root of the model (reference Application.java)."""

    modules: dict[str, Module] = field(default_factory=dict)
    resources: dict[str, Resource] = field(default_factory=dict)
    assets: list[AssetDefinition] = field(default_factory=list)
    dependencies: list[Dependency] = field(default_factory=list)
    gateways: list[Gateway] = field(default_factory=list)
    instance: Instance = field(default_factory=Instance)
    secrets: Secrets = field(default_factory=Secrets)
    # where the source package lives on disk (when known); the runtime adds
    # <code_directory>/python to python-agent subprocess paths (reference
    # PythonGrpcServer.java:61-76 PYTHONPATH injection)
    code_directory: Optional[str] = None

    def get_module(self, module_id: str) -> Module:
        mod = self.modules.get(module_id)
        if mod is None:
            mod = Module(id=module_id)
            self.modules[module_id] = mod
        return mod

    @property
    def default_module(self) -> Module:
        return self.get_module(Module.DEFAULT_MODULE)

    def all_agents(self) -> list[AgentConfiguration]:
        out: list[AgentConfiguration] = []
        for mod in self.modules.values():
            for pipe in mod.pipelines.values():
                out.extend(pipe.agents)
        return out
