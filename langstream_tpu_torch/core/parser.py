"""YAML → Application parser (the port's own copy of
``langstream_tpu/core/parser.py``; the YAML is read by the port's own
``core/yaml_reader.py``, since the card's machine has no PyYAML).

Parity: reference `langstream-core/impl/parser/ModelBuilder.java:74`
(buildApplicationInstance:370, parseApplicationFile:410, parseConfiguration:467,
parseGateways:503, parsePipelineFile:659, parseSecrets:812, parseInstance:837).

Application layout (same file conventions as the reference):
  <app-dir>/
    pipeline.yaml (any *.yaml with a `pipeline:` key is a pipeline file)
    configuration.yaml   — resources / dependencies
    gateways.yaml        — gateway definitions
  instance.yaml and secrets.yaml are provided separately (per-environment).

Unknown top-level fields in pipeline files are rejected (strict parsing,
mirroring the reference's FAIL_ON_UNKNOWN_PROPERTIES stance).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Optional, Union

from langstream_tpu_torch.api.model import (
    AgentConfiguration,
    Application,
    AssetDefinition,
    ChatOptions,
    ComputeCluster,
    ConsumeOptions,
    Dependency,
    ErrorsSpec,
    Gateway,
    GatewayAuth,
    Instance,
    Module,
    Pipeline,
    ProduceOptions,
    Resource,
    ResourcesSpec,
    Secret,
    Secrets,
    ServiceOptions,
    StreamingCluster,
    TopicDefinition,
)
from langstream_tpu_torch.core.yaml_reader import YamlError, safe_load

PIPELINE_FILE_KEYS = {
    "id",
    "module",
    "name",
    "topics",
    "assets",
    "pipeline",
    "errors",
    "resources",
}


def is_pipeline_document(rel_path: str) -> bool:
    """True for files that parse as application documents (YAML); user code
    (python/, requirements, binaries) travels via code storage instead.
    The single predicate shared by stores, services, and the k8s executor."""
    from pathlib import PurePosixPath

    name = PurePosixPath(rel_path).name
    return name.endswith((".yaml", ".yml")) and name not in (".yaml", ".yml")


class ModelParseError(ValueError):
    """Raised on malformed application YAML."""


def _load_yaml(text: str, origin: str) -> Any:
    try:
        return safe_load(text)
    except YamlError as e:
        raise ModelParseError(f"invalid YAML in {origin}:{e.line}: {e}") from e


class ApplicationWithPackageInfo:
    def __init__(self, application: Application, digest: Optional[str] = None) -> None:
        self.application = application
        self.digest = digest


class ModelBuilder:
    """Builds an Application from directories / in-memory file maps."""

    @staticmethod
    def build_application_from_files(
        files: dict[str, str],
        instance_text: Optional[str] = None,
        secrets_text: Optional[str] = None,
    ) -> ApplicationWithPackageInfo:
        """files: relative-name → YAML text (the app package contents)."""
        app = Application()
        digest = hashlib.sha256()
        for name in sorted(files):
            text = files[name]
            digest.update(name.encode())
            digest.update(text.encode())
            if not (name.endswith(".yaml") or name.endswith(".yml")):
                continue
            base = Path(name).name
            if base == "configuration.yaml":
                ModelBuilder._parse_configuration(text, app, origin=name)
            elif base == "gateways.yaml":
                ModelBuilder._parse_gateways(text, app, origin=name)
            elif base in ("instance.yaml", "secrets.yaml"):
                # environment files are not part of the app package
                raise ModelParseError(
                    f"{base} must not be inside the application package; pass it separately"
                )
            else:
                ModelBuilder._parse_pipeline_file(text, app, origin=name)
        if instance_text is not None:
            app.instance = ModelBuilder.parse_instance(instance_text)
        if secrets_text is not None:
            app.secrets = ModelBuilder.parse_secrets(secrets_text)
        return ApplicationWithPackageInfo(app, digest.hexdigest())

    @staticmethod
    def build_application_from_path(
        app_dir: Union[str, Path],
        instance_path: Optional[Union[str, Path]] = None,
        secrets_path: Optional[Union[str, Path]] = None,
    ) -> ApplicationWithPackageInfo:
        app_dir = Path(app_dir)
        if not app_dir.is_dir():
            raise ModelParseError(f"application directory {app_dir} does not exist")
        files: dict[str, str] = {}
        for p in sorted(app_dir.rglob("*")):
            if p.is_file() and p.suffix in (".yaml", ".yml"):
                rel = str(p.relative_to(app_dir))
                if Path(rel).name in ("instance.yaml", "secrets.yaml"):
                    continue
                files[rel] = p.read_text()
        instance_text = Path(instance_path).read_text() if instance_path else None
        secrets_text = Path(secrets_path).read_text() if secrets_path else None
        pkg = ModelBuilder.build_application_from_files(files, instance_text, secrets_text)
        pkg.application.code_directory = str(app_dir)
        return pkg

    # -- pipeline files -----------------------------------------------------

    @staticmethod
    def _parse_pipeline_file(text: str, app: Application, origin: str) -> None:
        data = _load_yaml(text, origin)
        if data is None:
            return
        if not isinstance(data, dict):
            raise ModelParseError(f"{origin}: pipeline file must be a mapping")
        unknown = set(data) - PIPELINE_FILE_KEYS
        if unknown:
            raise ModelParseError(f"{origin}: unknown top-level fields {sorted(unknown)}")

        module_id = data.get("module", Module.DEFAULT_MODULE)
        module = app.get_module(module_id)
        pipeline_id = data.get("id") or Path(origin).stem
        if pipeline_id in module.pipelines:
            raise ModelParseError(f"{origin}: duplicate pipeline id {pipeline_id!r}")

        pipeline = Pipeline(
            id=pipeline_id,
            module=module_id,
            name=data.get("name"),
            resources=ResourcesSpec.from_dict(data.get("resources")),
            errors=ErrorsSpec.from_dict(data.get("errors")),
        )

        for t in data.get("topics") or []:
            if not isinstance(t, dict):
                raise ModelParseError(f"{origin}: topic entries must be mappings")
            module.add_topic(TopicDefinition.from_dict(t))

        for a in data.get("assets") or []:
            app.assets.append(
                AssetDefinition(
                    id=a.get("id") or a.get("name") or f"asset-{len(app.assets)}",
                    name=a.get("name"),
                    asset_type=a.get("asset-type", ""),
                    creation_mode=a.get("creation-mode", "none"),
                    deletion_mode=a.get("deletion-mode", "none"),
                    config=dict(a.get("config", {})),
                )
            )

        seen_ids: set[str] = {
            a.id for p in module.pipelines.values() for a in p.agents if a.id
        }
        for i, step in enumerate(data.get("pipeline") or []):
            if not isinstance(step, dict):
                raise ModelParseError(f"{origin}: pipeline steps must be mappings")
            if "type" not in step or not step["type"]:
                raise ModelParseError(f"{origin}: pipeline step #{i} missing 'type'")
            agent = AgentConfiguration(
                type=str(step["type"]),
                id=step.get("id"),
                name=step.get("name"),
                input=step.get("input"),
                output=step.get("output"),
                configuration=dict(step.get("configuration", {})),
                resources=ResourcesSpec.from_dict(step.get("resources")).with_defaults_from(
                    pipeline.resources
                ),
                errors=ErrorsSpec.from_dict(step.get("errors")).with_defaults_from(
                    pipeline.errors
                ),
                signals_from=step.get("signals-from"),
                deletion_mode=step.get("deletion-mode", "none"),
            )
            if agent.id:
                if agent.id in seen_ids:
                    raise ModelParseError(f"{origin}: duplicate agent id {agent.id!r}")
                seen_ids.add(agent.id)
            pipeline.agents.append(agent)

        module.pipelines[pipeline_id] = pipeline

    # -- configuration.yaml -------------------------------------------------

    @staticmethod
    def _parse_configuration(text: str, app: Application, origin: str) -> None:
        data = _load_yaml(text, origin)
        if data is None:
            return
        if not isinstance(data, dict):
            raise ModelParseError(f"{origin}: configuration file must be a mapping")
        conf = data.get("configuration")
        if conf is None:
            raise ModelParseError(f"{origin}: missing top-level 'configuration'")
        for r in conf.get("resources") or []:
            rid = r.get("id") or r.get("name")
            if not rid:
                raise ModelParseError(f"{origin}: resource entries require id or name")
            if rid in app.resources:
                raise ModelParseError(f"{origin}: duplicate resource id {rid!r}")
            app.resources[rid] = Resource(
                id=rid,
                type=str(r.get("type", "")),
                name=r.get("name"),
                configuration=dict(r.get("configuration", {})),
            )
        for d in conf.get("dependencies") or []:
            app.dependencies.append(
                Dependency(
                    name=d.get("name", ""),
                    url=d.get("url", ""),
                    sha512sum=d.get("sha512sum", ""),
                    type=d.get("type", "java-library"),
                )
            )

    # -- gateways.yaml ------------------------------------------------------

    @staticmethod
    def _parse_gateways(text: str, app: Application, origin: str) -> None:
        data = _load_yaml(text, origin)
        if data is None:
            return
        if not isinstance(data, dict):
            raise ModelParseError(f"{origin}: gateways file must be a mapping")
        for g in data.get("gateways") or []:
            gid = g.get("id")
            gtype = g.get("type")
            if not gid or not gtype:
                raise ModelParseError(f"{origin}: gateways require id and type")
            chat = g.get("chat-options")
            service = g.get("service-options")
            produce = g.get("produce-options")
            consume = g.get("consume-options")
            app.gateways.append(
                Gateway(
                    id=gid,
                    type=gtype,
                    topic=g.get("topic"),
                    authentication=GatewayAuth.from_dict(g.get("authentication")),
                    parameters=list(g.get("parameters", [])),
                    produce_options=ProduceOptions(headers=list(produce.get("headers", [])))
                    if produce
                    else None,
                    consume_options=ConsumeOptions(filters=dict(consume.get("filters", {})))
                    if consume
                    else None,
                    chat_options=ChatOptions(
                        questions_topic=chat.get("questions-topic"),
                        answers_topic=chat.get("answers-topic"),
                        headers=list(chat.get("headers", [])),
                    )
                    if chat
                    else None,
                    service_options=ServiceOptions(
                        input_topic=service.get("input-topic"),
                        output_topic=service.get("output-topic"),
                        agent_id=service.get("agent-id"),
                        headers=list(service.get("headers", [])),
                    )
                    if service
                    else None,
                    events_topic=g.get("events-topic"),
                )
            )

    # -- instance.yaml / secrets.yaml ---------------------------------------

    @staticmethod
    def parse_instance(text: str) -> Instance:
        data = _load_yaml(text, "instance.yaml") or {}
        inst = data.get("instance") or {}
        sc = inst.get("streamingCluster") or inst.get("streaming-cluster") or {}
        cc = inst.get("computeCluster") or inst.get("compute-cluster") or {}
        return Instance(
            streaming_cluster=StreamingCluster(
                type=sc.get("type", "memory"),
                configuration=dict(sc.get("configuration", {})),
            ),
            compute_cluster=ComputeCluster(
                type=cc.get("type", "local"),
                configuration=dict(cc.get("configuration", {})),
            ),
            globals_=dict(inst.get("globals", {}) or {}),
        )

    @staticmethod
    def parse_secrets(text: str) -> Secrets:
        data = _load_yaml(text, "secrets.yaml") or {}
        out: dict[str, Secret] = {}
        for s in data.get("secrets") or []:
            sid = s.get("id") or s.get("name")
            if not sid:
                raise ModelParseError("secrets entries require id or name")
            out[sid] = Secret(id=sid, name=s.get("name"), data=dict(s.get("data", {})))
        return Secrets(secrets=out)
