"""Config validation against declared ConfigModels.

Parity: reference `impl/uti/ClassConfigValidator.java` (reflection+annotation
driven; unknown-field rejection, required fields, human-readable errors).
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.api.doc import ConfigModel
from langstream_tpu_torch.api.model import AgentConfiguration, Application, Resource
from langstream_tpu_torch.core.registry import REGISTRY


class ConfigValidationError(ValueError):
    pass


_TYPE_CHECKS = {
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, (list, tuple)),
    "any": lambda v: True,
}


def validate_config(
    entity: str, config: dict[str, Any], model: ConfigModel
) -> None:
    errors: list[str] = []
    if not model.allow_unknown:
        unknown = set(config) - set(model.properties)
        if unknown:
            errors.append(f"unknown configuration fields {sorted(unknown)}")
    for name, prop in model.properties.items():
        if prop.required and name not in config:
            errors.append(f"missing required field '{name}'")
            continue
        if name in config and config[name] is not None:
            check = _TYPE_CHECKS.get(prop.type, _TYPE_CHECKS["any"])
            if not check(config[name]):
                errors.append(
                    f"field '{name}' expected {prop.type}, got {type(config[name]).__name__}"
                )
    if errors:
        raise ConfigValidationError(f"invalid configuration for {entity}: " + "; ".join(errors))


def validate_agent(agent: AgentConfiguration) -> None:
    info = REGISTRY.agent(agent.type)  # raises UnknownAgentType
    if info.config_model is not None:
        validate_config(f"agent '{agent.id or agent.type}' (type={agent.type})",
                        agent.configuration, info.config_model)
    agent.errors.validate()


def validate_resource(resource: Resource) -> None:
    info = REGISTRY.resource(resource.type)
    if info is not None and info.config_model is not None:
        validate_config(
            f"resource '{resource.id}' (type={resource.type})",
            resource.configuration,
            info.config_model,
        )


def validate_application(application: Application) -> None:
    """Planner-independent validation pass: agent types, configs, gateways."""
    for resource in application.resources.values():
        validate_resource(resource)
    for agent in application.all_agents():
        validate_agent(agent)
    topics = {t for m in application.modules.values() for t in m.topics}
    for g in application.gateways:
        for topic in (g.topic,
                      g.chat_options.questions_topic if g.chat_options else None,
                      g.chat_options.answers_topic if g.chat_options else None,
                      g.service_options.input_topic if g.service_options else None,
                      g.service_options.output_topic if g.service_options else None):
            if topic and topic not in topics:
                raise ConfigValidationError(
                    f"gateway '{g.id}' references unknown topic '{topic}'"
                )
