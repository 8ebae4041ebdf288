"""Out-of-process Python agent types (the port's own copy of
``langstream_tpu/agents/python_agents.py``).

Parity: reference ``PythonAgentsCodeProvider.java:25-39`` — agent types
``python-source`` / ``python-processor`` / ``python-sink`` / ``python-service``
(and the ``experimental-python-*`` aliases) backed by the gRPC subprocess
bridge. Configuration: ``className`` (module.Class of user code implementing
the SDK ABCs in langstream_tpu.api.agent, which the child answers with
the port's SDK) and optional ``pythonPath`` (default: the application's
``python/`` directory).
"""

from __future__ import annotations

from langstream_tpu_torch.api.agent import ComponentType
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo
from langstream_tpu_torch.grpc_runtime.bridge import (
    GrpcAgentProcessor,
    GrpcAgentService,
    GrpcAgentSink,
    GrpcAgentSource,
)


def _config_model(type_: str) -> ConfigModel:
    return ConfigModel(
        type=type_,
        allow_unknown=True,
        properties={
            "className": ConfigProperty(
                "className", "module.Class of the user agent", type="string", required=True
            ),
            "pythonPath": ConfigProperty(
                "pythonPath", "extra sys.path entries for the subprocess", type="string"
            ),
        },
    )


def _register() -> None:
    for type_, component, factory in (
        ("python-source", ComponentType.SOURCE, GrpcAgentSource),
        ("python-processor", ComponentType.PROCESSOR, GrpcAgentProcessor),
        ("python-sink", ComponentType.SINK, GrpcAgentSink),
        ("python-service", ComponentType.SERVICE, GrpcAgentService),
    ):
        REGISTRY.register_agent(
            AgentTypeInfo(
                type=type_,
                component_type=component,
                factory=factory,
                description=f"User Python agent in an isolated subprocess ({component.value}).",
                config_model=_config_model(type_),
                aliases=(f"experimental-{type_}",)
                + (("python-function",) if type_ == "python-processor" else ()),
            )
        )


_register()
