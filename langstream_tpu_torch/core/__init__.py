"""L1 of the port — the YAML parser, placeholder resolver, config
validation, planner and deployer (the port's own copy of
``langstream_tpu/core``), and the type registry."""

from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.parser import ModelBuilder, ModelParseError
from langstream_tpu_torch.core.planner import ClusterRuntime
from langstream_tpu_torch.core.resolver import resolve_placeholders

__all__ = [
    "ApplicationDeployer",
    "ClusterRuntime",
    "ModelBuilder",
    "ModelParseError",
    "resolve_placeholders",
]
