"""The port's parser, resolver and planner against the JAX package's on
every application under ``examples/applications``: equal applications
(topics, pipelines, agents, gateways, resources, resolved globals and
secrets) for every app, and equal execution plans (agent nodes after
fusion, connections, topics) for every app whose agent types the port has.
An app with an agent type the port does not have yet is refused by name
(``UnknownAgentType``), never planned into something else."""

import dataclasses
import enum
from pathlib import Path

import pytest

from langstream_tpu.core.parser import ModelBuilder as JaxModelBuilder
from langstream_tpu.core.planner import ClusterRuntime as JaxClusterRuntime
from langstream_tpu.core.resolver import resolve_placeholders as jax_resolve
from langstream_tpu_torch.core.parser import ModelBuilder
from langstream_tpu_torch.core.planner import ClusterRuntime
from langstream_tpu_torch.core.registry import REGISTRY, UnknownAgentType
from langstream_tpu_torch.core.resolver import resolve_placeholders

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
APPS = sorted(p for p in (EXAMPLES / "applications").iterdir() if p.is_dir())
INSTANCE = EXAMPLES / "instances" / "local-memory.yaml"
SECRETS = EXAMPLES / "secrets" / "secrets.yaml"
# the apps the port plans: every agent type they use is ported
PLANNED = {
    "astradb-sink", "bedrock-text-completions", "chatbot-rag-memory", "chatbot-ui",
    "compute-tpu-embeddings", "docker-chatbot", "flare", "gateway-authentication", "moe-chat",
    "ollama-chatbot", "query-astradb", "query-milvus", "query-opensearch", "query-pinecone",
    "query-postgresql-chat-history", "query-solr", "react-chatbot-ui", "text-completions",
    "text-processing", "tpu-completions", "tpu-rag", "vertexai-text-completions",
    "webcrawler-astra-vector-db", "webcrawler-source",
}


def plain(obj):
    """A package-neutral form: dataclasses as (class name, fields), enums
    as their values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def both(app_dir):
    jax_pkg = JaxModelBuilder.build_application_from_path(
        app_dir, instance_path=INSTANCE, secrets_path=SECRETS)
    port_pkg = ModelBuilder.build_application_from_path(
        app_dir, instance_path=INSTANCE, secrets_path=SECRETS)
    return jax_pkg, port_pkg


def test_every_example_app_is_covered():
    assert len(APPS) > 30
    assert PLANNED <= {p.name for p in APPS}


@pytest.mark.parametrize("app_dir", APPS, ids=[p.name for p in APPS])
def test_applications_equal_jax(app_dir):
    jax_pkg, port_pkg = both(app_dir)
    assert port_pkg.digest == jax_pkg.digest
    assert plain(port_pkg.application) == plain(jax_pkg.application)
    assert plain(resolve_placeholders(port_pkg.application)) == plain(
        jax_resolve(jax_pkg.application))


@pytest.mark.parametrize("app_dir", APPS, ids=[p.name for p in APPS])
def test_execution_plans_equal_jax(app_dir):
    jax_pkg, port_pkg = both(app_dir)
    want = JaxClusterRuntime().build_execution_plan(
        app_dir.name, jax_resolve(jax_pkg.application))
    app = resolve_placeholders(port_pkg.application)
    if app_dir.name not in PLANNED:
        with pytest.raises(UnknownAgentType) as info:
            ClusterRuntime().build_execution_plan(app_dir.name, app)
        missing = str(info.value).split("'")[1]
        assert not REGISTRY.has_agent(missing)
        assert missing in {a.type for m in app.modules.values()
                            for p in m.pipelines.values() for a in p.agents}
        return
    got = ClusterRuntime().build_execution_plan(app_dir.name, app)
    assert plain(got) == plain(want)
    assert [n.id for n in got.agent_sequence()] == [n.id for n in want.agent_sequence()]
