"""Shared helpers of the broker tests that hold the port against the JAX
package: each package's fakes and runtimes side by side, a seeded exchange
of records through a runtime against a fake (either package's client
against either package's fake), and a completions app served over a broker
on both packages' local runners."""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import json
import random
import shutil
import types
from pathlib import Path

import langstream_tpu.api.record as jax_record
import langstream_tpu.messaging.kafka as jax_kafka
import langstream_tpu.messaging.kafka_fake as jax_kafka_fake
import langstream_tpu.messaging.memory as jax_memory
import langstream_tpu.messaging.pravega as jax_pravega
import langstream_tpu.messaging.pravega_fake as jax_pravega_fake
import langstream_tpu.messaging.pulsar as jax_pulsar
import langstream_tpu.messaging.pulsar_fake as jax_pulsar_fake
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.messaging.kafka as port_kafka
import langstream_tpu_torch.messaging.kafka_fake as port_kafka_fake
import langstream_tpu_torch.messaging.memory as port_memory
import langstream_tpu_torch.messaging.pravega as port_pravega
import langstream_tpu_torch.messaging.pravega_fake as port_pravega_fake
import langstream_tpu_torch.messaging.pulsar as port_pulsar
import langstream_tpu_torch.messaging.pulsar_fake as port_pulsar_fake
from langstream_tpu_torch.messaging import fake_process

ROOT = Path(__file__).resolve().parents[1]
SESSION = "langstream-client-session-id"
# per-run values: the answer's stream id, the trace id
VOLATILE = ("stream-id", "ls-trace-id")

JAX = types.SimpleNamespace(
    name="jax", record=jax_record, memory=jax_memory,
    runtimes={"kafka": jax_kafka.KafkaTopicConnectionsRuntime,
              "pulsar": jax_pulsar.PulsarTopicConnectionsRuntime,
              "pravega": jax_pravega.PravegaTopicConnectionsRuntime},
    fakes={"kafka": jax_kafka_fake.FakeKafkaBroker, "pulsar": jax_pulsar_fake.FakePulsarBroker,
           "pravega": jax_pravega_fake.FakePravega})
PORT = types.SimpleNamespace(
    name="port", record=port_record, memory=port_memory,
    runtimes={"kafka": port_kafka.KafkaTopicConnectionsRuntime,
              "pulsar": port_pulsar.PulsarTopicConnectionsRuntime,
              "pravega": port_pravega.PravegaTopicConnectionsRuntime},
    fakes={"kafka": port_kafka_fake.FakeKafkaBroker, "pulsar": port_pulsar_fake.FakePulsarBroker,
           "pravega": port_pravega_fake.FakePravega})
PACKAGES = {"jax": JAX, "port": PORT}

def cluster_config(kind: str, broker) -> dict:
    """The ``streamingCluster.configuration`` of an instance on ``broker``."""
    if kind == "kafka":
        return {"admin": {"bootstrap.servers": broker.bootstrap}}
    if kind == "pulsar":
        return {"service": {"serviceUrl": broker.service_url},
                "admin": {"serviceUrl": broker.admin_url}}
    return {"client": {"controller-rest-uri": broker.controller_url,
                       "segment-store": broker.segment_store_url, "scope": "langstream"}}


def seeded_records(pkg, seed: int, n: int) -> list:
    """``n`` records with keys, headers and fixed timestamps from ``seed``
    (equal values in both packages' record types)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        value = "".join(rng.choice("abcdefghij é") for _ in range(rng.randrange(1, 40)))
        headers = [(f"h{j}", f"{rng.randrange(1000)}") for j in range(rng.randrange(3))]
        out.append(pkg.record.SimpleRecord.of(
            value, key=f"k{rng.randrange(6)}", headers=headers,
            timestamp=1_700_000_000.0 + i))
    return out


async def exchange(client: str, fake: str, kind: str, seed: int = 0, n: int = 24) -> dict:
    """``client``'s runtime against ``fake``'s broker: a 2-partition topic,
    ``n`` seeded records produced, consumed in group ``g`` and committed.
    Returns the records as read (sorted by partition and offset), the
    partition of each key, and the broker's committed records."""
    cpkg, fpkg = PACKAGES[client], PACKAGES[fake]
    broker = await fpkg.fakes[kind]().start()
    runtime = cpkg.runtimes[kind]()
    try:
        await runtime.init(cluster_config(kind, broker))
        await runtime.create_topic_admin().create_topic("x", partitions=2)
        consumer = runtime.create_consumer("g", "x")
        await consumer.start()
        producer = runtime.create_producer("g", "x")
        await producer.start()
        for record in seeded_records(cpkg, seed, n):
            await producer.write(record)
        got = []
        for _ in range(200):
            got.extend(await consumer.read())
            if len(got) >= n:
                break
        await consumer.commit(got)
        await consumer.close()
        await producer.close()
        # the pulsar consumer acks asynchronously: let the broker see them
        await asyncio.sleep(0.05)
        rows = sorted((r.partition, r.offset, r.key, r.value,
                       tuple((h.key, h.value) for h in r.headers)) for r in got)
        return {"rows": rows, "partitions": sorted({(r.key, r.partition) for r in got}),
                "committed": fake_process.committed(kind, broker, "x")}
    finally:
        await runtime.close()
        await broker.stop()


# -- a completions app over a broker, on both packages' local runners --------


@functools.lru_cache(maxsize=None)
def f32_configs():
    from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
    from langstream_tpu_torch.models.configs import MODEL_PRESETS

    return (dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32"))


@functools.lru_cache(maxsize=None)
def tiny_weights():
    import jax
    import numpy as np

    from langstream_tpu.models.transformer import init_params as jax_init_params
    from langstream_tpu_torch.models.bridge import params_from_numpy

    jax_cfg, port_cfg = f32_configs()
    tree = jax_init_params(jax_cfg, jax.random.PRNGKey(0))
    return tree, params_from_numpy(jax.tree.map(np.asarray, tree), port_cfg, device="cpu")


def completions_app(tmp_path: Path) -> Path:
    """The tpu-completions example with ``device: cpu`` in its resource."""
    app = tmp_path / "tpu-completions"
    if not app.exists():
        shutil.copytree(ROOT / "examples" / "applications" / "tpu-completions", app)
        conf = app / "configuration.yaml"
        text = conf.read_text()
        assert "        tokenizer: byte\n" in text
        conf.write_text(text.replace("        tokenizer: byte\n",
                                     "        tokenizer: byte\n        device: cpu\n"))
    return app


def write_instance(path: Path, kind: str, config: dict) -> Path:
    lines = ["instance:", "  streamingCluster:", f"    type: {kind}"]
    if config:
        lines.append(f"    configuration: {json.dumps(config)}")
    lines += ["  computeCluster:", "    type: local", "  globals:",
              "    serving-model: tiny-test", ""]
    path.write_text("\n".join(lines))
    return path


def _record(record) -> dict:
    headers = {h.key: h.value for h in record.headers if h.key not in VOLATILE}
    return {"key": record.key, "value": record.value, "headers": headers}


def _final(record) -> dict:
    out = _record(record)
    value = json.loads(out["value"])
    prompt = json.loads(value["prompt"])
    prompt["options"].pop("trace-id", None)
    value["prompt"] = prompt
    out["value"] = value
    return out


async def serve_app(pkg_name: str, kind: str, app_dir: Path, instance_dir: Path,
                    questions: list[str]) -> tuple[dict, list, dict | None]:
    """Deploy the completions app on ``pkg_name``'s local runner over
    ``kind`` (its own fake, or its memory broker), ask each question in its
    own session and read the answer's chunks to its last one, then the
    debug records."""
    import langstream_tpu.core.parser as jax_parser
    import langstream_tpu.runtime.local_runner as jax_local
    import langstream_tpu_torch.core.parser as port_parser
    import langstream_tpu_torch.runtime.local_runner as port_local

    pkg = PACKAGES[pkg_name]
    parser, local = (jax_parser, jax_local) if pkg is JAX else (port_parser, port_local)
    JAX.memory.MemoryBroker.reset()
    PORT.memory.MemoryBroker.reset()
    broker = None
    if kind != "memory":
        broker = await pkg.fakes[kind]().start()
    try:
        instance = write_instance(instance_dir / f"{pkg_name}-{kind}.yaml", kind,
                                  cluster_config(kind, broker) if broker else {})
        package = parser.ModelBuilder.build_application_from_path(
            app_dir, instance_path=instance)
        runner = local.LocalApplicationRunner("app", package.application)
        await runner.deploy()
        runner._service_registry.get_provider().holder._params = tiny_weights()[
            0 if pkg is JAX else 1]
        await runner.start()
        chunks: dict[str, list] = {}
        try:
            seen = 0
            for k, question in enumerate(questions):
                session = f"s{k}"
                await runner.produce("questions-topic", question, headers=[(SESSION, session)])
                done = False
                while not done:
                    got = await runner.consume("answers-topic", n=seen + 1, timeout=120)
                    for record in got[seen:]:
                        headers = {h.key: h.value for h in record.headers}
                        chunks.setdefault(headers[SESSION], []).append(_record(record))
                        done = done or (headers[SESSION] == session
                                        and headers.get("stream-last-message") == "true")
                    seen = len(got)
            final = await runner.consume("debug-topic", n=len(questions), timeout=60)
        finally:
            await runner.stop()
        committed = fake_process.committed(kind, broker, "questions-topic") if broker else None
        return chunks, [_final(r) for r in final], committed
    finally:
        if broker is not None:
            await broker.stop()
        JAX.memory.MemoryBroker.reset()
        PORT.memory.MemoryBroker.reset()
