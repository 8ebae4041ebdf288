"""The agent subprocess: a grpc.aio server hosting one user agent (the
port's own copy of ``langstream_tpu/grpc_runtime/service.py``).

Parity: reference python ``grpc_service.py:75-415`` — dynamic class loading
from ``className``, bidi read/process/write streams, worker execution with
``crash_process`` on fatal errors — and ``__main__.py`` (banner handshake:
the parent waits for ``LANGSTREAM-GRPC-PORT <port>`` on stdout instead of
polling health, PythonGrpcServer.java:61-90).

User code is written against the SDK's module paths
(``langstream_tpu.api.agent``, ``langstream_tpu.api.record``, ...). The
child's entry (``main``) answers those names with the port's modules of the
same path (``PortAlias``) before it loads the user class, so that code runs
on the port's SDK and never loads the JAX package.

Service glue is hand-written with generic method handlers because the image
has protoc but no grpc python plugin.
"""

from __future__ import annotations

import asyncio
import importlib
import importlib.abc
import importlib.util
import json
import logging
import os
import sys
from typing import Any, AsyncIterator, Optional

import grpc

from langstream_tpu_torch.api.agent import (
    AgentCode,
    AgentProcessor,
    AgentService,
    AgentSink,
    AgentSource,
    ComponentType,
)
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.grpc_runtime import agent_pb2 as pb
from langstream_tpu_torch.grpc_runtime.convert import (
    RPCS,
    SERVICE_NAME,
    SchemaCodec,
    error_text,
)

log = logging.getLogger(__name__)


JAX_PACKAGE = "langstream_tpu"
PORT_PACKAGE = "langstream_tpu_torch"


class PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Answers ``langstream_tpu`` and every ``langstream_tpu.<x>`` with the
    port's module ``langstream_tpu_torch.<x>`` — the same module object, not
    a second execution, so the user's classes subclass the port's SDK and
    ``isinstance(agent, AgentCode)`` holds. A name the port lacks raises
    ``ModuleNotFoundError`` naming it. Installed by the child only."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != JAX_PACKAGE and not fullname.startswith(JAX_PACKAGE + "."):
            return None
        port_name = PORT_PACKAGE + fullname[len(JAX_PACKAGE):]
        try:
            module = importlib.import_module(port_name)
        except ModuleNotFoundError as e:
            if e.name != port_name:
                raise
            raise ModuleNotFoundError(
                f"no module named {fullname!r}: the port has no {port_name!r}",
                name=fullname,
            ) from None
        spec = importlib.util.spec_from_loader(
            fullname, self, is_package=hasattr(module, "__path__")
        )
        spec.loader_state = (module, module.__spec__)
        return spec

    def create_module(self, spec):
        return spec.loader_state[0]

    def exec_module(self, module) -> None:
        # the import system set __spec__ to the alias spec; the module keeps
        # its own (every other attribute is left as it was)
        module.__spec__ = module.__spec__.loader_state[1]


def alias_jax_package() -> None:
    """Put ``PortAlias`` first on ``sys.meta_path`` (once)."""
    if not any(isinstance(f, PortAlias) for f in sys.meta_path):
        sys.meta_path.insert(0, PortAlias())


def load_agent_class(class_name: str, python_path: Optional[str] = None) -> AgentCode:
    """``module.Class`` → instance (reference grpc_service init_agent)."""
    if python_path:
        for entry in python_path.split(os.pathsep):
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)
    module_name, _, attr = class_name.rpartition(".")
    if not module_name:
        raise ValueError(f"className must be module.Class, got {class_name!r}")
    module = importlib.import_module(module_name)
    cls = getattr(module, attr)
    agent = cls()
    if not isinstance(agent, AgentCode):
        raise TypeError(f"{class_name} is not an AgentCode subclass")
    return agent


class _TopicProducerBuffer:
    """Records the agent emits to arbitrary topics; drained by the
    get_topic_producer_records stream (reference topic_producer path).
    Queued RAW — the draining stream encodes with its own per-stream codec,
    so a reconnecting consumer always receives the schemas it needs."""

    def __init__(self) -> None:
        self.queue: "asyncio.Queue[tuple[str, Record]]" = asyncio.Queue()
        self._next_id = 0

    async def write(self, topic: str, record: Record) -> None:
        await self.queue.put((topic, record))

    def next_id(self) -> int:
        self._next_id += 1
        return self._next_id


class AgentServiceServer:
    def __init__(self, agent: AgentCode, configuration: dict[str, Any]) -> None:
        self.agent = agent
        self.configuration = configuration
        self.topic_producer = _TopicProducerBuffer()
        self._source_records: dict[int, Record] = {}
        self._next_record_id = 0
        self.server: Optional[grpc.aio.Server] = None
        self.port = 0

    # -- rpc implementations -------------------------------------------------

    async def agent_info(self, request: pb.InfoRequest, context) -> pb.InfoResponse:
        return pb.InfoResponse(json_info=json.dumps(self.agent.agent_info()))

    async def read(
        self, requests: AsyncIterator[pb.SourceRequest], context
    ) -> AsyncIterator[pb.SourceResponse]:
        """Source loop: push record batches; consume commit / permanent
        failure signals from the request stream."""
        assert isinstance(self.agent, AgentSource)
        agent = self.agent

        async def handle_requests() -> None:
            async for request in requests:
                if request.committed_records:
                    records = [
                        self._source_records.pop(rid)
                        for rid in request.committed_records
                        if rid in self._source_records
                    ]
                    if records:
                        await agent.commit(records)
                if request.HasField("permanent_failure"):
                    failure = request.permanent_failure
                    record = self._source_records.pop(failure.record_id, None)
                    if record is not None:
                        await agent.permanent_failure(
                            record, RuntimeError(failure.error_message)
                        )

        consumer = asyncio.ensure_future(handle_requests())
        codec = SchemaCodec()  # fresh intern table per stream
        try:
            while not consumer.done():
                records = await agent.read()
                if not records:
                    await asyncio.sleep(0.01)
                    continue
                out = []
                schemas: list[pb.Schema] = []
                for record in records:
                    self._next_record_id += 1
                    self._source_records[self._next_record_id] = record
                    out.append(codec.to_grpc_record(record, self._next_record_id, schemas))
                yield pb.SourceResponse(records=out, schemas=schemas)
            # commit-stream ended or failed: propagate errors
            consumer.result()
        finally:
            consumer.cancel()

    async def process(
        self, requests: AsyncIterator[pb.ProcessorRequest], context
    ) -> AsyncIterator[pb.ProcessorResponse]:
        assert isinstance(self.agent, AgentProcessor)
        codec = SchemaCodec()
        async for request in requests:
            codec.register(request.schemas)
            records = [codec.from_grpc_record(m) for m in request.records]
            ids = [m.record_id for m in request.records]
            try:
                results = await self.agent.process(records)
            except BaseException as e:  # noqa: BLE001 — whole batch failed
                yield pb.ProcessorResponse(
                    results=[
                        pb.ProcessorResult(record_id=rid, error=error_text(e))
                        for rid in ids
                    ]
                )
                continue
            out = []
            schemas: list[pb.Schema] = []
            for rid, result in zip(ids, results):
                if result.error is not None:
                    out.append(
                        pb.ProcessorResult(record_id=rid, error=error_text(result.error))
                    )
                else:
                    out.append(
                        pb.ProcessorResult(
                            record_id=rid,
                            records=[
                                codec.to_grpc_record(r, rid, schemas)
                                for r in result.records
                            ],
                        )
                    )
            yield pb.ProcessorResponse(results=out, schemas=schemas)

    async def write(
        self, requests: AsyncIterator[pb.SinkRequest], context
    ) -> AsyncIterator[pb.SinkResponse]:
        assert isinstance(self.agent, AgentSink)
        codec = SchemaCodec()
        async for request in requests:
            codec.register(request.schemas)
            rid = request.record.record_id
            try:
                await self.agent.write(codec.from_grpc_record(request.record))
                yield pb.SinkResponse(record_id=rid)
            except BaseException as e:  # noqa: BLE001
                yield pb.SinkResponse(record_id=rid, error=error_text(e))

    async def get_topic_producer_records(
        self, requests: AsyncIterator[pb.TopicProducerWriteResult], context
    ) -> AsyncIterator[pb.TopicProducerRecord]:
        async def drain_results() -> None:
            async for _ in requests:
                pass  # write acks; failures crash the runtime side

        consumer = asyncio.ensure_future(drain_results())
        codec = SchemaCodec()  # fresh intern table per stream
        try:
            while True:
                topic, record = await self.topic_producer.queue.get()
                schemas: list[pb.Schema] = []
                grpc_record = codec.to_grpc_record(
                    record, self.topic_producer.next_id(), schemas
                )
                yield pb.TopicProducerRecord(
                    topic=topic, record=grpc_record, schemas=schemas
                )
        finally:
            consumer.cancel()

    # -- server lifecycle ----------------------------------------------------

    def _handlers(self) -> grpc.GenericRpcHandler:
        method_handlers = {}
        for name, (req_type, resp_type, req_stream, resp_stream) in RPCS.items():
            impl = getattr(self, name)
            if req_stream and resp_stream:
                factory = grpc.stream_stream_rpc_method_handler
            elif not req_stream and not resp_stream:
                factory = grpc.unary_unary_rpc_method_handler
            else:  # pragma: no cover — no mixed rpcs in the contract
                raise AssertionError(name)
            method_handlers[name] = factory(
                impl,
                request_deserializer=req_type.FromString,
                response_serializer=resp_type.SerializeToString,
            )
        return grpc.method_handlers_generic_handler(SERVICE_NAME, method_handlers)

    async def start(self, port: int = 0, address: str = "127.0.0.1") -> int:
        await self.agent.init(self.configuration)
        await self.agent.start()
        self.server = grpc.aio.server()
        self.server.add_generic_rpc_handlers((self._handlers(),))
        self.port = self.server.add_insecure_port(f"{address}:{port}")
        await self.server.start()
        return self.port

    async def stop(self) -> None:
        if self.server is not None:
            await self.server.stop(grace=1)
            self.server = None
        await self.agent.close()

    async def serve_forever(self) -> None:
        assert self.server is not None
        if isinstance(self.agent, AgentService):
            # a service that completes normally must let the process exit
            # with rc=0 (the bridge's join() watches the process, not an rpc)
            await self.agent.join()
            await self.server.stop(grace=1)
            self.server = None
            return
        await self.server.wait_for_termination()


async def amain(config: dict[str, Any]) -> None:
    agent = load_agent_class(
        config["className"], config.get("pythonPath") or os.environ.get("PYTHONPATH")
    )
    agent.agent_id = config.get("agentId", "")
    agent.agent_type = config.get("agentType", agent.agent_type)
    server = AgentServiceServer(agent, config.get("configuration", {}))
    port = await server.start(int(config.get("port", 0)))
    # banner handshake — the parent reads this line to learn the port
    print(f"LANGSTREAM-GRPC-PORT {port}", flush=True)
    try:
        await server.serve_forever()
    finally:
        await server.stop()


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    raw = sys.argv[1] if len(sys.argv) > 1 else os.environ.get("LANGSTREAM_AGENT_CONFIG", "{}")
    config = json.loads(raw)
    alias_jax_package()
    try:
        asyncio.run(amain(config))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
