"""Runtime-side bridge: spawn the agent subprocess and adapt its gRPC
surface back onto the in-process agent SPI (the port's own copy of
``langstream_tpu/grpc_runtime/bridge.py``).

Parity: reference ``PythonGrpcServer.java:40-90`` (spawn ``python -m …``,
wait for readiness, restart on death) and ``GrpcAgentProcessor.java:31`` /
``GrpcAgentSource`` / ``GrpcAgentSink`` (bidi streams with record_id
correlation).  The stubs are built from raw channel methods because the
image ships no grpc protoc plugin.

The runtime's one event loop also carries the gateway, the broker, the
runners and the serving provider's chunk writer: nothing here blocks it (the
banner is read on a thread; a closing child is waited for on a worker
thread). The child never sees the card (``CUDA_VISIBLE_DEVICES`` is empty).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import subprocess
import sys
import threading
from typing import Any, AsyncIterator, Optional

import grpc

from langstream_tpu_torch.api.agent import (
    AgentProcessor,
    AgentService,
    AgentSink,
    AgentSource,
    ProcessorResult,
)
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.grpc_runtime import agent_pb2 as pb
from langstream_tpu_torch.grpc_runtime.convert import SchemaCodec, method

log = logging.getLogger(__name__)


class PythonGrpcServer:
    """Supervises one agent subprocess (spawn → banner handshake → restart)."""

    def __init__(
        self,
        class_name: str,
        configuration: dict[str, Any],
        python_path: Optional[str] = None,
        agent_id: str = "",
        agent_type: str = "",
        startup_timeout_s: float = 30.0,
    ) -> None:
        self.config = {
            "className": class_name,
            "configuration": configuration,
            "pythonPath": python_path,
            "agentId": agent_id,
            "agentType": agent_type,
        }
        self.startup_timeout_s = startup_timeout_s
        self.process: Optional[subprocess.Popen] = None
        self.port = 0
        self.channel: Optional[grpc.aio.Channel] = None

    async def start(self) -> None:
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        extra = [repo_root]
        if self.config.get("pythonPath"):
            extra.append(self.config["pythonPath"])
        if env.get("PYTHONPATH"):
            extra.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(extra)
        env["CUDA_VISIBLE_DEVICES"] = ""  # agent subprocesses never own the card
        self.process = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.grpc_runtime", json.dumps(self.config)],
            stdout=subprocess.PIPE,
            stderr=None,
            env=env,
            text=True,
        )
        loop = asyncio.get_running_loop()
        banner: "asyncio.Future[int]" = loop.create_future()

        def read_banner() -> None:
            assert self.process is not None and self.process.stdout is not None
            for line in self.process.stdout:
                line = line.strip()
                if line.startswith("LANGSTREAM-GRPC-PORT "):
                    port = int(line.split()[1])
                    loop.call_soon_threadsafe(
                        lambda: banner.done() or banner.set_result(port)
                    )
                # keep draining so the child never blocks on stdout
            if not banner.done():
                loop.call_soon_threadsafe(
                    lambda: banner.done()
                    or banner.set_exception(
                        RuntimeError("agent subprocess exited before becoming ready")
                    )
                )

        threading.Thread(target=read_banner, daemon=True).start()
        try:
            self.port = await asyncio.wait_for(banner, self.startup_timeout_s)
        except (asyncio.TimeoutError, RuntimeError):
            # never leak a half-started subprocess (hung import etc.)
            await self.close()
            raise
        self.channel = grpc.aio.insecure_channel(f"127.0.0.1:{self.port}")

    def alive(self) -> bool:
        return self.process is not None and self.process.poll() is None

    async def ensure_running(self) -> None:
        """Restart a dead subprocess (reference PythonGrpcServer restart)."""
        if not self.alive():
            log.warning("agent subprocess died (rc=%s); restarting",
                        self.process.returncode if self.process else None)
            await self.close()
            await self.start()

    async def close(self) -> None:
        if self.channel is not None:
            await self.channel.close()
            self.channel = None
        if self.process is not None:
            process, self.process = self.process, None
            process.terminate()
            # off the loop: the wait may take its whole 5 s
            await asyncio.to_thread(_reap, process)

    # raw stub helpers -------------------------------------------------------

    def stream_stream(self, name: str, req_type, resp_type):
        assert self.channel is not None
        return self.channel.stream_stream(
            method(name),
            request_serializer=req_type.SerializeToString,
            response_deserializer=resp_type.FromString,
        )

    async def agent_info(self) -> dict[str, Any]:
        assert self.channel is not None
        stub = self.channel.unary_unary(
            method("agent_info"),
            request_serializer=pb.InfoRequest.SerializeToString,
            response_deserializer=pb.InfoResponse.FromString,
        )
        response = await stub(pb.InfoRequest())
        return json.loads(response.json_info)


def _reap(process: subprocess.Popen) -> None:
    """Wait up to 5 s for a terminated child, then kill it."""
    try:
        process.wait(timeout=5)
    except subprocess.TimeoutExpired:
        process.kill()
        process.wait()


class _GrpcAgentBase:
    def __init__(self) -> None:
        self.server: Optional[PythonGrpcServer] = None
        # per-stream schema interning; reset whenever a stream is recreated
        # (the peer's table dies with its stream/process)
        self.codec = SchemaCodec()

    async def init(self, configuration: dict[str, Any]) -> None:
        class_name = configuration.get("className") or configuration.get("class-name")
        if not class_name:
            raise ValueError("python agents require configuration.className")
        python_path = configuration.get("pythonPath") or configuration.get("python-path")
        if python_path is None and self.context is not None:
            # default: the app package's python/ dir (reference PYTHONPATH
            # injection, PythonGrpcServer.java:61-76)
            code_dir = self.context.get_code_directory()
            if code_dir:
                candidate = os.path.join(code_dir, "python")
                if os.path.isdir(candidate):
                    python_path = candidate
        self.server = PythonGrpcServer(
            class_name,
            configuration.get("configuration", configuration),
            python_path=python_path,
            agent_id=getattr(self, "agent_id", ""),
            agent_type=getattr(self, "agent_type", ""),
        )

    async def start(self) -> None:
        assert self.server is not None
        await self.server.start()

    async def close(self) -> None:
        if self.server is not None:
            await self.server.close()

    def agent_info(self) -> dict[str, Any]:
        info = super().agent_info()  # type: ignore[misc]
        info["subprocess"] = {
            "alive": self.server.alive() if self.server else False,
            "port": self.server.port if self.server else 0,
        }
        return info


class GrpcAgentProcessor(_GrpcAgentBase, AgentProcessor):
    """Forwards batches over the bidi ``process`` stream, correlating
    responses by record_id (reference GrpcAgentProcessor.java:31)."""

    def __init__(self) -> None:
        _GrpcAgentBase.__init__(self)
        AgentProcessor.__init__(self)
        self._next_id = 0
        self._call = None
        self._lock = asyncio.Lock()

    async def _ensure_stream(self) -> None:
        assert self.server is not None
        await self.server.ensure_running()
        if self._call is None:
            stub = self.server.stream_stream("process", pb.ProcessorRequest, pb.ProcessorResponse)
            self._call = stub()
            self.codec.reset()

    async def process(self, records: list[Record]) -> list[ProcessorResult]:
        async with self._lock:  # one in-flight batch per stream
            try:
                return await self._process_once(records)
            except grpc.aio.AioRpcError as e:
                # subprocess crash mid-batch: restart once, fail the batch so
                # the errors policy decides (at-least-once redelivery)
                log.warning("process stream failed (%s); restarting subprocess", e.code())
                self._call = None
                assert self.server is not None
                await self.server.ensure_running()
                return [ProcessorResult.failed(r, e) for r in records]

    async def _process_once(self, records: list[Record]) -> list[ProcessorResult]:
        await self._ensure_stream()
        assert self._call is not None
        by_id: dict[int, Record] = {}
        out = []
        schemas: list[pb.Schema] = []
        for record in records:
            self._next_id += 1
            by_id[self._next_id] = record
            out.append(self.codec.to_grpc_record(record, self._next_id, schemas))
        await self._call.write(pb.ProcessorRequest(records=out, schemas=schemas))
        results: dict[int, ProcessorResult] = {}
        while len(results) < len(by_id):
            response = await self._call.read()
            if response is grpc.aio.EOF:
                raise grpc.aio.AioRpcError(
                    grpc.StatusCode.UNAVAILABLE,
                    initial_metadata=grpc.aio.Metadata(),
                    trailing_metadata=grpc.aio.Metadata(),
                    details="process stream closed by agent",
                )
            self.codec.register(response.schemas)
            for result in response.results:
                source = by_id.get(result.record_id)
                if source is None:
                    continue
                if result.HasField("error"):
                    results[result.record_id] = ProcessorResult.failed(
                        source, RuntimeError(result.error)
                    )
                else:
                    results[result.record_id] = ProcessorResult.ok(
                        source, [self.codec.from_grpc_record(m) for m in result.records]
                    )
        self.processed(len(records))
        return [results[rid] for rid in by_id]


class GrpcAgentSource(_GrpcAgentBase, AgentSource):
    def __init__(self) -> None:
        _GrpcAgentBase.__init__(self)
        AgentSource.__init__(self)
        self._call = None
        self._ids: dict[int, int] = {}  # id(record) → record_id
        self._pending: "Optional[asyncio.Task]" = None

    async def _ensure_stream(self) -> None:
        assert self.server is not None
        await self.server.ensure_running()
        if self._call is None:
            stub = self.server.stream_stream("read", pb.SourceRequest, pb.SourceResponse)
            self._call = stub()
            self.codec.reset()

    async def read(self) -> list[Record]:
        await self._ensure_stream()
        assert self._call is not None
        try:
            response = await self._call.read()
        except grpc.aio.AioRpcError:
            self._call = None
            return []
        if response is grpc.aio.EOF:
            self._call = None
            return []
        self.codec.register(response.schemas)
        records = []
        for message in response.records:
            record = self.codec.from_grpc_record(message)
            self._ids[id(record)] = message.record_id
            records.append(record)
        return records

    async def commit(self, records: list[Record]) -> None:
        if self._call is None:
            return
        ids = [self._ids.pop(id(r)) for r in records if id(r) in self._ids]
        if ids:
            await self._call.write(pb.SourceRequest(committed_records=ids))

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        if self._call is None:
            raise error
        rid = self._ids.pop(id(record), None)
        if rid is None:
            raise error
        await self._call.write(
            pb.SourceRequest(
                permanent_failure=pb.PermanentFailure(
                    record_id=rid, error_message=str(error)
                )
            )
        )


class GrpcAgentSink(_GrpcAgentBase, AgentSink):
    def __init__(self) -> None:
        _GrpcAgentBase.__init__(self)
        AgentSink.__init__(self)
        self._call = None
        self._next_id = 0
        self._lock = asyncio.Lock()

    async def _ensure_stream(self) -> None:
        assert self.server is not None
        await self.server.ensure_running()
        if self._call is None:
            stub = self.server.stream_stream("write", pb.SinkRequest, pb.SinkResponse)
            self._call = stub()
            self.codec.reset()

    async def write(self, record: Record) -> None:
        async with self._lock:
            await self._ensure_stream()
            assert self._call is not None
            self._next_id += 1
            try:
                schemas: list[pb.Schema] = []
                grpc_record = self.codec.to_grpc_record(record, self._next_id, schemas)
                await self._call.write(
                    pb.SinkRequest(record=grpc_record, schemas=schemas)
                )
                response = await self._call.read()
            except grpc.aio.AioRpcError as e:
                # subprocess crash: drop the dead stream, restart, and let
                # the errors policy retry the record
                self._call = None
                assert self.server is not None
                await self.server.ensure_running()
                raise RuntimeError(f"sink subprocess failed: {e.code()}") from e
            if response is grpc.aio.EOF:
                self._call = None
                raise RuntimeError("sink stream closed by agent")
            if response.HasField("error"):
                raise RuntimeError(response.error)


class GrpcAgentService(_GrpcAgentBase, AgentService):
    """Long-running service agent in a subprocess; join() = wait for exit."""

    def __init__(self) -> None:
        _GrpcAgentBase.__init__(self)
        AgentService.__init__(self)

    async def join(self) -> None:
        assert self.server is not None
        while self.server.alive():
            await asyncio.sleep(0.5)
        rc = self.server.process.returncode if self.server.process else -1
        if rc not in (0, None):
            raise RuntimeError(f"python service agent exited with rc={rc}")
