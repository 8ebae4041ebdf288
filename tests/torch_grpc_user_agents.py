"""User agents that the port's gRPC tests load IN A CHILD PROCESS (through
``pythonPath``). Written against the SDK's module paths
(``langstream_tpu.api...``), as user code is: the JAX package's child runs
them on its own SDK, the port's child on the port's SDK through its alias
finder."""

import importlib
import json
import os
import sys
from typing import Any

from langstream_tpu.api.agent import AgentCode, AgentSource, SingleRecordProcessor
from langstream_tpu.api.avro import AvroValue
from langstream_tpu.api.record import Record, SimpleRecord


class Mixed(SingleRecordProcessor):
    """An Avro record gets its ``age`` bumped under the same schema;
    "explode" fails; anything else gets the configured suffix."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.suffix = configuration.get("suffix", "!")

    async def process_record(self, record: Record) -> list[Record]:
        value = record.value
        if isinstance(value, AvroValue):
            data = dict(value.data)
            data["age"] = data["age"] + 1
            return [SimpleRecord.of(AvroValue(value.schema, data), key=record.key,
                                    headers=record.headers, timestamp=1.0)]
        if value == "explode":
            raise ValueError("asked to explode")
        return [SimpleRecord.of(f"{value}{self.suffix}", key=record.key,
                                headers=record.headers, timestamp=1.0)]


class RecordingSource(AgentSource):
    """Emits ``limit`` records one a read; commits and permanent failures
    are appended to the ``log`` file, one line each."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.limit = int(configuration.get("limit", 3))
        self.log = configuration["log"]
        self.sent = 0

    async def read(self) -> list[Record]:
        if self.sent >= self.limit:
            import asyncio

            await asyncio.sleep(0.02)
            return []
        self.sent += 1
        return [SimpleRecord.of(f"item-{self.sent}", key=f"k{self.sent}",
                                headers=[("n", self.sent)], timestamp=2.0)]

    def _write(self, line: str) -> None:
        with open(self.log, "a") as f:
            f.write(line + "\n")

    async def commit(self, records: list[Record]) -> None:
        for r in records:
            self._write(f"commit {r.value}")

    async def permanent_failure(self, record: Record, error: BaseException) -> None:
        self._write(f"failure {record.value}: {type(error).__name__}: {error}")


class ModuleProbe(SingleRecordProcessor):
    """Imports ``modules`` (after putting ``paths`` on ``sys.path``) when
    it starts; each record answers with what the process has loaded: the
    modules whose file lies under ``jax-package`` (a directory), whether
    torch is loaded, the SDK's module and the card's visibility."""

    async def init(self, configuration: dict[str, Any]) -> None:
        for path in configuration.get("paths", []):
            sys.path.insert(0, path)
        for name in configuration.get("modules", []):
            importlib.import_module(name)
        self.jax_package = os.path.realpath(configuration["jax-package"]) + os.sep

    async def process_record(self, record: Record) -> list[Record]:
        files = {name: getattr(module, "__file__", None)
                 for name, module in list(sys.modules.items())}
        loaded = sorted(name for name, f in files.items()
                        if f and os.path.realpath(f).startswith(self.jax_package))
        report = {
            "jax_package_modules": loaded,
            "torch": "torch" in sys.modules,
            "sdk": AgentCode.__module__,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(),
        }
        return [SimpleRecord.of(json.dumps(report), timestamp=3.0)]
