"""GenAI toolkit transform steps: compute, cast, drop, drop-fields, flatten,
merge-key-value, unwrap-key-value.

Parity: reference step implementations behind
`GenAIToolKitFunctionAgentProvider.java:53-85` (planner-side types) and the
ai-agents step classes; behavior follows the documented semantics, expressed
over our MutableRecord/EL instead of the Java transform library.
Every step honours the base-config `when` condition
(BaseGenAIStepConfiguration.java:36).
"""

from __future__ import annotations

import abc
from typing import Any, Optional

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord


class Step(abc.ABC):
    """One transform applied in-place to a MutableRecord."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.config = config
        self.when: Optional[str] = config.get("when")

    def applies(self, record: MutableRecord) -> bool:
        if not self.when:
            return True
        return el.evaluate_bool(self.when, record)

    async def apply(self, record: MutableRecord, context: Any) -> None:
        if self.applies(record):
            await self.process(record, context)

    @abc.abstractmethod
    async def process(self, record: MutableRecord, context: Any) -> None: ...

    async def start(self, context: Any) -> None:  # noqa: B027
        pass

    async def close(self) -> None:  # noqa: B027
        pass


def _cast_scalar(val: Any, type_: str) -> Any:
    if val is None:
        return None
    t = type_.upper()
    if t in ("STRING", "TEXT"):
        return el._to_str(val)
    if t in ("INT8", "INT16", "INT32", "INT64", "INT", "LONG"):
        return int(float(val))
    if t in ("FLOAT", "DOUBLE"):
        return float(val)
    if t in ("BOOLEAN", "BOOL"):
        if isinstance(val, str):
            return val.strip().lower() in ("true", "1", "yes")
        return bool(val)
    if t == "BYTES":
        return el._to_str(val).encode()
    if t in ("ARRAY", "LIST"):
        return list(val) if not isinstance(val, list) else val
    if t in ("DATE", "TIMESTAMP", "DATETIME", "TIME", "INSTANT", "LOCAL_DATE", "LOCAL_TIME", "LOCAL_DATE_TIME"):
        return val  # stored as-is; serialisation formats them
    raise ValueError(f"unknown cast type {type_!r}")


class ComputeStep(Step):
    """`compute` — evaluate expressions into named fields
    (ComputeConfiguration.java: fields[{name, expression, type, optional}])."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        for f in self.config.get("fields", []):
            name = f["name"]
            expression = f["expression"]
            try:
                val = el.evaluate(expression, record)
            except el.ExpressionError:
                if f.get("optional"):
                    continue
                raise
            type_ = f.get("type")
            if type_:
                val = _cast_scalar(val, type_)
            record.set_field(name, val)


class CastStep(Step):
    """`cast` — convert key/value to `schema-type`."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        schema_type = self.config.get("schema-type", "string")
        part = self.config.get("part")
        if part in (None, "value"):
            record.value = _cast_scalar(record.value, schema_type)
        if part in (None, "key") and record.key is not None:
            record.key = _cast_scalar(record.key, schema_type)


class DropStep(Step):
    """`drop` — discard the record (combined with `when`)."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        record.dropped = True


class DropFieldsStep(Step):
    """`drop-fields` — remove fields from a record part."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        part = self.config.get("part")
        for name in self.config.get("fields", []):
            if "." in name or part is None:
                record.drop_field(name)
            else:
                record.drop_field(f"{part}.{name}")


def _flatten(obj: Any, prefix: str, delimiter: str, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}{delimiter}{k}" if prefix else str(k)
            if isinstance(v, dict):
                _flatten(v, key, delimiter, out)
            else:
                out[key] = v
    else:
        out[prefix] = obj


class FlattenStep(Step):
    """`flatten` — flatten nested structures with a delimiter (default `_`)."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        delimiter = self.config.get("delimiter", "_")
        part = self.config.get("part")
        if part in (None, "value") and isinstance(record.value, dict):
            out: dict = {}
            _flatten(record.value, "", delimiter, out)
            record.value = out
        if part in (None, "key") and isinstance(record.key, dict):
            out = {}
            _flatten(record.key, "", delimiter, out)
            record.key = out


class MergeKeyValueStep(Step):
    """`merge-key-value` — merge the key map into the value map."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        if isinstance(record.key, dict) and isinstance(record.value, dict):
            record.value = {**record.key, **record.value}
            record._value_was_json = True


class UnwrapKeyValueStep(Step):
    """`unwrap-key-value` — replace the record with its value (or key when
    `unwrapKey` is set)."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        unwrap_key = bool(self.config.get("unwrapKey", self.config.get("unwrap-key", False)))
        record.value = record.key if unwrap_key else record.value
        if unwrap_key:
            record.key = None


class DocumentToJsonStep(Step):
    """`document-to-json` — wrap a raw text value into a one-field JSON doc
    (reference text-processing agent `document-to-json`; lives here because
    it is a pure record transform)."""

    async def process(self, record: MutableRecord, context: Any) -> None:
        field_name = self.config.get("text-field", "text")
        copy_props = bool(self.config.get("copy-properties", True))
        doc = {field_name: el._to_str(record.value)}
        if copy_props:
            doc.update(record.properties)
        record.value = doc
        record._value_was_json = True


TRANSFORM_STEPS: dict[str, type[Step]] = {
    "compute": ComputeStep,
    "cast": CastStep,
    "drop": DropStep,
    "drop-fields": DropFieldsStep,
    "flatten": FlattenStep,
    "merge-key-value": MergeKeyValueStep,
    "unwrap-key-value": UnwrapKeyValueStep,
    "document-to-json": DocumentToJsonStep,
}
