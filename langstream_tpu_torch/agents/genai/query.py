"""`query` step — run a parameterised query against a datasource resource.

Parity: reference `QueryStep.java` + `QueryConfiguration.java` — `fields`
are expressions evaluated per record into query params, results land in
`output-field` (list of rows, or the first row with `only-first`),
`loop-over` iterates sub-documents, `mode: execute` runs DML and stores
`generated-keys`.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.agents.genai import el
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.agents.genai.steps import Step


class QueryStep(Step):
    def __init__(self, config: dict[str, Any]) -> None:
        super().__init__(config)
        self.query = config.get("query", "")
        self.fields = config.get("fields", [])
        self.output_field = config.get("output-field", "value.query-result")
        self.only_first = bool(config.get("only-first", False))
        self.loop_over = config.get("loop-over")
        self.mode = config.get("mode", "query")
        self.datasource_name = config.get("datasource")
        self._datasource = None

    async def start(self, context: Any) -> None:
        registry = context.get_service_provider_registry()
        self._datasource = registry.get_datasource(self.datasource_name)

    def _params(self, record: MutableRecord, extra: dict | None = None) -> list[Any]:
        return [el.evaluate(f, record, extra) for f in self.fields]

    async def _run(self, record: MutableRecord, extra: dict | None = None) -> Any:
        params = self._params(record, extra)
        if self.mode == "execute":
            return await self._datasource.execute_statement(self.query, params)
        rows = await self._datasource.fetch_data(self.query, params)
        if self.only_first:
            return rows[0] if rows else None
        return rows

    async def process(self, record: MutableRecord, context: Any) -> None:
        assert self._datasource is not None, "step not started"
        if self.loop_over:
            items = el.evaluate(self.loop_over, record) or []
            field = self.output_field
            if field.startswith("record."):
                field = field[len("record."):]
            for item in items:
                result = await self._run(record, extra={"record": item})
                if isinstance(item, dict):
                    item[field] = result
        else:
            record.set_field(self.output_field, await self._run(record))
