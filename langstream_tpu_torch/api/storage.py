"""Storage contracts of the agents: the asset manager, the vector-db-sink
writer and the queryable datasource — the port's copy of
``AssetManager``, ``VectorDatabaseWriter`` and ``DataSource`` in
``langstream_tpu/api/storage.py`` (reference ``AssetManager.java``,
``VectorDatabaseWriterProvider.java``, ``DataSourceProvider``).

The application store, the global metadata store and the code storage of
that module belong to the control plane, which the port does not serve.
"""

from __future__ import annotations

import abc
from typing import Any


class AssetManager(abc.ABC):
    """Declarative infra asset lifecycle (reference AssetManager.java)."""

    async def initialize(self, asset) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def asset_exists(self) -> bool: ...

    @abc.abstractmethod
    async def deploy_asset(self) -> None: ...

    @abc.abstractmethod
    async def delete_asset(self) -> None: ...

    async def close(self) -> None:  # noqa: B027
        pass


class VectorDatabaseWriter(abc.ABC):
    """Reference api/database/VectorDatabaseWriter — used by vector-db-sink."""

    async def init(self, config: dict[str, Any]) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def upsert(self, record: Any, context: dict[str, Any]) -> None: ...

    async def close(self) -> None:  # noqa: B027
        pass


class DataSource(abc.ABC):
    """Queryable datasource (vector or SQL) resolved from a
    ``configuration.resources`` datasource entry, as the ``query`` /
    ``query-vector-db`` agents use it."""

    async def init(self, config: dict[str, Any]) -> None:  # noqa: B027
        pass

    @abc.abstractmethod
    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]: ...

    async def execute_statement(self, query: str, params: list[Any]) -> dict[str, Any]:
        """DML path (`mode: execute`); returns e.g. generated keys."""
        raise NotImplementedError("this datasource is read-only")

    async def close(self) -> None:  # noqa: B027
        pass
