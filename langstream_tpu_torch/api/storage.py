"""Storage contracts (the port's own copy of
``langstream_tpu/api/storage.py``): the control plane's application store,
global metadata store and code storage (reference ``ApplicationStore.java``,
``GlobalMetadataStore.java``, ``CodeStorage.java``), and the agents' asset
manager, vector-db-sink writer and queryable datasource (reference
``AssetManager.java``, ``VectorDatabaseWriterProvider.java``,
``DataSourceProvider``).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Optional

from langstream_tpu_torch.api.model import Application, Secrets


@dataclass
class StoredApplication:
    application_id: str
    application: Application
    code_archive_id: Optional[str] = None
    status: dict[str, Any] = field(default_factory=dict)


class ApplicationStore(abc.ABC):
    @abc.abstractmethod
    def put(
        self,
        tenant: str,
        application_id: str,
        application: Application,
        code_archive_id: Optional[str],
    ) -> None: ...

    @abc.abstractmethod
    def get(self, tenant: str, application_id: str) -> Optional[StoredApplication]: ...

    @abc.abstractmethod
    def delete(self, tenant: str, application_id: str) -> None: ...

    @abc.abstractmethod
    def list(self, tenant: str) -> dict[str, StoredApplication]: ...

    def get_secrets(self, tenant: str, application_id: str) -> Optional[Secrets]:
        return None


class GlobalMetadataStore(abc.ABC):
    @abc.abstractmethod
    def put(self, key: str, value: str) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @abc.abstractmethod
    def list(self) -> dict[str, str]: ...


@dataclass
class CodeArchiveMetadata:
    tenant: str
    code_store_id: str
    application_id: str
    digests: dict[str, str] = field(default_factory=dict)


class CodeStorage(abc.ABC):
    """App code archives (reference CodeStorage.java; S3CodeStorage impl)."""

    @abc.abstractmethod
    def store(self, tenant: str, application_id: str, archive_bytes: bytes) -> CodeArchiveMetadata: ...

    @abc.abstractmethod
    def download(self, tenant: str, code_store_id: str) -> bytes: ...

    @abc.abstractmethod
    def delete(self, tenant: str, code_store_id: str) -> None: ...


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
