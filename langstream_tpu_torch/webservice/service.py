"""Application / tenant services: parse → validate → store → deploy (the
port's own copy of ``langstream_tpu/webservice/service.py``).

Parity: reference ``langstream-webservice`` ``ApplicationService`` (parse +
resolve placeholders + validate via ApplicationDeployer.createImplementation,
then store and hand off to the deployer) and ``TenantService``; the local
runtime manager plays the role the K8s operator plays in production
(reference runtime-tester LocalApplicationRunner threads).

An update deletes the running app before it deploys the new one: the old
runner's provider closes (its engine drains and stops, its weight tree is
released) before the new provider draws its own. A delete then collects
garbage on a worker thread, under the serving engine's capture lock (a
collection during another engine's graph capture would destroy that
engine's graphs), so the old tree and engine are gone before the next
deploy allocates.
"""

from __future__ import annotations

import asyncio
import gc
import io
import logging
import sys
import zipfile
from pathlib import PurePosixPath
from typing import Any, Optional, Protocol

from langstream_tpu_torch.api.storage import (
    ApplicationStore,
    CodeStorage,
    GlobalMetadataStore,
    StoredApplication,
)
from langstream_tpu_torch.core.parser import ModelBuilder, ModelParseError
from langstream_tpu_torch.core.planner import ClusterRuntime
from langstream_tpu_torch.core.resolver import resolve_placeholders
from langstream_tpu_torch.webservice.stores import (
    InMemoryApplicationStore,
    LocalDiskApplicationStore,
)

log = logging.getLogger(__name__)


class RuntimeManager(Protocol):
    """What actually runs deployed applications. Local mode = in-process
    agent runners; kubernetes mode = CRs reconciled by the operator."""

    async def deploy_application(
        self, tenant: str, application_id: str, stored: StoredApplication
    ) -> None: ...

    async def delete_application(self, tenant: str, application_id: str) -> None: ...

    def application_status(self, tenant: str, application_id: str) -> dict[str, Any]: ...

    def application_logs(self, tenant: str, application_id: str) -> list[str]: ...


class LocalRuntimeManager:
    """Runs each deployed app as an in-process LocalApplicationRunner
    (reference LocalApplicationRunner.executeAgentRunners:175)."""

    def __init__(self) -> None:
        self._runners: dict[tuple[str, str], Any] = {}
        self._gateways: dict[tuple[str, str], Any] = {}

    async def deploy_application(
        self, tenant: str, application_id: str, stored: StoredApplication
    ) -> None:
        from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

        await self.delete_application(tenant, application_id)
        runner = LocalApplicationRunner(application_id, stored.application, tenant=tenant)
        try:
            await runner.deploy()
            await runner.start()
        except BaseException:
            # a provider that could not be built (no card, a bad key) must
            # not leave the runners that were built running
            await runner.stop(drain=False)
            raise
        self._runners[(tenant, application_id)] = runner

    async def delete_application(self, tenant: str, application_id: str) -> None:
        runner = self._runners.pop((tenant, application_id), None)
        if runner is not None:
            try:
                await runner.stop()
            finally:
                del runner
                await asyncio.to_thread(_collect)

    def get_runner(self, tenant: str, application_id: str) -> Optional[Any]:
        return self._runners.get((tenant, application_id))

    def application_status(self, tenant: str, application_id: str) -> dict[str, Any]:
        runner = self._runners.get((tenant, application_id))
        if runner is None:
            return {"status": "UNKNOWN"}
        agents = runner.agents_info()
        return {"status": "DEPLOYED", "agents": agents}

    def application_logs(self, tenant: str, application_id: str) -> list[str]:
        runner = self._runners.get((tenant, application_id))
        if runner is None:
            return []
        lines = [
            f"{info.get('agent-id', '?')}: {info}" for info in runner.agents_info()
        ]
        lines += [
            f"{e['replica']}: {e['message']}" for e in runner.log_hub.history()
        ]
        return lines

    def application_log_hub(self, tenant: str, application_id: str):
        """The app's live LogHub, or None (non-local runtimes stream from
        their own pod-log source instead)."""
        runner = self._runners.get((tenant, application_id))
        return None if runner is None else runner.log_hub

    async def close(self) -> None:
        for key in list(self._runners):
            await self.delete_application(*key)


def _collect() -> None:
    """``gc.collect()`` under the serving engine's capture lock (when the
    engine module is loaded at all): a stopped app's runner, provider and
    engine sit in reference cycles, and a collection while another engine
    captures its graphs would destroy that engine's graphs."""
    engine = sys.modules.get("langstream_tpu_torch.serving.engine")
    if engine is None:
        gc.collect()
        return
    with engine._CAPTURE_LOCK:
        gc.collect()


class ApplicationServiceError(Exception):
    def __init__(self, message: str, status: int = 400) -> None:
        super().__init__(message)
        self.status = status


def extract_package_from_zip(archive_bytes: bytes) -> dict[str, str]:
    """App zip → {relative path: text} for YAML/py/text package files."""
    try:
        zf = zipfile.ZipFile(io.BytesIO(archive_bytes))
    except zipfile.BadZipFile as e:
        raise ApplicationServiceError(f"invalid zip archive: {e}") from e
    files: dict[str, str] = {}
    for info in zf.infolist():
        if info.is_dir():
            continue
        name = PurePosixPath(info.filename)
        if name.is_absolute() or ".." in name.parts:
            raise ApplicationServiceError(f"archive path escapes package: {info.filename}")
        try:
            files[str(name)] = zf.read(info).decode("utf-8")
        except UnicodeDecodeError:
            # binary assets (models, images) are carried by code storage, not
            # parsed as pipeline documents
            continue
    return files


class ApplicationService:
    def __init__(
        self,
        store: ApplicationStore,
        code_storage: Optional[CodeStorage] = None,
        runtime: Optional[RuntimeManager] = None,
    ) -> None:
        self.store = store
        self.code_storage = code_storage
        self.runtime = runtime
        self._lock = asyncio.Lock()

    # -- deploy/update -------------------------------------------------------

    async def deploy(
        self,
        tenant: str,
        application_id: str,
        archive_bytes: Optional[bytes],
        instance_text: Optional[str],
        secrets_text: Optional[str],
        *,
        allow_update: bool = False,
        dry_run: bool = False,
    ) -> dict[str, Any]:
        async with self._lock:
            existing = self.store.get(tenant, application_id)
            if existing is not None and not allow_update:
                raise ApplicationServiceError(
                    f"application {application_id} already exists", status=409
                )
            if existing is None and allow_update:
                raise ApplicationServiceError(
                    f"application {application_id} not found", status=404
                )

            if archive_bytes is None:
                raise ApplicationServiceError("application package is required")
            all_files = extract_package_from_zip(archive_bytes)
            # an update that omits instance/secrets keeps the stored ones
            # (otherwise the redeployed app would silently lose its
            # environment while the store kept the stale documents)
            if existing is not None and hasattr(self.store, "get_raw_documents"):
                stored_instance, stored_secrets = self.store.get_raw_documents(
                    tenant, application_id
                )
                if instance_text is None:
                    instance_text = stored_instance
                if secrets_text is None:
                    secrets_text = stored_secrets
            from langstream_tpu_torch.core.parser import is_pipeline_document

            yaml_files = {
                rel: text
                for rel, text in all_files.items()
                if is_pipeline_document(rel)
            }
            try:
                pkg = ModelBuilder.build_application_from_files(
                    yaml_files, instance_text, secrets_text
                )
            except ModelParseError as e:
                raise ApplicationServiceError(str(e)) from e

            # validate: placeholders must resolve and the app must plan
            try:
                resolved = resolve_placeholders(pkg.application)
                plan = ClusterRuntime().build_execution_plan(application_id, resolved)
            except ValueError as e:  # ModelParseError / UnknownAgentType / PlaceholderError
                raise ApplicationServiceError(str(e)) from e

            if dry_run:
                return {
                    "application-id": application_id,
                    "dry-run": True,
                    "agents": [n.id for n in plan.agent_sequence()],
                    "topics": sorted(plan.topics),
                }

            code_archive_id = None
            if self.code_storage is not None:
                # storage may be remote (S3): keep its blocking I/O off the
                # event loop, which also serves the archive endpoints
                meta = await asyncio.to_thread(
                    self.code_storage.store, tenant, application_id, archive_bytes
                )
                code_archive_id = meta.code_store_id
                if (
                    existing is not None
                    and existing.code_archive_id
                    and existing.code_archive_id != code_archive_id
                ):
                    try:
                        await asyncio.to_thread(
                            self.code_storage.delete, tenant, existing.code_archive_id
                        )
                    except Exception:  # noqa: BLE001
                        log.exception("failed to delete superseded code archive")

            if hasattr(self.store, "put_package"):
                stored = self.store.put_package(
                    tenant,
                    application_id,
                    all_files,  # full package: python/ user code travels too
                    instance_text,
                    secrets_text,
                    code_archive_id,
                )
            else:
                self.store.put(tenant, application_id, pkg.application, code_archive_id)
                stored = self.store.get(tenant, application_id)
                assert stored is not None

            if self.runtime is not None:
                resolved.code_directory = self._materialize_code_dir(
                    tenant, application_id, all_files
                )
                resolved_stored = StoredApplication(
                    application_id=application_id,
                    application=resolved,
                    code_archive_id=code_archive_id,
                    status=stored.status,
                )
                await self.runtime.deploy_application(tenant, application_id, resolved_stored)
            return {"application-id": application_id, "code-archive-id": code_archive_id}

    @classmethod
    def _code_dir_root(cls, tenant: str, application_id: str) -> "Path":
        import tempfile
        from pathlib import Path

        # the JAX package materialises under "langstream-tpu-code": a name
        # of its own keeps the two packages' apps of one name apart
        base = Path(tempfile.gettempdir()) / "langstream-tpu-torch-code"
        root = (base / tenant / application_id).resolve()
        # names are validated at the API layer; this is defense in depth
        # against traversal via crafted tenant/app ids
        if not root.is_relative_to(base.resolve()) or root == base.resolve():
            raise ApplicationServiceError("invalid tenant/application name")
        return root

    @classmethod
    def _materialize_code_dir(
        cls, tenant: str, application_id: str, files: dict[str, str]
    ) -> str:
        """Write the package to a stable on-disk dir so python-agent
        subprocesses can import from <dir>/python (the code-download
        init-container's job in the reference)."""
        import shutil

        root = cls._code_dir_root(tenant, application_id)
        if root.exists():
            shutil.rmtree(root)
        for rel, text in files.items():
            target = (root / rel).resolve()
            if not target.is_relative_to(root):
                raise ApplicationServiceError(f"package path escapes the package: {rel}")
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(text)
        return str(root)

    async def delete(self, tenant: str, application_id: str) -> None:
        async with self._lock:
            stored = self.store.get(tenant, application_id)
            if stored is None:
                raise ApplicationServiceError(
                    f"application {application_id} not found", status=404
                )
            if self.runtime is not None:
                await self.runtime.delete_application(tenant, application_id)
            if self.code_storage is not None and stored.code_archive_id:
                try:
                    await asyncio.to_thread(
                        self.code_storage.delete, tenant, stored.code_archive_id
                    )
                except Exception:  # noqa: BLE001
                    log.exception("failed to delete code archive")
            self.store.delete(tenant, application_id)
            # remove the materialized user-code dir (it can hold credentials)
            try:
                import shutil

                root = self._code_dir_root(tenant, application_id)
                if root.exists():
                    shutil.rmtree(root)
            except Exception:  # noqa: BLE001
                log.exception("failed to remove materialized code dir")

    # -- read ---------------------------------------------------------------

    def describe(self, tenant: str, application_id: str) -> dict[str, Any]:
        stored = self.store.get(tenant, application_id)
        if stored is None:
            raise ApplicationServiceError(
                f"application {application_id} not found", status=404
            )
        app = stored.application
        agents = [
            {
                "id": a.id or a.name,
                "type": a.type,
                "input": a.input,
                "output": a.output,
            }
            for a in app.all_agents()
        ]
        status = (
            self.runtime.application_status(tenant, application_id)
            if self.runtime is not None
            else {}
        )
        return {
            "application-id": application_id,
            "agents": agents,
            "topics": [
                t.name for m in app.modules.values() for t in m.topics.values()
            ],
            "gateways": [
                {"id": g.id, "type": g.type, "parameters": list(g.parameters)}
                for g in app.gateways
            ],
            "code-archive-id": stored.code_archive_id,
            "status": status,
        }

    def list(self, tenant: str) -> list[dict[str, Any]]:
        return [
            {"application-id": app_id, "code-archive-id": stored.code_archive_id}
            for app_id, stored in sorted(self.store.list(tenant).items())
        ]

    def logs(self, tenant: str, application_id: str) -> list[str]:
        if self.store.get(tenant, application_id) is None:
            raise ApplicationServiceError(
                f"application {application_id} not found", status=404
            )
        if self.runtime is None:
            return []
        return self.runtime.application_logs(tenant, application_id)

    def log_hub(self, tenant: str, application_id: str):
        """Live log hub for streaming follow, when the runtime offers one."""
        if self.store.get(tenant, application_id) is None:
            raise ApplicationServiceError(
                f"application {application_id} not found", status=404
            )
        getter = getattr(self.runtime, "application_log_hub", None)
        return None if getter is None else getter(tenant, application_id)

    def download_code(self, tenant: str, application_id: str) -> bytes:
        stored = self.store.get(tenant, application_id)
        if stored is None or not stored.code_archive_id:
            raise ApplicationServiceError(
                f"no code archive for {application_id}", status=404
            )
        assert self.code_storage is not None
        return self.code_storage.download(tenant, stored.code_archive_id)


class TenantService:
    """Tenant CRUD over the global metadata store (reference TenantResource +
    GlobalMetadataStoreManager; keys are ``tenant/<name>``)."""

    PREFIX = "tenant/"

    def __init__(self, metadata: GlobalMetadataStore) -> None:
        self.metadata = metadata

    def put(self, name: str, configuration: Optional[dict[str, Any]] = None) -> None:
        import json

        self.metadata.put(self.PREFIX + name, json.dumps(configuration or {"name": name}))

    def get(self, name: str) -> Optional[dict[str, Any]]:
        import json

        raw = self.metadata.get(self.PREFIX + name)
        return None if raw is None else json.loads(raw)

    def delete(self, name: str) -> None:
        self.metadata.delete(self.PREFIX + name)

    def list(self) -> dict[str, dict[str, Any]]:
        import json

        return {
            key[len(self.PREFIX) :]: json.loads(value)
            for key, value in self.metadata.list().items()
            if key.startswith(self.PREFIX)
        }

    def exists(self, name: str) -> bool:
        return self.metadata.get(self.PREFIX + name) is not None


def make_local_service(
    root: Optional[str] = None,
    code_storage: Optional[CodeStorage] = None,
) -> tuple[ApplicationService, TenantService, LocalRuntimeManager]:
    """Wire a fully local control plane: disk or memory stores + in-process
    runtime (the `langstream docker run` topology, one process).
    ``code_storage`` overrides the default disk/memory archive store (e.g.
    S3CodeStorage from the ``codeStorage`` config block)."""
    from langstream_tpu_torch.webservice.stores import (
        InMemoryCodeStorage,
        InMemoryGlobalMetadataStore,
        LocalDiskCodeStorage,
        LocalDiskGlobalMetadataStore,
    )

    runtime = LocalRuntimeManager()
    if root is None:
        store: ApplicationStore = InMemoryApplicationStore()
        code: Optional[CodeStorage] = code_storage or InMemoryCodeStorage()
        tenants = TenantService(InMemoryGlobalMetadataStore())
    else:
        store = LocalDiskApplicationStore(f"{root}/apps")
        code = code_storage or LocalDiskCodeStorage(f"{root}/code")
        tenants = TenantService(LocalDiskGlobalMetadataStore(root))
    tenants.put("default")
    return ApplicationService(store, code, runtime), tenants, runtime
