"""Deploy orchestration: plan → setup (assets) → deploy → delete → cleanup.

Parity: reference `impl/deploy/ApplicationDeployer.java:57 (createImplementation),
:85 (setup), :146 (deploy), :169 (delete), :190 (cleanup)`.
"""

from __future__ import annotations

import logging

from langstream_tpu_torch.api.model import Application
from langstream_tpu_torch.api.planner import ComputeClusterRuntime, ExecutionPlan
from langstream_tpu_torch.core.registry import REGISTRY
from langstream_tpu_torch.core.resolver import resolve_placeholders

log = logging.getLogger(__name__)


class ApplicationDeployer:
    def __init__(
        self,
        compute_runtime: ComputeClusterRuntime,
        topic_admin_factory=None,
    ) -> None:
        self.compute_runtime = compute_runtime
        self.topic_admin_factory = topic_admin_factory

    def create_implementation(
        self, application_id: str, application: Application, resolve: bool = True
    ) -> ExecutionPlan:
        app = resolve_placeholders(application) if resolve else application
        return self.compute_runtime.build_execution_plan(application_id, app)

    async def setup(self, plan: ExecutionPlan) -> None:
        """Create declarative assets (reference ApplicationSetupRunner.runSetup).

        An asset's ``datasource`` may name a `configuration.resources` entry
        (the reference's convention) — resolve it to that resource's
        configuration before the manager sees it."""
        import dataclasses

        for asset in plan.assets:
            info = REGISTRY.asset(asset.asset_type)
            if info is None:
                log.warning("no asset manager for type %s; skipping", asset.asset_type)
                continue
            ds_ref = asset.config.get("datasource")
            if isinstance(ds_ref, str) and plan.application is not None:
                resource = plan.application.resources.get(ds_ref) or next(
                    (
                        r
                        for r in plan.application.resources.values()
                        if r.name == ds_ref
                    ),
                    None,
                )
                if resource is None:
                    raise ValueError(
                        f"asset {asset.id!r} references unknown datasource "
                        f"resource {ds_ref!r}"
                    )
                asset = dataclasses.replace(
                    asset,
                    config={**asset.config, "datasource": dict(resource.configuration)},
                )
            manager = info.factory()
            await manager.initialize(asset)
            try:
                if asset.creation_mode == "create-if-not-exists":
                    if not await manager.asset_exists():
                        log.info("creating asset %s (%s)", asset.id, asset.asset_type)
                        await manager.deploy_asset()
            finally:
                await manager.close()

    async def deploy_topics(self, plan: ExecutionPlan) -> None:
        if self.topic_admin_factory is None:
            return
        admin = self.topic_admin_factory()
        await admin.start()
        try:
            for topic in plan.topics.values():
                if topic.creation_mode == "create-if-not-exists":
                    if not await admin.topic_exists(topic.name):
                        await admin.create_topic(
                            topic.name, max(topic.partitions, 1), topic.options
                        )
        finally:
            await admin.close()

    async def deploy(self, plan: ExecutionPlan) -> None:
        await self.deploy_topics(plan)
        await self.compute_runtime.deploy(plan)

    async def delete(self, plan: ExecutionPlan) -> None:
        await self.compute_runtime.delete(plan)

    async def cleanup(self, plan: ExecutionPlan) -> None:
        """Drop assets + implicit topics with deletion-mode=delete."""
        for asset in plan.assets:
            if asset.deletion_mode != "delete":
                continue
            info = REGISTRY.asset(asset.asset_type)
            if info is None:
                continue
            manager = info.factory()
            await manager.initialize(asset)
            try:
                if await manager.asset_exists():
                    await manager.delete_asset()
            finally:
                await manager.close()
        if self.topic_admin_factory is not None:
            admin = self.topic_admin_factory()
            await admin.start()
            try:
                for topic in plan.topics.values():
                    if topic.deletion_mode == "delete" and await admin.topic_exists(topic.name):
                        await admin.delete_topic(topic.name)
            finally:
                await admin.close()
