"""Generic planner: walks modules/pipelines, detects topics and agents, builds
the ExecutionPlan, fuses adjacent composable agents, creates implicit
intermediate topics for the links that remain.

Parity: reference `impl/common/BasicClusterRuntime.java:50` (detectTopics:83,
detectAgents:122) + `impl/agents/ComposableAgentExecutionPlanOptimiser.java:42
(canMerge), :76 (mergeAgents)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from langstream_tpu_torch.api.model import (
    AgentConfiguration,
    Application,
    Pipeline,
    TopicDefinition,
)
from langstream_tpu_torch.api.planner import (
    AgentNode,
    ComputeClusterRuntime,
    Connection,
    ExecutionPlan,
)
from langstream_tpu_torch.core.registry import REGISTRY
from langstream_tpu_torch.core.validator import validate_application


class PlanError(ValueError):
    pass


def _implicit_topic_name(application_id: str, node_id: str) -> str:
    return f"{application_id}-{node_id}-input"


class ClusterRuntime(ComputeClusterRuntime):
    """The BasicClusterRuntime equivalent; subclassed by local/k8s deployers."""

    def __init__(self, enable_fusion: bool = True) -> None:
        self.enable_fusion = enable_fusion

    def build_execution_plan(
        self, application_id: str, application: Application
    ) -> ExecutionPlan:
        validate_application(application)
        plan = ExecutionPlan(application_id=application_id, application=application)
        self._detect_topics(plan, application)
        plan.assets = list(application.assets)
        self._detect_agents(plan, application)
        self._validate_tpu_meshes(plan)
        return plan

    # -- topics -------------------------------------------------------------

    def _detect_topics(self, plan: ExecutionPlan, application: Application) -> None:
        for module in application.modules.values():
            for topic in module.topics.values():
                plan.register_topic(topic.copy())

    # -- agents -------------------------------------------------------------

    def _detect_agents(self, plan: ExecutionPlan, application: Application) -> None:
        for module in application.modules.values():
            for pipeline in module.pipelines.values():
                self._plan_pipeline(plan, module.id, pipeline)

    def _plan_pipeline(self, plan: ExecutionPlan, module_id: str, pipeline: Pipeline) -> None:
        prev: Optional[AgentNode] = None
        for idx, agent in enumerate(pipeline.agents):
            node = self._build_node(plan, module_id, pipeline, agent, idx)

            if agent.input:
                self._require_topic(plan, agent.input, f"agent '{node.id}' input")
                node.input = Connection.to_topic(agent.input)
            if agent.output:
                self._require_topic(plan, agent.output, f"agent '{node.id}' output")
                node.output = Connection.to_topic(agent.output)

            if prev is not None:
                # wire the implicit link to the previous agent (reference
                # ModelBuilder.java:779-793 always binds a missing input to the
                # previous agent; a half-specified link reuses the explicit side)
                if prev.output is None and node.input is None:
                    # no explicit topic on either side: fuse or implicit topic
                    if self.enable_fusion and self._can_merge(prev, node):
                        prev = self._merge(prev, node)
                        continue
                    topic_name = _implicit_topic_name(plan.application_id, node.id)
                    plan.register_topic(
                        TopicDefinition(
                            name=topic_name,
                            creation_mode="create-if-not-exists",
                            deletion_mode="delete",
                            implicit=True,
                            partitions=max(
                                prev.resources.resolved_parallelism(),
                                node.resources.resolved_parallelism(),
                            ),
                        )
                    )
                    prev.output = Connection.to_topic(topic_name)
                    node.input = Connection.to_topic(topic_name)
                elif prev.output is None and node.input is not None:
                    prev.output = Connection.to_topic(node.input.topic)
                elif prev.output is not None and node.input is None:
                    node.input = Connection.to_topic(prev.output.topic)

            if prev is not None:
                plan.add_agent(prev)
            prev = node
        if prev is not None:
            plan.add_agent(prev)

    def _build_node(
        self,
        plan: ExecutionPlan,
        module_id: str,
        pipeline: Pipeline,
        agent: AgentConfiguration,
        idx: int,
    ) -> AgentNode:
        info = REGISTRY.agent(agent.type)
        node_id = agent.id or f"{pipeline.id}-{agent.type}-{idx}"
        if node_id in plan.agents:
            raise PlanError(f"duplicate agent id {node_id!r} in plan")
        if agent.signals_from:
            self._require_topic(plan, agent.signals_from, f"agent '{node_id}' signals-from")
        return AgentNode(
            id=node_id,
            agent_type=agent.type,
            component_type=info.component_type.value,
            module_id=module_id,
            pipeline_id=pipeline.id,
            configuration=dict(agent.configuration),
            resources=agent.resources,
            errors=agent.errors,
            disk=bool(agent.resources.disk and agent.resources.disk.enabled),
            signals_from=agent.signals_from,
        )

    @staticmethod
    def _require_topic(plan: ExecutionPlan, topic: str, what: str) -> None:
        if topic not in plan.topics:
            raise PlanError(f"{what} references undefined topic '{topic}'")

    # -- fusion (ComposableAgentExecutionPlanOptimiser parity) ---------------

    def _can_merge(self, previous: AgentNode, agent: AgentNode) -> bool:
        if previous.component_type == "service" or agent.component_type == "service":
            return False
        # a sink can terminate a fused chain but nothing can follow a sink
        if previous.component_type == "sink":
            return False
        # a source can only lead a fused chain
        if agent.component_type == "source":
            return False
        for leaf in previous.logical_agents():
            if not REGISTRY.agent(leaf.agent_type).composable:
                return False
        if not REGISTRY.agent(agent.agent_type).composable:
            return False
        if previous.resources != agent.resources:
            return False
        # same error policy required (ComposableAgentExecutionPlanOptimiser.java:58);
        # otherwise the fused node would silently drop one side's skip/retry spec
        if previous.errors != agent.errors:
            return False
        return True

    def _merge(self, previous: AgentNode, agent: AgentNode) -> AgentNode:
        """Fuse ``agent`` into ``previous`` (mergeAgents:76). The fused node
        keeps the first node's id/input and takes the last node's output; its
        component type reflects the (source?, processors*, sink?) shape."""
        children = list(previous.logical_agents()) + [agent]
        first, last = children[0], children[-1]
        if first.component_type == "source":
            ctype = "source"
        elif last.component_type == "sink":
            ctype = "sink"
        else:
            ctype = "processor"
        return AgentNode(
            id=previous.id,
            agent_type="composite-agent",
            component_type=ctype,
            module_id=previous.module_id,
            pipeline_id=previous.pipeline_id,
            configuration={},
            resources=previous.resources,
            errors=previous.errors,
            input=previous.input,
            output=agent.output,
            composite=[dataclasses.replace(c, composite=[]) for c in children],
            disk=previous.disk or agent.disk,
            signals_from=previous.signals_from,
        )

    # -- TPU topology validation (no reference counterpart) ------------------

    def _validate_tpu_meshes(self, plan: ExecutionPlan) -> None:
        for node in plan.agents.values():
            tpu = node.resources.tpu
            if tpu is None:
                continue
            if tpu.hosts < 1:
                raise PlanError(
                    f"agent '{node.id}': tpu.hosts must be >= 1, got {tpu.hosts}"
                )
            if tpu.hosts > 1:
                # replica-vs-shard (SURVEY §7): a multi-host slice is ONE
                # logical consumer over hosts pods; chips must split evenly
                # so every JAX process owns the same local device count
                if tpu.chips % tpu.hosts != 0:
                    raise PlanError(
                        f"agent '{node.id}': topology '{tpu.topology}' has "
                        f"{tpu.chips} chips, not divisible over {tpu.hosts} hosts"
                    )
                if node.resources.resolved_parallelism() > 1:
                    # one StatefulSet can pin ONE process group to one slice
                    # (required self-affinity on the slice's node pool);
                    # several multi-host groups in one set could straddle
                    # slices — scale by splitting agents instead
                    raise PlanError(
                        f"agent '{node.id}': hosts={tpu.hosts} requires "
                        "parallelism=1 (one multi-host replica per agent; "
                        "add more agents to scale consumers)"
                    )
            if not tpu.mesh:
                continue
            prod = 1
            for v in tpu.mesh.values():
                prod *= int(v)
            if prod != tpu.chips:
                raise PlanError(
                    f"agent '{node.id}': mesh {tpu.mesh} has {prod} devices but "
                    f"topology '{tpu.topology}' provides {tpu.chips} chips"
                    + (f" across {tpu.hosts} hosts" if tpu.hosts > 1 else "")
                )
