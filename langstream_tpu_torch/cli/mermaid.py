"""Mermaid pipeline diagram generator (the port's own copy of
``langstream_tpu/cli/mermaid.py``; reference ``MermaidAppDiagramGenerator.java``
behind ``langstream apps get -o mermaid``)."""

from __future__ import annotations

from langstream_tpu_torch.api.model import Application


def _node_id(kind: str, name: str) -> str:
    return f"{kind}_{name}".replace("-", "_").replace(".", "_")


def generate_mermaid(application: Application) -> str:
    lines = ["flowchart LR"]
    topics: set[str] = set()
    for module in application.modules.values():
        for topic in module.topics.values():
            topics.add(topic.name)
    for name in sorted(topics):
        lines.append(f"  {_node_id('topic', name)}[/{name}/]")
    for gateway in application.gateways:
        gid = _node_id("gateway", gateway.id)
        lines.append(f"  {gid}(({gateway.id}))")
        if gateway.type == "produce" and gateway.topic:
            lines.append(f"  {gid} --> {_node_id('topic', gateway.topic)}")
        elif gateway.type == "consume" and gateway.topic:
            lines.append(f"  {_node_id('topic', gateway.topic)} --> {gid}")
        elif gateway.type == "chat" and gateway.chat_options:
            chat = gateway.chat_options
            if chat.questions_topic:
                lines.append(f"  {gid} --> {_node_id('topic', chat.questions_topic)}")
            if chat.answers_topic:
                lines.append(f"  {_node_id('topic', chat.answers_topic)} --> {gid}")
        elif gateway.type == "service" and gateway.service_options:
            svc = gateway.service_options
            if svc.input_topic:
                lines.append(f"  {gid} --> {_node_id('topic', svc.input_topic)}")
            if svc.output_topic:
                lines.append(f"  {_node_id('topic', svc.output_topic)} --> {gid}")
    for module in application.modules.values():
        for pipeline in module.pipelines.values():
            for agent in pipeline.agents:
                aid = _node_id("agent", agent.id or agent.name or agent.type)
                label = agent.name or agent.id or agent.type
                lines.append(f'  {aid}["{label}<br/>({agent.type})"]')
                if agent.input:
                    lines.append(f"  {_node_id('topic', agent.input)} --> {aid}")
                if agent.output:
                    lines.append(f"  {aid} --> {_node_id('topic', agent.output)}")
    return "\n".join(lines)
