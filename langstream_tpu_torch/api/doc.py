"""Self-describing config schemas of agent and resource types (the port's
own copy of ``langstream_tpu/api/doc.py``): ``ConfigProperty``,
``ConfigModel`` and ``props``. ``core.validator`` reads them to reject
unknown fields and check types."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ConfigProperty:
    name: str
    description: str = ""
    type: str = "string"  # string|integer|number|boolean|object|array
    required: bool = False
    default: Any = None
    extended_validation: Optional[str] = None


@dataclass
class ConfigModel:
    """Schema for one agent or resource type."""

    type: str
    description: str = ""
    properties: dict[str, ConfigProperty] = field(default_factory=dict)
    allow_unknown: bool = False

    def prop(self, name: str) -> Optional[ConfigProperty]:
        return self.properties.get(name)


def props(*items: ConfigProperty) -> dict[str, ConfigProperty]:
    return {p.name: p for p in items}
