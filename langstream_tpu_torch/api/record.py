"""Record model: key / value / headers / origin / timestamp.

Parity: reference `api/runner/code/Record.java:20`, `SimpleRecord`, `Header`.
Records are immutable value objects; agents produce new records rather than
mutating inputs (the transform context in agents/genai mutates a scratch copy).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Protocol, runtime_checkable


@dataclass(frozen=True)
class Header:
    key: str
    value: Any

    def value_as_string(self) -> Optional[str]:
        if self.value is None:
            return None
        if isinstance(self.value, bytes):
            return self.value.decode("utf-8", errors="replace")
        return str(self.value)


@runtime_checkable
class Record(Protocol):
    """Structural record contract (reference Record.java:20)."""

    @property
    def key(self) -> Any: ...

    @property
    def value(self) -> Any: ...

    @property
    def origin(self) -> Optional[str]: ...

    @property
    def timestamp(self) -> Optional[float]: ...

    @property
    def headers(self) -> tuple[Header, ...]: ...


def get_header(record: "Record", key: str) -> Optional[Header]:
    for h in record.headers:
        if h.key == key:
            return h
    return None


def header_value(record: "Record", key: str, default: Any = None) -> Any:
    h = get_header(record, key)
    return h.value if h is not None else default


@dataclass(frozen=True)
class SimpleRecord:
    """Default Record implementation (reference SimpleRecord)."""

    value: Any
    key: Any = None
    headers: tuple[Header, ...] = field(default_factory=tuple)
    origin: Optional[str] = None
    timestamp: Optional[float] = None

    @staticmethod
    def of(
        value: Any,
        key: Any = None,
        headers: Optional[Iterable[Header | tuple[str, Any]]] = None,
        origin: Optional[str] = None,
        timestamp: Optional[float] = None,
    ) -> "SimpleRecord":
        hs: list[Header] = []
        for h in headers or ():
            hs.append(h if isinstance(h, Header) else Header(h[0], h[1]))
        return SimpleRecord(
            value=value,
            key=key,
            headers=tuple(hs),
            origin=origin,
            timestamp=timestamp if timestamp is not None else time.time(),
        )

    @staticmethod
    def copy_from(record: "Record", **overrides: Any) -> "SimpleRecord":
        base = dict(
            value=record.value,
            key=record.key,
            headers=tuple(record.headers),
            origin=record.origin,
            timestamp=record.timestamp,
        )
        base.update(overrides)
        return SimpleRecord(**base)

    def with_headers(self, extra: Iterable[Header | tuple[str, Any]]) -> "SimpleRecord":
        hs = list(self.headers)
        for h in extra:
            hs.append(h if isinstance(h, Header) else Header(h[0], h[1]))
        return SimpleRecord.copy_from(self, headers=tuple(hs))
