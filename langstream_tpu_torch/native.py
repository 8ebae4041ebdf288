"""Host-path utilities of the port: its own copy of the pure-Python
fallbacks in ``langstream_tpu/native.py`` (the port builds no host
extension), with the same semantics:

- ``OffsetTracker`` — per-record contiguous-prefix commit bookkeeping on the
  broker's consume path (at-least-once, ordered commit);
- ``fnv1a64`` / ``key_partition`` — a stable key hash for partition routing
  (Python's ``hash(str)`` is salted per process, so replicas would disagree
  on a key's partition);
- ``py_utf8_incomplete_tail_len`` — the undecodable tail a streaming
  detokenizer holds back;
- ``crc32c`` — the Kafka record-batch v2 checksum on the produce path
  (``messaging/kafka_protocol.py``), table-driven."""

from __future__ import annotations


class PyOffsetTracker:
    """Contiguous-prefix offset commit tracker: ``ack`` marks one offset
    done and returns the watermark, the first offset not yet acked."""

    def __init__(self, start: int = 0) -> None:
        self._watermark = int(start)
        self._pending: set[int] = set()

    def ack(self, offset: int) -> int:
        if offset >= self._watermark:
            self._pending.add(int(offset))
            while self._watermark in self._pending:
                self._pending.remove(self._watermark)
                self._watermark += 1
        return self._watermark

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def pending_count(self) -> int:
        return len(self._pending)


OffsetTracker = PyOffsetTracker


def _make_crc32c_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def py_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


crc32c = py_crc32c


def fnv1a64(data: bytes) -> int:
    h = 14695981039346656037
    for byte in bytes(data):
        h ^= byte
        h = (h * 1099511628211) % (1 << 64)
    return h


def key_partition(key: object, n_partitions: int) -> int:
    """Stable key → partition routing shared by every broker runtime."""
    if n_partitions <= 1:
        return 0
    data = str(key).encode("utf-8", "surrogatepass")
    return fnv1a64(data) % n_partitions


def _utf8_seq_len(c: int) -> int:
    """Total bytes for a sequence with lead byte c; 0 = invalid lead.
    STRICT (matches CPython's codec): C0/C1 overlong and F5+ out-of-range
    leads are invalid."""
    if c < 0x80:
        return 1
    if 0xC2 <= c <= 0xDF:
        return 2
    if 0xE0 <= c <= 0xEF:
        return 3
    if 0xF0 <= c <= 0xF4:
        return 4
    return 0


def _utf8_second_ok(lead: int, c2: int) -> bool:
    if lead == 0xE0:
        return 0xA0 <= c2 <= 0xBF  # overlong 3-byte
    if lead == 0xED:
        return 0x80 <= c2 <= 0x9F  # surrogates
    if lead == 0xF0:
        return 0x90 <= c2 <= 0xBF  # overlong 4-byte
    if lead == 0xF4:
        return 0x80 <= c2 <= 0x8F  # > U+10FFFF
    return (c2 & 0xC0) == 0x80


def py_utf8_incomplete_tail_len(data: bytes) -> int:
    """Bytes of a trailing incomplete-but-plausible UTF-8 sequence (0 when
    the buffer ends on a boundary or in garbage that can never complete).
    Streaming decoders hold back exactly this tail and decode the rest with
    errors="replace" — never raising, never freezing on a bad byte."""
    b = bytes(data)
    n = len(b)
    for back in range(1, min(3, n) + 1):
        p = n - back
        length = _utf8_seq_len(b[p])
        if length == 1:
            return 0  # ascii boundary
        if length == 0:
            continue  # continuation/invalid byte: look further back
        if length > back:
            ok = True
            for j in range(1, back):
                c = b[p + j]
                bad = (not _utf8_second_ok(b[p], c)) if j == 1 else ((c & 0xC0) != 0x80)
                if bad:
                    ok = False
                    break
            return back if ok else 0
        return 0  # complete (or over-complete) sequence at the tail
    return 0
