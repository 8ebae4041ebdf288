"""The fleet's binary wire, ``lstpu-kvmig-v2`` and ``lstpu-frames-v2`` (the
port's own copy of ``langstream_tpu/serving/wire.py``; stdlib only).

The v1 wire ships every replica-to-replica byte as NDJSON, KV pages as
base64. v2 keeps the same frame dicts but ships them as framed binary
records: small control records with a fixed prelude and CRC32, and
payloads as raw bytes at their native width (an int8 pool moves int8).

A body or stream is an 8-byte preamble (``LSTPUKV2`` for a migration or a
page fetch, ``LSTPUFR2`` for a token stream; a v1 NDJSON body always starts
with ``{``, so a receiver can sniff the codec) and a sequence of frames,
all integers little-endian:

    prelude   ``<HBBIIII`` = magic u16 | kind u8 | flags u8 | seq u32 |
              header_len u32 | payload_len u32 | crc32 u32
              (CRC32 over header ++ payload)
    header    kind-specific record (page: ``<I16s`` index + blake2b-16
              checksum; tokens: the DFA state ``<i`` when carried; begin /
              commit / end / error: a small JSON record, once a transfer)
    payload   raw bytes (page: the page's leaf blocks concatenated at their
              native width, ``pagepool.join_page_bytes``; begin and tokens:
              packed ``<i`` int32 token ids)

Both declared lengths are bounds-checked before any allocation, and a
short read raises: a corrupt, hostile or truncated body raises
``WireError``, never allocates unbounded memory and never hangs (the
transport's socket timeout bounds every read underneath). The codec reads
and writes the frame dicts of the v1 modules (``serving/migrate.py``,
``serving/fleet.py``), so checksums, sequence checks and the failure
ladders are one code path on both wires; the bytes are the JAX package's
for the same frames. The durable tier (``serving/durable.py``) writes a
checkpoint as one kvmig-v2 body. Peers negotiate v2 through their beacons'
``caps`` (``kvmig2``, ``frames2``); v1 NDJSON stays the fallback.
"""

from __future__ import annotations

import base64
import json
import struct
import threading
import zlib
from typing import Any, Callable, Iterator, Optional

MIG_SCHEMA_V2 = "lstpu-kvmig-v2"
FRAME_SCHEMA_V2 = "lstpu-frames-v2"

# the 8-byte preambles written once before a body's or stream's first
# frame — the receiver's codec sniff
KVMIG2_PREAMBLE = b"LSTPUKV2"
FRAMES2_PREAMBLE = b"LSTPUFR2"

# per-frame prelude: magic u16 | kind u8 | flags u8 | seq u32 |
# header_len u32 | payload_len u32 | crc32 u32 (over header ++ payload)
PRELUDE = struct.Struct("<HBBIIII")
KVMIG2_MAGIC = 0x4B32  # "K2"
FRAMES2_MAGIC = 0x4632  # "F2"

# control headers are small fixed records or one compact JSON dict a body —
# anything bigger is a corrupt or hostile length prefix
MAX_HEADER_BYTES = 1 << 16
# token-stream payloads are packed int32 token ids; one frame never
# legitimately carries more than this (the engine chunks far smaller)
FRAMES2_MAX_PAYLOAD = 1 << 20

# lstpu-kvmig-v2 frame kinds
MIG_BEGIN, MIG_PAGE, MIG_COMMIT = 1, 2, 3
# lstpu-frames-v2 frame kinds
FR_TOKENS, FR_HEARTBEAT, FR_END, FR_ERROR = 1, 2, 3, 4

# tokens-frame flag bit 0: the header carries the host-mirrored DFA state
# (``<i``), for a constrained stream's resume
FLAG_DFA_STATE = 0x01

_PAGE_HEADER = struct.Struct("<I16s")  # page index + blake2b-16 checksum


class WireError(RuntimeError):
    """A codec violation (truncated prelude, CRC mismatch, oversized
    declared length, unknown magic or kind): the hop or body is dead —
    callers map it to ReplicaError (a stream) or MigrationError (a
    migration) and fall back, and the durable tier reads it as a dead
    entry. It never implies wrong KV and never hangs a reader."""


# ---------------------------------------------------------------------------
# Wire byte accounting (the fleet-wire-bytes-{v1,v2}-total counters): counted
# at the SENDING side only — one count per byte fleet-wide.
# ---------------------------------------------------------------------------

_COUNT_LOCK = threading.Lock()
_WIRE_BYTES: dict[str, int] = {"v1": 0, "v2": 0}


def count_wire_bytes(proto: str, n: int) -> None:
    if proto not in _WIRE_BYTES:
        return
    with _COUNT_LOCK:
        _WIRE_BYTES[proto] += int(n)


def wire_stats() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(_WIRE_BYTES)


def reset_wire_stats() -> None:
    with _COUNT_LOCK:
        for k in _WIRE_BYTES:
            _WIRE_BYTES[k] = 0


# ---------------------------------------------------------------------------
# Core frame read/write
# ---------------------------------------------------------------------------


def _frame(magic: int, kind: int, flags: int, seq: int,
           header: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(payload, zlib.crc32(header))
    return (
        PRELUDE.pack(magic, kind, flags, seq, len(header), len(payload), crc)
        + header
        + payload
    )


def read_exact(read: Callable[[int], bytes], n: int) -> bytes:
    """Read exactly ``n`` bytes from ``read`` (a ``file.read``-style
    callable that may return short). A premature EOF is a WireError — a
    truncated frame reads as a dead body, never blocks."""
    buf = b""
    while len(buf) < n:
        chunk = read(n - len(buf))
        if not chunk:
            raise WireError(
                f"truncated wire frame (wanted {n} bytes, got {len(buf)})"
            )
        buf += chunk
    return buf


def read_frame(
    read: Callable[[int], bytes],
    magic: int,
    max_payload: int,
    max_header: int = MAX_HEADER_BYTES,
) -> Optional[tuple[int, int, int, bytes, bytes]]:
    """Read one framed record: ``(kind, flags, seq, header, payload)``,
    or None at a clean end-of-stream (EOF exactly on a frame boundary).
    Both declared lengths are checked against their bounds BEFORE any
    read/allocation; the CRC covers header ++ payload."""
    head = b""
    while len(head) < PRELUDE.size:
        chunk = read(PRELUDE.size - len(head))
        if not chunk:
            if not head:
                return None
            raise WireError(
                f"truncated frame prelude ({len(head)} of "
                f"{PRELUDE.size} bytes)"
            )
        head += chunk
    got_magic, kind, flags, seq, hlen, plen, crc = PRELUDE.unpack(head)
    if got_magic != magic:
        raise WireError(
            f"bad frame magic 0x{got_magic:04x} (want 0x{magic:04x})"
        )
    if hlen > max_header:
        raise WireError(
            f"frame seq {seq} declares a {hlen}-byte header "
            f"(bound {max_header})"
        )
    if plen > max_payload:
        raise WireError(
            f"frame seq {seq} declares a {plen}-byte payload "
            f"(bound {max_payload})"
        )
    header = read_exact(read, hlen)
    payload = read_exact(read, plen)
    if zlib.crc32(payload, zlib.crc32(header)) != crc:
        raise WireError(f"frame seq {seq} failed its CRC32")
    return kind, flags, seq, header, payload


def _pack_tokens(tokens) -> bytes:
    toks = [int(t) for t in tokens]
    return struct.pack(f"<{len(toks)}i", *toks)


def _unpack_tokens(payload: bytes, what: str) -> list[int]:
    if len(payload) % 4:
        raise WireError(
            f"{what} payload ({len(payload)} bytes) is not int32-aligned"
        )
    return list(struct.unpack(f"<{len(payload) // 4}i", payload))


def _json_header(header: bytes, what: str) -> dict:
    try:
        doc = json.loads(header.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"{what} header undecodable ({e})") from e
    if not isinstance(doc, dict):
        raise WireError(f"{what} header is not a record")
    return doc


# ---------------------------------------------------------------------------
# lstpu-kvmig-v2: the migration/page-fetch wire
# ---------------------------------------------------------------------------


def encode_mig_frame(frame: dict) -> bytes:
    """One frame dict (``kind`` begin | page | commit, with ``seq``) → its
    binary encoding. A page's payload is its ``raw`` bytes, or a v1 frame's
    base64 ``data`` blocks decoded."""
    kind = frame.get("kind")
    seq = int(frame.get("seq", 0))
    if kind == "begin":
        meta = {
            k: frame[k]
            for k in ("length", "digest", "pages", "page_size", "bytes_per_page", "tier")
            if k in frame
        }
        header = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        return _frame(
            KVMIG2_MAGIC, MIG_BEGIN, 0, seq, header,
            _pack_tokens(frame.get("prompt_tokens") or []),
        )
    if kind == "page":
        checksum = bytes.fromhex(str(frame.get("checksum") or ""))
        if len(checksum) != 16:
            raise WireError(
                f"page {frame.get('i')} checksum is {len(checksum)} bytes (want 16)"
            )
        header = _PAGE_HEADER.pack(int(frame.get("i", 0)), checksum)
        raw = frame.get("raw")
        if raw is None:  # a v1 frame: its base64 leaf blocks
            raw = b"".join(base64.b64decode(b) for b in (frame.get("data") or []))
        return _frame(KVMIG2_MAGIC, MIG_PAGE, 0, seq, header, bytes(raw))
    if kind == "commit":
        header = json.dumps(
            {"pages_sent": int(frame.get("pages_sent", 0)),
             "state": dict(frame.get("state") or {})},
            separators=(",", ":"),
        ).encode("utf-8")
        return _frame(KVMIG2_MAGIC, MIG_COMMIT, 0, seq, header, b"")
    raise WireError(f"unknown migration frame kind {kind!r}")


def encode_mig_stream(frames) -> bytes:
    """A whole body — preamble + every frame — as one byte string: what the
    durable tier writes to disk, so every frame's CRC32 prelude doubles as
    torn-write detection."""
    return KVMIG2_PREAMBLE + b"".join(encode_mig_frame(f) for f in frames)


def decode_mig_frames(
    read: Callable[[int], bytes], max_payload: int,
) -> Iterator[dict]:
    """Decode a body (after its preamble) into frame dicts — a page's
    payload comes out as one contiguous ``raw`` bytes field, split by the
    reader's pool layout (``pagepool.split_page_bytes``). Stops after the
    commit frame; an EOF before it is the iterator ending (the reader calls
    a body without a commit torn)."""
    while True:
        rec = read_frame(read, KVMIG2_MAGIC, max_payload)
        if rec is None:
            return
        kind, _flags, seq, header, payload = rec
        if kind == MIG_BEGIN:
            meta = _json_header(header, "begin")
            yield {
                "v": MIG_SCHEMA_V2, "seq": seq, "kind": "begin",
                "prompt_tokens": _unpack_tokens(payload, "begin token"),
                **meta,
            }
        elif kind == MIG_PAGE:
            if len(header) != _PAGE_HEADER.size:
                raise WireError(
                    f"page frame seq {seq} header is {len(header)} bytes "
                    f"(want {_PAGE_HEADER.size})"
                )
            i, checksum = _PAGE_HEADER.unpack(header)
            yield {
                "seq": seq, "kind": "page", "i": int(i),
                "raw": payload, "checksum": checksum.hex(),
            }
        elif kind == MIG_COMMIT:
            meta = _json_header(header, "commit")
            yield {
                "seq": seq, "kind": "commit",
                "pages_sent": int(meta.get("pages_sent", 0)),
                "state": dict(meta.get("state") or {}),
            }
            return
        else:
            raise WireError(f"unknown kvmig2 frame kind {kind}")


# ---------------------------------------------------------------------------
# lstpu-frames-v2: the token-stream wire
# ---------------------------------------------------------------------------


def encode_stream_frame(frame: dict) -> bytes:
    """One stream frame dict (``serving/fleet.py``'s frames) → its v2
    encoding: a tokens frame is the prelude and the packed int32 ids (the
    DFA state as a 4-byte header when carried), a heartbeat the prelude
    alone; the terminal end / error frame keeps a JSON header, once a
    stream."""
    kind = frame.get("kind")
    seq = int(frame.get("seq", 0))
    if kind == "tokens":
        payload = _pack_tokens(frame.get("tokens") or [])
        dfa = frame.get("dfa_state")
        if dfa is None:
            return _frame(FRAMES2_MAGIC, FR_TOKENS, 0, seq, b"", payload)
        return _frame(
            FRAMES2_MAGIC, FR_TOKENS, FLAG_DFA_STATE, seq, struct.pack("<i", int(dfa)), payload,
        )
    if kind == "heartbeat":
        return _frame(FRAMES2_MAGIC, FR_HEARTBEAT, 0, seq, b"", b"")
    if kind in ("end", "error"):
        meta = {k: v for k, v in frame.items() if k not in ("seq", "kind", "v")}
        header = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        fk = FR_END if kind == "end" else FR_ERROR
        return _frame(FRAMES2_MAGIC, fk, 0, seq, header, b"")
    raise WireError(f"unknown stream frame kind {kind!r}")


def decode_stream_frames(read: Callable[[int], bytes]) -> Iterator[dict]:
    """Decode a v2 token stream (after its preamble) into stream frame
    dicts. Stops after the terminal end / error frame; an EOF before one is
    the iterator ending — the consumer calls a stream without a terminal
    frame a dead hop, as on v1."""
    while True:
        rec = read_frame(read, FRAMES2_MAGIC, FRAMES2_MAX_PAYLOAD)
        if rec is None:
            return
        kind, flags, seq, header, payload = rec
        if kind == FR_TOKENS:
            frame: dict[str, Any] = {
                "seq": seq, "kind": "tokens", "tokens": _unpack_tokens(payload, "tokens"),
            }
            if flags & FLAG_DFA_STATE:
                if len(header) != 4:
                    raise WireError(
                        f"tokens frame seq {seq} DFA header is {len(header)} bytes (want 4)"
                    )
                frame["dfa_state"] = struct.unpack("<i", header)[0]
            yield frame
        elif kind == FR_HEARTBEAT:
            yield {"seq": seq, "kind": "heartbeat"}
        elif kind in (FR_END, FR_ERROR):
            meta = _json_header(header, "end" if kind == FR_END else "error")
            yield {"seq": seq, "kind": "end" if kind == FR_END else "error", **meta}
            return
        else:
            raise WireError(f"unknown frames2 frame kind {kind}")
