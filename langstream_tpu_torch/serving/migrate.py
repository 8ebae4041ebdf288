"""KV-page migration between serving engines (the port's own copy of
``langstream_tpu/serving/migrate.py``).

Disaggregated prefill/decode and the peer-to-peer prefix fetch move one
published prefix's KV PAGES from the engine that prefilled them to another
engine. This module is that move, built so the transfer can fail at any
byte and the request still ends with the right tokens:

- **Frames** (one monotone ``seq`` a frame):

  ``begin``   prefix length and digest, page count and geometry, the
              prefix's tokens (the receiver's trie is keyed by tokens)
  ``page``    one pool page: its leaf blocks (``pool_leaves`` order; an
              int8 pool ships codes and scales) as a v1 ``data`` list of
              base64 strings (bf16 as its 16-bit patterns) or one v2
              ``raw`` byte field (``pagepool.join_page_bytes``), and the
              blake2b-16 ``pagepool.page_checksum`` stamp. A hibernated
              entry ships its host-arena bytes with the stamp stored at
              spill time — hashing them again would launder rot the arena
              already caught.
  ``commit``  pages sent and the decode-resume state (position, sampling,
              the grammar key and the host-mirrored DFA state of a stream
              in mid-derivation)

  The frames are the JAX package's, byte for byte: either package's
  engine binds the other's.

- **Discipline**: every page is checked against its stamp before the
  receiver allocates anything (a mismatch aborts with nothing bound); the
  sender frees its copy ONLY on the receiver's ACK (``_release_on_ack``);
  the receiver frees ONLY on abort. The ``migrate`` fault site corrupts a
  page payload in flight and ``net-cut`` ends the stream between frames
  (the wire injector, ``serving/fleet.py``): either way the router falls
  back (decode in place, or a cold prefill) with the right tokens.

Transport: in process, a generator handed from one engine to the other
(``transfer``); between processes, ``push_migration`` POSTs the frames
chunked to the receiver's ``POST /fleet/migrate`` (``runtime/http_server.py``)
and reads its ACK, and ``fetch_pages`` pulls an owner's frames from its
``POST /fleet/pages`` — v1 NDJSON or the v2 binary body (``serving/wire.py``),
stdlib ``http.client`` both.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import time
import urllib.parse
from typing import Any, Iterator, Optional

import numpy as np

from langstream_tpu_torch.serving.pagepool import (
    join_page_bytes,
    np_view,
    page_checksum,
    page_leaf_specs,
    split_page_bytes,
)
from langstream_tpu_torch.serving import wire as wire_mod
from langstream_tpu_torch.serving.wire import MIG_SCHEMA_V2

log = logging.getLogger(__name__)

MIG_SCHEMA = "lstpu-kvmig-v1"


class MigrationError(RuntimeError):
    """A KV-page migration failed (checksum mismatch, cut stream, pool
    exhaustion, deadline, an engine that is stopped or not paged). Callers
    fall back — decode in place on the sender, or a cold prefill on the
    receiver — and the sender RETAINS its pages: this error never implies
    lost KV."""


def _b64(block: Any) -> str:
    arr = np.ascontiguousarray(np_view(block))
    return base64.b64encode(arr.reshape(-1).view(np.uint8)).decode("ascii")


def _ms(t0: float) -> float:
    return round((time.perf_counter() - t0) * 1e3, 3)


def export_frames(
    engine: Any,
    tokens,
    timeout_s: float = 30.0,
    state: Optional[dict] = None,
    phases: Optional[dict] = None,
    raw: bool = False,
) -> Iterator[dict]:
    """The deepest published prefix covering ``tokens`` as migration
    frames. The snapshot is taken EAGERLY, before the first frame, so a
    missing prefix or a dead engine raises here, while the caller can still
    choose a fallback. The wire injector's ``migrate`` site corrupts one
    page payload in flight and ``net-cut`` ends the stream between frames;
    neither touches the sender's copy (it is released on ACK only, outside
    this generator). ``raw=True`` ships each page as one v2 ``raw`` byte
    field instead of v1's base64 ``data`` list. ``phases`` (when given)
    collects the snapshot's ``snapshot_ms``, ``copy_ms``, ``checksum_ms``,
    ``tier`` and, as the frames are drawn, ``encode_ms``."""
    from langstream_tpu_torch.serving.fleet import wire_injector

    tokens = [int(t) for t in tokens]
    t0 = time.perf_counter()
    snap = engine.migrate_snapshot(tokens, timeout_s=timeout_s)
    phases = phases if phases is not None else {}
    phases["snapshot_ms"] = _ms(t0)
    phases["tier"] = snap["tier"]
    for key in ("copy_ms", "checksum_ms"):
        phases[key] = snap.get(key, 0.0)
    phases["encode_ms"] = 0.0
    injector = wire_injector()

    def frames() -> Iterator[dict]:
        n = len(snap["blocks"])
        yield {
            "v": MIG_SCHEMA, "seq": 0, "kind": "begin",
            "length": int(snap["length"]),
            "digest": snap["digest"],
            "pages": n,
            "page_size": int(snap["page_size"]),
            "bytes_per_page": int(snap["bytes_per_page"]),
            "tier": snap["tier"],
            "prompt_tokens": tokens[: int(snap["length"])],
        }
        for i, (leaves, checksum) in enumerate(zip(snap["blocks"], snap["checksums"])):
            if injector is not None and injector.fires("net-cut"):
                raise MigrationError(f"injected net-cut after {i} of {n} page frame(s)")
            t1 = time.perf_counter()
            frame = {"seq": i + 1, "kind": "page", "i": i, "checksum": checksum.hex()}
            if raw:
                frame["raw"] = join_page_bytes(leaves)
            else:
                frame["data"] = [_b64(leaf) for leaf in leaves]
            phases["encode_ms"] = round(phases["encode_ms"] + _ms(t1), 3)
            if injector is not None:
                injector.corrupt_migration_frame(frame)
            yield frame
        yield {
            "seq": n + 1, "kind": "commit", "pages_sent": n,
            "state": dict(state or {}, position=int(snap["length"])),
        }

    return frames()


def _leaf_specs(engine: Any) -> list[tuple[tuple, Any]]:
    """``(page shape, numpy dtype)`` of each leaf of the receiver's pool —
    what one page must decode to. Static: safe off the engine thread."""
    return page_leaf_specs(engine._pagepool.dev)  # noqa: SLF001


def _decode_page(frame: dict, specs) -> list[np.ndarray]:
    if frame.get("raw") is not None:
        return split_page_bytes(bytes(frame["raw"]), specs)
    page = []
    for (shape, dtype), b64 in zip(specs, frame.get("data") or []):
        arr = np.frombuffer(base64.b64decode(b64, validate=True), dtype=dtype)
        page.append(arr.reshape(shape))
    return page


def bind_frames(engine: Any, frames: Iterator[dict], timeout_s: float = 30.0) -> dict:
    """Receiver side: decode and check every frame, then bind the pages
    into ``engine``'s pool and prefix index. Every page is checked against
    its stamp before anything is allocated — a cut stream, an undecodable
    payload or a checksum mismatch aborts with the receiver's free list
    untouched. Takes v1 (``data``) and v2 (``raw``) page frames alike.
    Returns the ACK the sender frees against, with the receiver's
    ``decode_ms``, ``verify_ms``, ``upload_ms`` and ``bind_ms`` (frames in
    to ACK)."""
    deadline = time.monotonic() + max(0.05, timeout_s)
    t0 = time.perf_counter()
    begin: Optional[dict] = None
    blocks: list[list[np.ndarray]] = []
    specs = None
    expected_seq = 0
    decode_ms = verify_ms = 0.0
    try:
        for frame in frames:
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"migration exceeded its {timeout_s:.1f}s budget after {len(blocks)} page(s)"
                )
            if not isinstance(frame, dict) or frame.get("seq") != expected_seq:
                got = frame.get("seq") if isinstance(frame, dict) else None
                raise MigrationError(
                    f"migration sequence broken (got {got!r}, want {expected_seq})"
                )
            expected_seq += 1
            kind = frame.get("kind")
            if kind == "begin":
                if frame.get("v") not in (MIG_SCHEMA, MIG_SCHEMA_V2):
                    raise MigrationError(f"unknown migration schema {frame.get('v')!r}")
                begin = frame
                specs = _leaf_specs(engine)
            elif kind == "page":
                if begin is None:
                    raise MigrationError("page frame before begin")
                t1 = time.perf_counter()
                try:
                    page = _decode_page(frame, specs)
                    want = bytes.fromhex(str(frame.get("checksum") or ""))
                except (ValueError, TypeError) as e:
                    raise MigrationError(
                        f"page {frame.get('i')} payload undecodable ({e})"
                    ) from e
                decode_ms += _ms(t1)
                if len(page) != len(specs):
                    raise MigrationError(
                        f"page {frame.get('i')} carries {len(page)} leaf blocks; "
                        f"this pool has {len(specs)}"
                    )
                t1 = time.perf_counter()
                if page_checksum(page) != want:
                    raise MigrationError(
                        f"page {frame.get('i')} failed its checksum — discarding the "
                        "migration (sender retains)"
                    )
                verify_ms += _ms(t1)
                blocks.append(page)
            elif kind == "commit":
                if begin is None:
                    raise MigrationError("commit frame before begin")
                if len(blocks) != int(begin.get("pages") or -1) or (
                    len(blocks) != int(frame.get("pages_sent") or -1)
                ):
                    raise MigrationError(
                        f"commit count mismatch: {len(blocks)} received, begin said "
                        f"{begin.get('pages')}, commit said {frame.get('pages_sent')}"
                    )
                remaining = max(0.05, deadline - time.monotonic())
                ack = engine.migrate_bind(
                    [int(t) for t in begin["prompt_tokens"]], int(begin["length"]), blocks,
                    timeout_s=remaining,
                )
                return {
                    "ok": True,
                    "length": int(begin["length"]),
                    "digest": str(begin.get("digest") or ""),
                    "pages": int(ack.get("pages", 0)),
                    "bytes": int(ack.get("bytes", 0)),
                    "already": bool(ack.get("already", False)),
                    "state": dict(frame.get("state") or {}),
                    "decode_ms": round(decode_ms, 3),
                    "verify_ms": round(verify_ms, 3),
                    "upload_ms": float(ack.get("upload_ms", 0.0)),
                    "bind_ms": _ms(t0),
                }
            else:
                raise MigrationError(f"unknown migration frame {kind!r}")
    finally:
        close = getattr(frames, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — the abort path must not mask
                log.exception("migration frame close failed")
    raise MigrationError(
        f"migration stream ended after {len(blocks)} page(s) without a commit frame "
        "(cut stream) — nothing was bound"
    )


def transfer(
    src_engine: Any,
    dst_engine: Any,
    tokens,
    timeout_s: float = 30.0,
    state: Optional[dict] = None,
    phases: Optional[dict] = None,
) -> dict:
    """In-process migration: export from ``src_engine``, bind into
    ``dst_engine``, release the source copy on ACK. Raises MigrationError
    with the sender intact on any failure."""
    phases = phases if phases is not None else {}
    frames = export_frames(src_engine, tokens, timeout_s=timeout_s, state=state, phases=phases)
    ack = bind_frames(dst_engine, frames, timeout_s=timeout_s)
    _release_on_ack(src_engine, tokens, ack)
    return ack


def _release_on_ack(src_engine: Any, tokens, ack: dict) -> None:
    """The sender frees ONLY on ACK; a failed release is benign (the entry
    stays for LRU) and never fails a migration that already landed."""
    try:
        src_engine.migrate_release(tokens, int(ack["length"]))
    except Exception as e:  # noqa: BLE001 — an ACKed migration stands
        log.warning("post-ACK migration release failed (retained): %s", e)


def _http_conn(url: str, timeout_s: float, what: str) -> http.client.HTTPConnection:
    u = urllib.parse.urlsplit(url)
    if u.scheme != "http" or not u.hostname:
        raise MigrationError(f"unsupported {what} url {url!r}")
    return http.client.HTTPConnection(u.hostname, u.port or 80, timeout=max(0.05, timeout_s))


def push_migration(url: str, frames: Iterator[dict], timeout_s: float, wire: str = "v1") -> dict:
    """HTTP sender: POST the frame stream chunked to the receiver's ``POST
    /fleet/migrate`` and return its ACK. Any transport failure — a refused
    connect, a reset mid-body, a non-JSON ACK — is a MigrationError; the
    caller's release-on-ACK keeps the sender's copy. ``wire`` picks the
    codec: ``"v1"`` NDJSON lines, ``"v2"`` the ``lstpu-kvmig-v2`` binary
    body (pair it with ``export_frames(raw=True)``, so pages skip base64);
    the caller negotiates it from the receiver's ``kvmig2`` cap."""
    conn = _http_conn(url, timeout_s, "migration receiver")
    v2 = wire == "v2"

    def body() -> Iterator[bytes]:
        if v2:
            wire_mod.count_wire_bytes("v2", len(wire_mod.KVMIG2_PREAMBLE))
            yield wire_mod.KVMIG2_PREAMBLE
        for frame in frames:
            if v2:
                chunk = wire_mod.encode_mig_frame(frame)
            else:
                chunk = (json.dumps(frame) + "\n").encode("utf-8")
            wire_mod.count_wire_bytes("v2" if v2 else "v1", len(chunk))
            yield chunk

    try:
        try:
            # the receiver binds under the SENDER's budget (clamped by its
            # handler), so one timeout bounds the whole transfer
            conn.request(
                "POST", f"/fleet/migrate?timeout-s={max(0.05, timeout_s):.3f}", body=body(),
                headers={"Content-Type": (
                    "application/x-lstpu-kvmig2" if v2 else "application/x-ndjson"
                )},
                encode_chunked=True,
            )
            resp = conn.getresponse()
            raw = resp.read()
        except MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 — one verdict: the hop failed
            raise MigrationError(f"migration push to {url} failed: {e}") from e
        if resp.status != 200:
            raise MigrationError(
                f"migration receiver {url} answered HTTP {resp.status}: {raw[:200]!r}"
            )
        try:
            ack = json.loads(raw.decode("utf-8"))
        except ValueError as e:
            raise MigrationError(f"migration receiver {url} sent a non-JSON ACK") from e
        if not ack.get("ok"):
            raise MigrationError(
                f"migration receiver {url} rejected the transfer: {ack.get('error')!r}"
            )
        return ack
    finally:
        conn.close()
        close = getattr(frames, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001
                log.exception("migration frame close failed")


def fetch_pages(url: str, tokens, timeout_s: float, wire: str = "v2") -> Iterator[dict]:
    """Peer-to-peer page fetch client: POST the owning peer's ``/fleet/pages``
    and return an iterator of the migration frames covering the deepest
    published prefix of ``tokens`` — what ``bind_frames`` consumes, so the
    fetch admits warm through the one checked bind. The owner KEEPS its
    pages (a fetch copies; only a migration moves). ``wire`` asks for the
    codec (``"v2"`` when the owner advertises ``kvmig2``); the response's
    content type decides. A refusal before the stream (no published prefix,
    a dead engine) is a JSON error body, raised here as MigrationError like
    every transport or codec failure, so the caller degrades to its cold
    path."""
    conn = _http_conn(url, timeout_s, "page-fetch source")
    body = json.dumps({
        "prompt_tokens": [int(t) for t in tokens],
        "timeout-s": max(0.05, float(timeout_s)),
        "wire": "v2" if wire == "v2" else "v1",
    }).encode("utf-8")
    try:
        conn.request("POST", "/fleet/pages", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
    except Exception as e:  # noqa: BLE001 — one verdict: no pages fetched
        conn.close()
        raise MigrationError(f"page fetch from {url} failed: {e}") from e
    ctype = str(resp.getheader("Content-Type") or "")
    # a refusal is one JSON document; a v1 stream is NDJSON, whose content
    # type also names json (application/x-ndjson)
    if resp.status != 200 or ctype.startswith("application/json"):
        try:
            raw = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise MigrationError(
                f"page-fetch source {url} answered HTTP {resp.status}: {raw[:200]!r}"
            )
        try:
            doc = json.loads(raw.decode("utf-8"))
        except ValueError:
            doc = {}
        raise MigrationError(f"page-fetch source {url} refused: {doc.get('error')!r}")

    def frames() -> Iterator[dict]:
        try:
            if "lstpu-kvmig2" in ctype:
                preamble = wire_mod.read_exact(resp.read, len(wire_mod.KVMIG2_PREAMBLE))
                if preamble != wire_mod.KVMIG2_PREAMBLE:
                    raise wire_mod.WireError(f"bad kvmig2 preamble {preamble!r}")
                # the decode bound does not trust the begin frame's own
                # bytes_per_page: the flat transfer cap (the checksums
                # still gate every bind)
                yield from wire_mod.decode_mig_frames(resp.read, max_payload=64 << 20)
                return
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line.decode("utf-8"))
        except MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 — a dead wire mid-fetch
            raise MigrationError(f"page fetch from {url} died mid-stream: {e}") from e
        finally:
            conn.close()

    return frames()
