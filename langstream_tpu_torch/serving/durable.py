"""Durable session tier: crash-safe KV checkpoints on disk (the port's own
copy of ``langstream_tpu/serving/durable.py``; no torch, stdlib only).

The host arena (``serving/pagepool.HostPageTier``) keeps hibernated
sessions through device-pool pressure, but they live in their owner's RAM:
a replica's death, drain or scale to zero loses them. This is the tier
under the arena — checkpoints on disk that any replica can restore, so a
session outlives the process that spilled it.

Crash-safety is by construction:

- The data file is a ``lstpu-kvmig-v2`` body (``serving/wire.py``: an
  8-byte preamble, then CRC32-preluded begin / page / commit frames), which
  ``decode_mig_frames`` parses and bounds-checks: a torn write fails a
  frame CRC or ends mid-prelude, and reads as a DEAD ENTRY — never as wrong
  KV, never as a hang. The format is the JAX package's byte for byte, so a
  directory written by either package restores in both.
- Writes are temp + fsync + rename, the data file BEFORE the manifest: the
  manifest is the commit record, so every crash phase leaves either a
  complete entry or debris that ``rehydrate`` reclaims. A data file
  without a manifest is an aborted checkpoint; a manifest without its data
  file is a dead entry.
- The manifest carries the SPILL-TIME per-page blake2b checksums
  (``pagepool.page_checksum``, stamped when the page left the device).
  Restore holds the read bytes against those stamps — rot is never
  laundered by a fresh hash over rotten bytes.

Every failure — torn file, CRC mismatch, checksum mismatch, stale or
missing manifest, slow or full disk — raises ``DurableError`` and marks the
entry dead; the engine's admission degrades to a cold prefill with a
``durable-restore-failed`` flight dump. The ``disk-torn`` /
``disk-corrupt`` / ``disk-stall`` / ``disk-full`` fault sites
(``serving/faultinject.py``) drill each rung.

The store moves opaque page byte images; splitting them into leaves and
recomputing checksums happen in the engine, where the pool layout lives.
The engine thread restores while the durable worker checkpoints: one lock
over the index.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Iterable, Optional

from langstream_tpu_torch.serving import wire

log = logging.getLogger(__name__)

# the manifest commit record, one per checkpoint: schema-tagged so a
# future layout change reads old entries as dead instead of as garbage
MANIFEST_SCHEMA = "lstpu-kvdur-v1"
# the replica hibernation record (one per directory, last writer wins)
HIBERNATE_SCHEMA = "lstpu-kvhib-v1"

DATA_SUFFIX = ".kvckpt"
MANIFEST_SUFFIX = ".json"
HIBERNATE_NAME = "hibernate.json"

# a checkpoint page never legitimately exceeds this (the largest real
# pool page is ~MiBs); a corrupt length prefix must bound allocation
MAX_PAGE_BYTES = 1 << 28


class DurableError(RuntimeError):
    """A durable-tier violation (torn/corrupt/missing checkpoint, stale
    manifest, full or stalled disk). Callers treat it exactly like a
    failed transfer: the entry is dead, the request prefills cold —
    it never implies wrong KV and never hangs the engine."""


def _fsync_dir(path: str) -> None:
    """fsync the directory so a rename survives power loss — best-effort
    (object-store mounts may not support directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class DurableStore:
    """Directory-backed checkpoint store for hibernated KV prefixes.

    One checkpoint = ``<digest>.kvckpt`` (the v2 frame stream) +
    ``<digest>.json`` (the manifest commit record). ``checkpoint`` runs on
    the engine's durable worker thread (and synchronously at hibernation);
    ``restore`` runs on the engine thread inside an admission; ``rehydrate``
    runs once at boot and reads MANIFESTS ONLY — resurrection cost is
    proportional to the index, not to the checkpointed bytes.

    ``max_bytes`` (0 = unbounded) is enforced after every checkpoint by
    evicting the least-recently-touched entries — the durable tier is a
    cache over re-prefill, so eviction is always safe, merely slow."""

    def __init__(
        self,
        root: str,
        max_bytes: int = 0,
        injector: Any = None,
    ) -> None:
        self.root = str(root)
        self.max_bytes = max(0, int(max_bytes))
        self._fault = injector
        self._lock = threading.Lock()
        # digest -> manifest dict (parsed, validated); the in-memory index
        self._index: dict[str, dict] = {}
        # counters (read under the lock by stats())
        self.checkpoints_total = 0
        self.checkpoint_bytes_total = 0
        self.checkpoint_failures_total = 0
        self.restores_total = 0
        self.restore_bytes_total = 0
        self.restore_failures_total = 0
        self.dead_entries_total = 0
        self.evictions_total = 0
        os.makedirs(self.root, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def _data_path(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}{DATA_SUFFIX}")

    def _manifest_path(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}{MANIFEST_SUFFIX}")

    # -- index ------------------------------------------------------------

    def contains(self, digest: str) -> bool:
        with self._lock:
            return str(digest) in self._index

    def entries(self) -> list[tuple[str, int]]:
        """(digest, prefix length) pairs of the live entries — the durable
        analogue of ``PrefixPageIndex.advertised``."""
        with self._lock:
            return [
                (d, int(m.get("length", 0)))
                for d, m in self._index.items()
            ]

    def bytes_on_disk(self) -> int:
        with self._lock:
            return sum(int(m.get("bytes", 0)) for m in self._index.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def _mark_dead(self, digest: str, why: str) -> None:
        """Drop a bad entry from the index AND the disk — a dead entry
        must never be re-advertised or re-tried on the next admission."""
        with self._lock:
            self._index.pop(digest, None)
            self.dead_entries_total += 1
        for path in (self._manifest_path(digest), self._data_path(digest)):
            try:
                os.unlink(path)
            except OSError:
                pass
        log.warning("durable entry %s marked dead (%s)", digest, why)

    def invalidate(self, digest: str, why: str) -> None:
        """Public kill switch for an entry the CALLER proved bad (e.g. a
        page failing its spill-time checksum after the split) — same
        dead-entry semantics as an internally detected failure."""
        with self._lock:
            self.restore_failures_total += 1
        self._mark_dead(digest, why)

    # -- rehydrate (boot) --------------------------------------------------

    def rehydrate(self) -> int:
        """Scan the directory and rebuild the index from manifests — the
        resurrection path. Manifests only: data
        bytes are verified lazily at restore time. Every malformed,
        orphaned or size-mismatched entry counts dead and is skipped —
        a dirty directory NEVER fails a boot. Returns live entries."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            log.exception("durable rehydrate: cannot list %s", self.root)
            return 0
        live = 0
        for name in names:
            if not name.endswith(MANIFEST_SUFFIX) or name == HIBERNATE_NAME:
                continue
            digest = name[: -len(MANIFEST_SUFFIX)]
            try:
                with open(os.path.join(self.root, name)) as f:
                    manifest = json.load(f)
                self._validate_manifest(manifest, digest)
                data = self._data_path(digest)
                size = os.stat(data).st_size
                if size != int(manifest["bytes"]):
                    raise DurableError(
                        f"data file is {size} bytes, manifest says "
                        f"{manifest['bytes']}"
                    )
            except FileNotFoundError:
                self._mark_dead(digest, "manifest without data file")
                continue
            except (OSError, ValueError, KeyError, DurableError) as e:
                self._mark_dead(digest, f"bad manifest: {e}")
                continue
            with self._lock:
                self._index[digest] = manifest
            live += 1
        # data files without a manifest are aborted checkpoints: reclaim
        for name in names:
            if not name.endswith(DATA_SUFFIX):
                continue
            digest = name[: -len(DATA_SUFFIX)]
            if not self.contains(digest):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass
        if live:
            log.info(
                "durable tier rehydrated %d session prefix(es) from %s",
                live, self.root,
            )
        return live

    @staticmethod
    def _validate_manifest(manifest: Any, digest: str) -> None:
        if not isinstance(manifest, dict):
            raise DurableError("manifest is not a record")
        if manifest.get("schema") != MANIFEST_SCHEMA:
            raise DurableError(
                f"unknown manifest schema {manifest.get('schema')!r}"
            )
        if manifest.get("digest") != digest:
            raise DurableError(
                f"manifest digest {manifest.get('digest')!r} does not "
                f"match its filename"
            )
        pages = manifest.get("pages")
        sums = manifest.get("checksums")
        if not isinstance(pages, int) or pages <= 0:
            raise DurableError("manifest has no page count")
        if not isinstance(sums, list) or len(sums) != pages:
            raise DurableError(
                f"manifest carries {len(sums) if isinstance(sums, list) else 0}"
                f" checksum(s) for {pages} page(s)"
            )
        for k in ("length", "bytes", "page_size", "bytes_per_page"):
            if not isinstance(manifest.get(k), int) or manifest[k] <= 0:
                raise DurableError(f"manifest field {k!r} missing or bad")

    # -- checkpoint (write) ------------------------------------------------

    def checkpoint(
        self,
        digest: str,
        length: int,
        tokens: Iterable[int],
        pages_raw: list[bytes],
        checksums: list[str],
        page_size: int,
        bytes_per_page: int,
    ) -> int:
        """Write one crash-safe checkpoint; returns bytes written. The
        ``checksums`` are the SPILL-TIME stamps (hex) — this method never
        re-hashes page bytes. Raises ``DurableError`` on any failure
        (counted); a failed checkpoint leaves no manifest, so the entry
        simply does not exist — the session stays restorable from its
        owner until a later attempt succeeds."""
        digest = str(digest)
        if len(pages_raw) != len(checksums) or not pages_raw:
            raise DurableError(
                f"checkpoint {digest}: {len(pages_raw)} page(s) vs "
                f"{len(checksums)} checksum(s)"
            )
        t0 = time.perf_counter()
        fault = self._fault
        try:
            if fault is not None and fault.fires("disk-full"):
                raise DurableError(
                    f"durable volume full ({self.root}) [injected: "
                    "disk-full]"
                )
            if fault is not None and fault.fires("disk-stall"):
                fault.stall("disk-stall")
            frames: list[dict] = [{
                "seq": 0, "kind": "begin", "length": int(length),
                "digest": digest, "pages": len(pages_raw),
                "page_size": int(page_size),
                "bytes_per_page": int(bytes_per_page),
                "tier": "durable",
                "prompt_tokens": [int(t) for t in tokens],
            }]
            for i, (raw, sum_hex) in enumerate(zip(pages_raw, checksums)):
                frames.append({
                    "seq": i + 1, "kind": "page", "i": i,
                    "raw": bytes(raw), "checksum": str(sum_hex),
                })
            frames.append({
                "seq": len(pages_raw) + 1, "kind": "commit",
                "pages_sent": len(pages_raw), "state": {},
            })
            body = wire.encode_mig_stream(frames)
            data_path = self._data_path(digest)
            tmp = data_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, data_path)
            # fault drills AFTER the write: the on-disk artifact is what a
            # real torn write / bit rot leaves, and the restore path must
            # read it as a dead entry — the manifest stays valid on purpose
            if fault is not None and fault.fires("disk-torn"):
                with open(data_path, "r+b") as f:
                    f.truncate(max(len(wire.KVMIG2_PREAMBLE) + 4,
                                   int(len(body) * 0.6)))
            if fault is not None and fault.fires("disk-corrupt"):
                with open(data_path, "r+b") as f:
                    f.seek(len(body) - max(2, len(body) // 3))
                    b = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]))
            manifest = {
                "schema": MANIFEST_SCHEMA,
                "digest": digest,
                "length": int(length),
                "pages": len(pages_raw),
                "page_size": int(page_size),
                "bytes_per_page": int(bytes_per_page),
                "bytes": len(body),
                "checksums": [str(s) for s in checksums],
                "created": round(time.time(), 3),
            }
            mpath = self._manifest_path(digest)
            mtmp = mpath + ".tmp"
            with open(mtmp, "w") as f:
                json.dump(manifest, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, mpath)
            _fsync_dir(self.root)
        except DurableError:
            with self._lock:
                self.checkpoint_failures_total += 1
            raise
        except Exception as e:  # noqa: BLE001 — every disk failure counts
            with self._lock:
                self.checkpoint_failures_total += 1
            raise DurableError(
                f"checkpoint {digest} failed after "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {e}"
            ) from e
        with self._lock:
            self._index[digest] = manifest
            self.checkpoints_total += 1
            self.checkpoint_bytes_total += len(body)
        self._evict_to_cap()
        return len(body)

    def _evict_to_cap(self) -> None:
        if not self.max_bytes:
            return
        while True:
            with self._lock:
                total = sum(
                    int(m.get("bytes", 0)) for m in self._index.values()
                )
                if total <= self.max_bytes or not self._index:
                    return
                victim = min(
                    self._index,
                    key=lambda d: self._index[d].get("created", 0.0),
                )
                self._index.pop(victim, None)
                self.evictions_total += 1
            for path in (
                self._manifest_path(victim), self._data_path(victim)
            ):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            log.info("durable tier evicted %s (cap %d bytes)",
                     victim, self.max_bytes)

    # -- restore (read) ----------------------------------------------------

    def restore(
        self, digest: str, timeout_s: Optional[float] = None
    ) -> dict:
        """Read + verify one checkpoint. Returns ``{"length", "tokens",
        "pages" (raw byte images), "checksums", "page_size",
        "bytes_per_page"}``. EVERY failure — missing entry, torn frame,
        CRC mismatch, stale manifest, deadline — marks the entry dead and
        raises ``DurableError``; per-page blake2b verification against the
        manifest stamps is the CALLER's job (it owns the leaf layout)."""
        digest = str(digest)
        with self._lock:
            manifest = self._index.get(digest)
        if manifest is None:
            with self._lock:
                self.restore_failures_total += 1
            raise DurableError(f"no durable entry for {digest}")
        deadline = (
            time.monotonic() + float(timeout_s) if timeout_s else None
        )
        fault = self._fault
        try:
            if fault is not None and fault.fires("disk-stall"):
                fault.stall("disk-stall")
            if deadline is not None and time.monotonic() > deadline:
                raise DurableError(
                    f"restore {digest} missed its {timeout_s}s deadline "
                    "(stalled volume)"
                )
            max_payload = min(
                MAX_PAGE_BYTES, max(1, int(manifest["bytes_per_page"])) * 2
            )
            pages: list[bytes] = []
            begin: Optional[dict] = None
            committed = False
            with open(self._data_path(digest), "rb") as f:
                preamble = f.read(len(wire.KVMIG2_PREAMBLE))
                if preamble != wire.KVMIG2_PREAMBLE:
                    raise DurableError(
                        f"bad checkpoint preamble {preamble!r}"
                    )
                for frame in wire.decode_mig_frames(f.read, max_payload):
                    if frame["kind"] == "begin":
                        begin = frame
                    elif frame["kind"] == "page":
                        i = int(frame["i"])
                        if i != len(pages):
                            raise DurableError(
                                f"page {i} out of order "
                                f"(expected {len(pages)})"
                            )
                        sums = manifest["checksums"]
                        if frame["checksum"] != sums[i]:
                            raise DurableError(
                                f"page {i} frame stamp does not match the "
                                "manifest (stale manifest or foreign data)"
                            )
                        pages.append(frame["raw"])
                    elif frame["kind"] == "commit":
                        committed = True
            if begin is None or not committed:
                raise DurableError(
                    "checkpoint stream has no begin/commit frame "
                    "(torn write)"
                )
            if begin.get("digest") != digest:
                raise DurableError(
                    f"checkpoint begins with digest "
                    f"{begin.get('digest')!r}, wanted {digest}"
                )
            if len(pages) != int(manifest["pages"]):
                raise DurableError(
                    f"checkpoint carries {len(pages)} page(s), manifest "
                    f"says {manifest['pages']}"
                )
            if deadline is not None and time.monotonic() > deadline:
                raise DurableError(
                    f"restore {digest} missed its {timeout_s}s deadline"
                )
        except DurableError as e:
            self._mark_dead(digest, str(e))
            with self._lock:
                self.restore_failures_total += 1
            raise
        except (OSError, wire.WireError, ValueError, KeyError) as e:
            self._mark_dead(digest, str(e))
            with self._lock:
                self.restore_failures_total += 1
            raise DurableError(
                f"restore {digest} failed: {e}"
            ) from e
        nbytes = sum(len(p) for p in pages)
        with self._lock:
            self.restores_total += 1
            self.restore_bytes_total += nbytes
            # touch for LRU: restored-recently is the worst eviction victim
            manifest["created"] = round(time.time(), 3)
        return {
            "length": int(manifest["length"]),
            "tokens": list(begin.get("prompt_tokens") or []),
            "pages": pages,
            "checksums": list(manifest["checksums"]),
            "page_size": int(manifest["page_size"]),
            "bytes_per_page": int(manifest["bytes_per_page"]),
        }

    # -- replica hibernation ----------------------------------------------

    def write_hibernation(
        self,
        replica_id: str,
        digests: Iterable[str],
        compile_cache_dir: Optional[str] = None,
    ) -> str:
        """The replica-level hibernation record: which replica went down
        on purpose, what it checkpointed, and where its compile cache
        lives — the resurrection drill's evidence that a clean exit (not
        a crash) produced this directory. Same temp+fsync+rename
        discipline as every other write here."""
        doc = {
            "schema": HIBERNATE_SCHEMA,
            "replica": str(replica_id),
            "at": round(time.time(), 3),
            "digests": sorted(str(d) for d in digests),
            "compile_cache_dir": compile_cache_dir,
        }
        path = os.path.join(self.root, HIBERNATE_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.root)
        return path

    def read_hibernation(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, HIBERNATE_NAME)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("schema") != HIBERNATE_SCHEMA:
            return None
        return doc

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "durable-entries": len(self._index),
                "durable-bytes-on-disk": sum(
                    int(m.get("bytes", 0)) for m in self._index.values()
                ),
                "durable-checkpoints-total": self.checkpoints_total,
                "durable-checkpoint-bytes-total": self.checkpoint_bytes_total,
                "durable-checkpoint-failures-total":
                    self.checkpoint_failures_total,
                "durable-restores-total": self.restores_total,
                "durable-restore-bytes-total": self.restore_bytes_total,
                "durable-restore-failures-total": self.restore_failures_total,
                "durable-dead-entries-total": self.dead_entries_total,
                "durable-evictions-total": self.evictions_total,
            }

    @staticmethod
    def empty_stats() -> dict[str, int]:
        """The stats() keys, all zero — engines with the tier off still
        publish the block (exporters set gauges unconditionally)."""
        return {
            "durable-entries": 0,
            "durable-bytes-on-disk": 0,
            "durable-checkpoints-total": 0,
            "durable-checkpoint-bytes-total": 0,
            "durable-checkpoint-failures-total": 0,
            "durable-restores-total": 0,
            "durable-restore-bytes-total": 0,
            "durable-restore-failures-total": 0,
            "durable-dead-entries-total": 0,
            "durable-evictions-total": 0,
        }
