"""The fleet across processes: the port's replica server and HTTP clients
against the JAX package's, on the CPU (tiny-test, f32, page 16).

- Codec: ``lstpu-frames-v2`` frames byte-equal to JAX's, each package
  decoding the other's stream; a migration pushed by either package's
  ``push_migration`` puts the same bytes on the wire and counts them the
  same (``wire_stats``).
- The port's ``RuntimeHttpServer`` (stdlib) in front of a port engine with
  the JAX ``HttpReplica`` as client, and the JAX server (aiohttp) in front
  of a JAX engine with the port's ``HttpReplica``: generate and streams in
  v1 and v2 give the JAX engine's tokens on the same weights
  (``models/bridge``); a shed answers 429 with ``Retry-After``; ``/state``
  validates under both packages.
- Migration over HTTP across packages (v1 and v2): a JAX router moves a
  JAX engine's prefix into a port replica, and a port router a port
  engine's into a JAX replica; the bound pages carry the sender's stamps
  and the decoded tokens are the JAX engine's unmigrated ones.
- P2P over HTTP between two port engines: the first fetch on the flat
  threshold, the second cost-routed (the beacon's ``prefill_tps`` and
  ``page_size``); the owner keeps its entry.
- Drills: ``net-connect``, ``net-cut``, ``net-stall``, ``net-corrupt`` fail
  the hop as JAX's do; a migration cut mid-body leaves the sender's copy and
  the receiver's free pages as they were.
- Cancel: a ``cancel-key`` cancelled in the router's process frees the
  remote slot (``POST /fleet/cancel``).
- The provider: ``fleet: auto`` with one peer gives the JAX provider's
  chunks; ``begin_drain`` empties ``/state`` before the engine drains.
- The standalone replica (``python -m langstream_tpu_torch.serving.fleet``)
  as a subprocess: its start line, one generate, a clean exit on stdin
  close with its exit line.
"""

import asyncio
import contextlib
import dataclasses
import functools
import http.server
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from langstream_tpu.ai import tpu_serving as jserving
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.runtime.http_server import RuntimeHttpServer as JaxServer
from langstream_tpu.serving import fleet as jfleet
from langstream_tpu.serving import migrate as jmig
from langstream_tpu.serving import wire as jwire
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.faultinject import FaultInjector as JaxInjector
from langstream_tpu_torch.ai import torch_serving as tserving
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.runtime.http_server import RuntimeHttpServer
from langstream_tpu_torch.serving import fleet as tfleet
from langstream_tpu_torch.serving import lifecycle
from langstream_tpu_torch.serving import migrate as tmig
from langstream_tpu_torch.serving import wire as twire
from langstream_tpu_torch.serving.engine import ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.pagepool import np_view, page_checksum, pool_leaves
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parents[1]
WAIT = 60.0
KW = dict(max_batch=2, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32, 64),
          page_size=16)


def prompt_for(base: int, n: int = 40) -> list:
    return [base + (3 * i) % 50 for i in range(n)]


@functools.lru_cache(maxsize=None)
def configs():
    return (dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32"))


@functools.lru_cache(maxsize=None)
def weights():
    jp = jax_init_params(configs()[0], jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), configs()[1], device="cpu")


def port_engine(**kw) -> ServingEngine:
    for k, v in dict(KW, prefix_cache="auto").items():
        kw.setdefault(k, v)
    engine = ServingEngine(configs()[1], weights()[1], device="cpu", **kw)
    engine.start()
    return engine


def jax_engine(**kw) -> JaxEngine:
    for k, v in dict(KW, prefix_cache="auto").items():
        kw.setdefault(k, v)
    engine = JaxEngine(configs()[0], weights()[0], kv_layout="paged", **kw)
    engine.start()
    return engine


def register(mod, rid: str, engine, role: str = "mixed", caps_drop=()) -> None:
    """Register ``engine`` in ``mod``'s process registry as the provider of
    that package registers its own (``caps_drop`` strips beacon caps: a
    legacy peer)."""
    def beacon():
        doc = mod.beacon_from_engine(rid, engine, role=role)
        doc["caps"] = [c for c in doc["caps"] if c not in caps_drop]
        return doc

    mod.register_local(
        rid, beacon_fn=beacon,
        generate_fn=lambda p: mod.engine_generate(engine, p),
        generate_stream_fn=lambda p: mod.engine_generate_stream(engine, p),
        migrate_bind_fn=lambda frames, timeout_s=30.0: mod.engine_migrate_bind(
            engine, frames, timeout_s),
        migrate_out_fn=lambda p: mod.engine_migrate_out(engine, p),
        migrate_pages_fn=lambda p: mod.engine_migrate_pages(engine, p),
        p2p_fetch_fn=lambda p: mod.engine_p2p_fetch(engine, p),
        migrate_limits_fn=engine.migrate_limits,
        reset_fn=engine.reset_histograms,
    )


@contextlib.contextmanager
def serving(mod, engine, rid: str, **kw):
    register(mod, rid, engine, **kw)
    try:
        yield
    finally:
        mod.unregister_local(rid)


@pytest.fixture(scope="module")
def port_server():
    server = RuntimeHttpServer(metrics_text=lambda: "", agents_info=lambda: [], port=0)
    server.start()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def jax_server():
    loop = asyncio.new_event_loop()
    server = JaxServer(metrics_text=lambda: "", agents_info=lambda: [], port=0)
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(10)
    yield server
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=10)
    loop.close()


@pytest.fixture(scope="module")
def engines():
    """A port engine and a JAX engine on the same weights (prefix reuse on),
    a JAX engine with reuse off (a prompt's unmigrated tokens, alone), and a
    port engine whose tokens trickle (the ``client`` stall) for the drills."""
    out = {"port": port_engine(), "jax": jax_engine(), "ref": jax_engine(prefix_cache="off"),
           "slow": port_engine(fault_injector=FaultInjector("client@1+", seed=0, stall_s=0.05))}
    yield out
    for e in out.values():
        e.stop()


@functools.lru_cache(maxsize=None)
def _ref_cache():
    return {}


def reference(engines, prompt, new: int = 6) -> list:
    key = (tuple(prompt), new)
    if key not in _ref_cache():
        _ref_cache()[key] = engines["ref"].generate(
            list(prompt), JaxOptions(max_new_tokens=new, temperature=0.0), timeout=WAIT).tokens
    return _ref_cache()[key]


@pytest.fixture(autouse=True)
def _clean_wire():
    tfleet.set_wire_injector(None)
    jfleet.set_wire_injector(None)
    yield
    tfleet.set_wire_injector(None)
    jfleet.set_wire_injector(None)


def drain_frames(frames) -> tuple[list, list]:
    out, tokens = [], []
    for i, frame in enumerate(frames):
        assert frame.get("seq") == i
        out.append(frame)
        if frame.get("kind") == "tokens":
            tokens.extend(int(t) for t in frame["tokens"])
    return out, tokens


def leak_free(engine) -> None:
    pool = engine._pagepool
    slot_pages = sum(len(pool.slot_pages(i)) for i in range(engine.max_batch))
    assert pool.pages_in_use <= engine._prefix_index.pages_held + slot_pages
    assert pool.free_pages + pool.pages_in_use == pool.num_pages


# -- the codec ----------------------------------------------------------------

FRAMES = {
    "tokens": {"v": "lstpu-frames-v1", "seq": 0, "kind": "tokens", "tokens": [5, 70000, 0, 2**31 - 1]},
    "tokens-dfa": {"seq": 3, "kind": "tokens", "tokens": [9], "dfa_state": 17},
    "heartbeat": {"seq": 1, "kind": "heartbeat"},
    "end": {"seq": 7, "kind": "end", "finish_reason": "length", "prompt_tokens": 40,
            "ttft_s": 0.01, "total_s": 0.2, "usage": {"prompt_tokens": 40, "completion_tokens": 6}},
    "error": {"seq": 2, "kind": "error", "error": "engine died"},
}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_stream_frame_bytes_equal_to_jax(kind):
    frame = FRAMES[kind]
    got = twire.encode_stream_frame(frame)
    assert got == jwire.encode_stream_frame(frame)
    assert twire.FRAMES2_PREAMBLE == jwire.FRAMES2_PREAMBLE


def _reader(data: bytes):
    pos = 0

    def read(n: int) -> bytes:
        nonlocal pos
        chunk = data[pos:pos + n]
        pos += len(chunk)
        return chunk

    return read


def test_streams_decode_across_packages():
    rng = np.random.default_rng(3)
    frames = [{"seq": i, "kind": "tokens", "tokens": rng.integers(0, 128256, 4).tolist()}
              for i in range(5)]
    frames.append({"seq": 5, "kind": "heartbeat"})
    frames.append(dict(FRAMES["end"], seq=6))
    for enc, dec in ((twire, jwire), (jwire, twire)):
        body = b"".join(enc.encode_stream_frame(f) for f in frames)
        assert list(dec.decode_stream_frames(_reader(body))) == [
            {k: v for k, v in f.items() if k != "v"} for f in frames
        ]
        # a flipped payload byte fails the CRC in both packages
        bad = bytearray(body)
        bad[jwire.PRELUDE.size + 1] ^= 0xFF
        with pytest.raises(dec.WireError, match="CRC32"):
            list(dec.decode_stream_frames(_reader(bytes(bad))))


class _Sink:
    """A receiver that keeps every migration body it is sent and ACKs."""

    def __init__(self) -> None:
        sink = self
        self.bodies: list[bytes] = []

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                body = bytearray()
                while True:
                    size = int(self.rfile.readline().strip() or b"0", 16)
                    if not size:
                        self.rfile.readline()
                        break
                    body += self.rfile.read(size)
                    self.rfile.readline()
                sink.bodies.append(bytes(body))
                out = b'{"ok": true, "length": 32, "pages": 2, "bytes": 1}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_push_migration_puts_jax_bytes_on_the_wire(engines, wire):
    """The same frames pushed by each package: equal bodies, equal wire
    byte counts."""
    eng = engines["port"]
    prompt = prompt_for(31)
    eng.generate(prompt, GenerationOptions(max_new_tokens=2), timeout=WAIT)
    frames = list(tmig.export_frames(eng, prompt, raw=wire == "v2", state={"sampling": {}}))
    sink = _Sink()
    try:
        deltas = []
        for mod, wmod in ((tmig, twire), (jmig, jwire)):
            before = wmod.wire_stats()
            ack = mod.push_migration(sink.url, iter(frames), 10.0, wire=wire)
            assert ack["ok"]
            after = wmod.wire_stats()
            deltas.append({k: after[k] - before[k] for k in after})
    finally:
        sink.srv.shutdown()
        sink.srv.server_close()
    assert sink.bodies[0] == sink.bodies[1]
    assert deltas[0] == deltas[1] and deltas[0][wire] == len(sink.bodies[0]) > 0
    if wire == "v2":
        assert sink.bodies[0].startswith(twire.KVMIG2_PREAMBLE)


# -- the engine's stats keys (F10) -------------------------------------------

# JAX keys the port does not report: the fused-iteration switch of the XLA
# engine (``overlap``; the port always fuses) and, on the dense layout, the
# page counts (the port reports the cache's bytes there instead)
NOT_PORTED = {"overlap"}
DENSE_ONLY_JAX = {"kv-pages-total", "kv-pages-in-use"}


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_stats_keys_match_jax(layout):
    kw = dict(KW, prefix_cache="off", kv_layout=layout)
    port = ServingEngine(configs()[1], weights()[1], device="cpu", **kw)
    jeng = JaxEngine(configs()[0], weights()[0], **kw)
    port.start()
    jeng.start()
    try:
        prompt = prompt_for(3)
        port.generate(prompt, GenerationOptions(max_new_tokens=6), timeout=WAIT)
        jeng.generate(prompt, JaxOptions(max_new_tokens=6), timeout=WAIT)
        got, want = port.stats(), jeng.stats()
    finally:
        port.stop()
        jeng.stop()
    skip = NOT_PORTED | (DENSE_ONLY_JAX if layout == "dense" else set())
    assert set(want) - set(got) == skip
    # decode steps dispatched: two chunks of 4 here (JAX's pipelined loop
    # dispatches one chunk ahead, so its count runs past the tokens it needs)
    assert got["busy-steps"] == got["decode-steps-total"] == 8 <= want["busy-steps"]
    assert got["long-prefill-active"] is want["long-prefill-active"] is False
    assert got["page-size"] == want["page-size"] == (16 if layout == "paged" else 0)
    assert got["decode-step-ms"] > 0 and got["hbm-gbps-decode"] > 0


# -- generate across packages -------------------------------------------------

CASES = [("v1", False), ("v1", True), ("v2", False), ("v2", True)]


def _hop(replica, prompt, wire: str, stream: bool) -> list:
    replica.fetch_beacon()
    if wire == "v1":
        replica.caps = frozenset()  # a peer not known to speak frames-v2
    else:
        assert "frames2" in replica.caps
    opts = {"max-tokens": 6, "temperature": 0.0}
    if stream:
        frames, tokens = drain_frames(replica.generate_stream(prompt, opts))
        assert frames[-1]["kind"] == "end" and frames[-1]["usage"]["completion_tokens"] == 6
        return tokens
    return replica.generate(prompt, opts)["tokens"]


@pytest.mark.parametrize("wire, stream", CASES, ids=[f"{w}-{'stream' if s else 'oneshot'}"
                                                     for w, s in CASES])
def test_jax_client_port_server(engines, port_server, wire, stream):
    prompt = prompt_for(7)
    before = twire.wire_stats()
    with serving(tfleet, engines["port"], "port-r"):
        tokens = _hop(jfleet.HttpReplica("port-r", port_server.url), prompt, wire, stream)
    assert tokens == reference(engines, prompt)
    assert twire.wire_stats()[wire] > before[wire]


@pytest.mark.parametrize("wire, stream", CASES, ids=[f"{w}-{'stream' if s else 'oneshot'}"
                                                     for w, s in CASES])
def test_port_client_jax_server(engines, jax_server, wire, stream):
    prompt = prompt_for(8)
    with serving(jfleet, engines["jax"], "jax-r"):
        tokens = _hop(tfleet.HttpReplica("jax-r", jax_server.url), prompt, wire, stream)
    assert tokens == reference(engines, prompt)


@pytest.mark.parametrize("side", ["port-server", "jax-server"])
def test_shed_answers_429_with_retry_after(engines, port_server, jax_server, side):
    """A draining engine sheds: the server answers 429 + Retry-After, and the
    other package's client raises FleetShedError with that retry-after."""
    smod, cmod, eng, server = (
        (tfleet, jfleet, engines["port"], port_server) if side == "port-server"
        else (jfleet, tfleet, engines["jax"], jax_server)
    )
    body = json.dumps({"prompt_tokens": prompt_for(5), "options": {"max-tokens": 2},
                       "stream": True}).encode()
    with serving(smod, eng, "shed-r"):
        eng._draining = True
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(
                    server.url + "/fleet/generate", data=body,
                    headers={"Content-Type": "application/json"}, method="POST"), timeout=10)
            assert err.value.code == 429
            assert float(err.value.headers["Retry-After"]) == pytest.approx(5.0)
            assert json.loads(err.value.read())["error"] == "shed"
            with pytest.raises(cmod.FleetShedError) as shed:
                cmod.HttpReplica("shed-r", server.url).generate(prompt_for(5), {"max-tokens": 2})
            assert shed.value.retry_after_s == pytest.approx(5.0)
        finally:
            eng._draining = False


def test_state_and_healthz_validate_under_both_packages(engines, port_server):
    with serving(tfleet, engines["port"], "state-r", role="decode"):
        with urllib.request.urlopen(port_server.url + "/state", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("application/json")
            doc = json.loads(r.read())
        with urllib.request.urlopen(port_server.url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
    assert doc["schema"] == jfleet.STATE_SCHEMA and len(doc["replicas"]) == 1
    beacon = doc["replicas"][0]
    assert tfleet.validate_beacon(beacon) and jfleet.validate_beacon(beacon)
    assert beacon["role"] == "decode" and beacon["page_size"] == 16
    assert {"kvmig2", "frames2", "p2p"} <= set(beacon["caps"])
    assert health == {"status": "OK", "recovering": False, "restoring": False}
    with urllib.request.urlopen(port_server.url + "/state", timeout=10) as r:
        assert json.loads(r.read())["replicas"] == []


# -- migration over HTTP across packages ---------------------------------------


class _Stamps:
    """Taps a package's ``export_frames``: the stamps of the page frames the
    sender ships."""

    def __init__(self, mod, monkeypatch) -> None:
        self.stamps: list = []
        real = mod.export_frames

        def export(*a, **kw):
            def tap(frames):
                for f in frames:
                    if f.get("kind") == "page":
                        self.stamps.append(f["checksum"])
                    yield f
            return tap(real(*a, **kw))

        monkeypatch.setattr(mod, "export_frames", export)


def _port_page_stamps(engine, prompt) -> list:
    _, entry = engine._prefix_index.deepest_entry(list(prompt) + [0])
    leaves = pool_leaves(engine._pagepool.dev)
    return [page_checksum([np_view(leaf[:, p]) for leaf in leaves]).hex() for p in entry.pages]


def _jax_page_stamps(engine, prompt) -> list:
    from langstream_tpu.serving.pagepool import page_checksum

    _, entry = engine._prefix_index.deepest_entry(list(prompt) + [0])
    leaves = jax.tree.leaves(engine._pagepool.dev)
    return [page_checksum([np.asarray(leaf[:, p]) for leaf in leaves]).hex()
            for p in entry.pages]


def _disagg(mod, pre, dec, prompt) -> tuple:
    router = mod.FleetRouter([pre, dec], refresh_interval_s=3600.0, prefill_route_threshold=32)
    router.refresh_all()
    frames, tokens = drain_frames(router.stream_generate(
        list(prompt), {"max-tokens": 6, "temperature": 0.0}))
    return router, frames, tokens


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_jax_router_migrates_into_port_replica(engines, port_server, monkeypatch, wire):
    prompt = prompt_for(21)
    want = reference(engines, prompt)
    jeng, peng = engines["jax"], engines["port"]
    tap = _Stamps(jmig, monkeypatch)
    drop = () if wire == "v2" else ("kvmig2", "frames2")
    v2_before = twire.wire_stats()["v2"]
    free0 = peng._pagepool.free_pages
    with serving(tfleet, peng, "dec", role="decode", caps_drop=drop):
        router, frames, tokens = _disagg(
            jfleet, jfleet.InProcessReplica("pre", jeng, role="prefill"),
            jfleet.HttpReplica("dec", port_server.url), prompt)
    st = router.stats()
    assert tokens == want
    assert st["fleet-migrations-total"] == 1 and st["fleet-migrate-fallbacks-total"] == 0
    assert {f.get("replica") for f in frames if f["kind"] == "tokens"} == {"pre", "dec"}
    # the port replica holds the pages the JAX sender stamped; the sender
    # released on the ACK
    assert tap.stamps and _port_page_stamps(peng, prompt) == tap.stamps
    assert jeng._prefix_index.deepest_entry(list(prompt)) is None
    assert (twire.wire_stats()["v2"] > v2_before) == (wire == "v2")
    peng.migrate_release(prompt, 32)
    assert peng._pagepool.free_pages == free0
    leak_free(peng)


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_port_router_migrates_into_jax_replica(engines, jax_server, monkeypatch, wire):
    prompt = prompt_for(22)
    want = reference(engines, prompt)
    jeng, peng = engines["jax"], engines["port"]
    tap = _Stamps(tmig, monkeypatch)
    drop = () if wire == "v2" else ("kvmig2", "frames2")
    v2_before = twire.wire_stats()["v2"]
    with serving(jfleet, jeng, "dec", role="decode", caps_drop=drop):
        router, frames, tokens = _disagg(
            tfleet, tfleet.InProcessReplica("pre", peng, role="prefill"),
            tfleet.HttpReplica("dec", jax_server.url), prompt)
    st = router.stats()
    assert tokens == want
    assert st["fleet-migrations-total"] == 1 and st["fleet-migrate-fallbacks-total"] == 0
    assert tap.stamps and _jax_page_stamps(jeng, prompt) == tap.stamps
    assert peng._prefix_index.deepest_entry(list(prompt)) is None
    assert (twire.wire_stats()["v2"] > v2_before) == (wire == "v2")
    jeng.migrate_release(prompt, 32)
    leak_free(peng)


@pytest.mark.parametrize("owner", ["port", "jax"])
def test_fetch_pages_across_packages(engines, port_server, jax_server, owner):
    """One package's ``fetch_pages`` pulls a prefix from the other's
    ``/fleet/pages`` and binds it into its own engine, which then serves the
    prompt warm with the JAX engine's tokens; the owner keeps its entry.
    v2 both ways; v1 (a legacy owner's NDJSON) with the port's client only:
    JAX's client reads any content type naming json as a refusal, so it
    refuses ``application/x-ndjson`` (ROADMAP §3, observed in the
    reference)."""
    prompt = prompt_for(25, 70)
    want = reference(engines, prompt)
    if owner == "port":
        omod, server, oeng, cmig, ceng = tfleet, port_server, engines["port"], jmig, engines["jax"]
        copts = JaxOptions
    else:
        omod, server, oeng, cmig, ceng = jfleet, jax_server, engines["jax"], tmig, engines["port"]
        copts = GenerationOptions
    oeng.generate(prompt, (GenerationOptions if owner == "port" else JaxOptions)(
        max_new_tokens=1), timeout=WAIT)
    with serving(omod, oeng, "owner"):
        for wire in ("v1", "v2") if cmig is tmig else ("v2",):
            frames = list(cmig.fetch_pages(server.url, prompt, 10.0, wire=wire))
            assert [f["kind"] for f in frames] == ["begin"] + ["page"] * 4 + ["commit"]
            assert (frames[1].get("raw") is not None) == (wire == "v2")
        saved = ceng.stats()["prefill-tokens-saved-total"]
        ack = cmig.bind_frames(ceng, iter(frames), timeout_s=10.0)
    assert ack["ok"] and ack["length"] == 64 and ack["pages"] == 4
    assert oeng._prefix_index.deepest_entry(prompt) is not None
    out = ceng.generate(prompt, copts(max_new_tokens=6, temperature=0.0), timeout=WAIT).tokens
    assert list(out) == want
    assert ceng.stats()["prefill-tokens-saved-total"] - saved == 64
    ceng.migrate_release(prompt, 64)
    oeng.migrate_release(prompt, 64)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_cancel_forwarded_across_packages(engines, port_server, jax_server, direction):
    """The two packages' cancel registries are separate modules, so in one
    process a forward is a real hop: one package's ``lifecycle.cancel``
    POSTs ``/fleet/cancel`` to the other's server, whose engine ends the
    stream ``cancelled`` at its next chunk and frees the slot."""
    from langstream_tpu.serving import lifecycle as jlifecycle

    if direction == "jax-to-port":
        smod, server, eng, cmod, clife = tfleet, port_server, engines["slow"], jfleet, jlifecycle
    else:
        eng = jax_engine(fault_injector=JaxInjector("client@1+", seed=0, stall_s=0.05))
        smod, server, cmod, clife = jfleet, jax_server, tfleet, lifecycle
    key = f"sess-{direction}"
    try:
        with serving(smod, eng, "r"):
            frames = []
            for frame in cmod.HttpReplica("r", server.url).generate_stream(
                    prompt_for(26), {"max-tokens": 60, "temperature": 0.0, "cancel-key": key}):
                frames.append(frame)
                if len([f for f in frames if f["kind"] == "tokens"]) == 2 and not any(
                        f.get("forwarded") for f in frames):
                    clife.register_remote(key, server.url)
                    assert clife.cancel(key) == 0
                    frames.append({"kind": "mark", "forwarded": True})
            clife.unregister_remote(key, server.url)
        end = frames[-1]
        assert end["kind"] == "end" and end["finish_reason"] == "cancelled"
        assert end["usage"]["completion_tokens"] < 60
        _slot_freed(eng)
    finally:
        if direction == "port-to-jax":
            eng.stop()


# -- P2P fetch over HTTP ------------------------------------------------------


def test_p2p_fetch_over_http_is_cost_routed(port_server, monkeypatch):
    """Owner a (behind the port's server) publishes two 64-token prefixes;
    the router routes both prompts to b (a is loaded) and fetches each
    prefix over ``POST /fleet/pages``: the first on the flat threshold (no
    bandwidth seen yet), the second by the cost model, whose inputs — b's
    ``prefill_tps``, a's ``page_size`` and ``bytes_per_page`` — the beacons
    now carry (F9). The owner keeps its entries."""
    a, b = port_engine(max_seq_len=128), port_engine(max_seq_len=128)
    try:
        p1, p2 = prompt_for(40, 70), prompt_for(41, 70)
        for p in (p1, p2):
            a.generate(p, GenerationOptions(max_new_tokens=2), timeout=WAIT)
        b.generate(prompt_for(42, 70), GenerationOptions(max_new_tokens=2), timeout=WAIT)
        # b's measured prefill is what a fetch competes with: make the
        # fetch the cheaper one whatever this host's timings are
        monkeypatch.setattr(b, "prefill_tps_estimate", lambda: 1.0)
        with serving(tfleet, a, "a"):
            router = tfleet.FleetRouter(
                [tfleet.HttpReplica("a", port_server.url), tfleet.InProcessReplica("b", b)],
                refresh_interval_s=3600.0, p2p_threshold=32, lam=16.0)
            router.refresh_all()
            beacon = router._replicas["a"].beacon
            assert beacon["page_size"] == 16 and beacon["bytes_per_page"] > 0
            assert router._replicas["b"].beacon["prefill_tps"] == 1.0
            saved = b.stats()["prefill-tokens-saved-total"]
            outs = []
            for p in (p1, p2):
                router._replicas["a"].beacon["load_score"] = 50.0
                frames, tokens = drain_frames(router.stream_generate(
                    p, {"max-tokens": 4, "temperature": 0.0}))
                outs.append((frames, tokens))
                router.refresh_all()
        st = router.stats()
        assert st["fleet-p2p-fetch-total"] == 2 and st["fleet-p2p-fetch-fallback-total"] == 0
        assert router.p2p_cost_routed_total == 1  # the second fetch
        assert b.stats()["prefill-tokens-saved-total"] - saved == 2 * 64
        assert all(a._prefix_index.deepest_entry(p) is not None for p in (p1, p2))
        for p, (frames, tokens) in zip((p1, p2), outs):
            assert {f["replica"] for f in frames if f["kind"] == "tokens"} == {"b"}
            assert tokens == a.generate(p, GenerationOptions(max_new_tokens=4),
                                        timeout=WAIT).tokens
        leak_free(a)
        leak_free(b)
    finally:
        a.stop()
        b.stop()


# -- drills -------------------------------------------------------------------

PROMPT = prompt_for(9)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_net_cut_resets_mid_stream(engines, port_server, client):
    mod = tfleet if client == "port" else jfleet
    tfleet.set_wire_injector(FaultInjector("net-cut@4", seed=0))
    tokens = []
    with serving(tfleet, engines["slow"], "slow"):
        with pytest.raises(mod.ReplicaError):
            for frame in mod.HttpReplica("slow", port_server.url).generate_stream(
                    PROMPT, {"max-tokens": 50, "temperature": 0.0}):
                if frame.get("kind") == "tokens":
                    tokens.extend(frame["tokens"])
    assert 0 < len(tokens) < 50
    assert tfleet.wire_injector().fired["net-cut"] == 1
    _slot_freed(engines["slow"])


def _slot_freed(engine) -> None:
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and engine.stats()["active-slots"]:
        time.sleep(0.05)
    assert engine.stats()["active-slots"] == 0, "an abandoned stream kept its slot"


@pytest.mark.parametrize("client, wire", [("port", "v1"), ("port", "v2"), ("jax", "v2")])
def test_net_corrupt_frame_fails_the_hop(engines, port_server, client, wire):
    mod = tfleet if client == "port" else jfleet
    tfleet.set_wire_injector(FaultInjector("net-corrupt@3", seed=0))
    with serving(tfleet, engines["slow"], "slow"):
        replica = mod.HttpReplica("slow", port_server.url)
        replica.fetch_beacon()
        if wire == "v1":
            replica.caps = frozenset()
        with pytest.raises(mod.ReplicaError, match="corrupt|sequence"):
            list(replica.generate_stream(PROMPT, {"max-tokens": 50, "temperature": 0.0}))
    _slot_freed(engines["slow"])


@pytest.mark.parametrize("client", ["port", "jax"])
def test_net_stall_trips_the_idle_timeout(engines, port_server, client):
    mod = tfleet if client == "port" else jfleet
    tfleet.set_wire_injector(FaultInjector("net-stall@2", seed=0, stall_s=3.0))
    with serving(tfleet, engines["slow"], "slow"):
        t0 = time.monotonic()
        with pytest.raises(mod.ReplicaError, match="read failed|timed out"):
            list(mod.HttpReplica("slow", port_server.url).generate_stream(
                PROMPT, {"max-tokens": 50, "temperature": 0.0}, idle_timeout_s=0.5))
        took = time.monotonic() - t0
    assert took < 2.5
    _slot_freed(engines["slow"])


def test_net_connect_refuses_once(engines, port_server):
    tfleet.set_wire_injector(FaultInjector("net-connect@1", seed=0))
    with serving(tfleet, engines["port"], "r"):
        replica = tfleet.HttpReplica("r", port_server.url)
        with pytest.raises(tfleet.ReplicaError, match="net-connect"):
            list(replica.generate_stream(PROMPT, {"max-tokens": 4}))
        _, tokens = drain_frames(replica.generate_stream(
            PROMPT, {"max-tokens": 4, "temperature": 0.0}))
    assert len(tokens) == 4 and tfleet.wire_injector().fired["net-connect"] == 1


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_migration_cut_mid_body_leaves_both_pools(engines, port_server, wire):
    """``net-cut@2`` ends the sender's frames after one page: the push dies
    mid-body, the stream decodes in place on the sender with its tokens,
    the sender keeps its entry and the receiver's free pages are as they
    were."""
    prompt = prompt_for(23)
    want = reference(engines, prompt)
    pre = port_engine()
    dec = engines["port"]
    try:
        free0 = dec._pagepool.free_pages
        tfleet.set_wire_injector(FaultInjector("net-cut@2", seed=0))
        drop = () if wire == "v2" else ("kvmig2", "frames2")
        with serving(tfleet, dec, "dec", role="decode", caps_drop=drop):
            router, frames, tokens = _disagg(
                tfleet, tfleet.InProcessReplica("pre", pre, role="prefill"),
                tfleet.HttpReplica("dec", port_server.url), prompt)
        st = router.stats()
        assert tokens == want
        assert st["fleet-migrations-total"] == 0 and st["fleet-migrate-fallbacks-total"] == 1
        assert {f["replica"] for f in frames if f["kind"] == "tokens"} == {"pre"}
        assert "net-cut" in router._flight.last_dump["extra"]["error"]
        assert pre._prefix_index.deepest_entry(list(prompt)) is not None
        assert dec._pagepool.free_pages == free0
        assert dec._prefix_index.deepest_entry(list(prompt)) is None
        leak_free(pre)
        leak_free(dec)
    finally:
        pre.stop()


# -- cancel across processes --------------------------------------------------


def test_remote_registry_and_wire_counters_hold_under_threads():
    """Overlapping requests of one session register and unregister their
    owner from many threads, and every sender counts its bytes: with a
    shortened switch interval a lost update would leave an owner behind or
    a count short."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = twire.wire_stats()["v1"]

    def work(i: int) -> None:
        for _ in range(300):
            lifecycle.register_remote("stress", f"http://127.0.0.1:{i % 3 + 1}")
            twire.count_wire_bytes("v1", 3)
            lifecycle.unregister_remote("stress", f"http://127.0.0.1:{i % 3 + 1}")

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert "stress" not in lifecycle._remote_by_key
    assert twire.wire_stats()["v1"] - before == 16 * 300 * 3


def test_cancel_forward_to_a_dead_peer_is_best_effort():
    lifecycle.register_remote("gone", "http://127.0.0.1:9")
    try:
        assert lifecycle.cancel("gone") == 0
    finally:
        lifecycle.unregister_remote("gone", "http://127.0.0.1:9")
    assert "gone" not in lifecycle._remote_by_key


# -- the provider -------------------------------------------------------------


@pytest.fixture
def f32_presets(monkeypatch):
    monkeypatch.setitem(JAX_PRESETS, "tiny-test", configs()[0])
    monkeypatch.setitem(MODEL_PRESETS, "tiny-test", configs()[1])


PROVIDER = {"model": "tiny-test", "max-batch": 2, "max-seq-len": 128, "decode-chunk": 4,
            "prefill-buckets": [16, 32, 64], "page-size": 16, "prefix-cache": "auto",
            "fleet": "auto", "fleet-refresh-interval-s": 3600}


def _collect(svc, prompt: str, opts: dict):
    chunks = []
    res = asyncio.run(svc.get_text_completions([prompt], opts, chunks.append))
    return res, [(c.content, c.index, c.last) for c in chunks]


def test_provider_fleet_dispatch_gives_the_jax_providers_chunks(
        engines, port_server, jax_server, f32_presets):
    """Each package's provider with ``fleet: auto`` and one peer (its own
    package's engine behind its own package's server) routes a prompt the
    peer holds to the peer and streams its frames as chunks: the chunks and
    the result equal the JAX provider's."""
    text = "user: the fleet wire carries frames from one process to another one\nassistant:"
    opts = {"max-tokens": 8, "temperature": 0.0, "min-chunks-per-message": 4}
    out = {}
    for name, prov_mod, fmod, server, peer in (
        ("port", tserving, tfleet, port_server, engines["port"]),
        ("jax", jserving, jfleet, jax_server, engines["jax"]),
    ):
        svc_cls = tserving.TorchServingProvider if name == "port" else jserving.TpuServingProvider
        cfg = dict(PROVIDER, **({"device": "cpu"} if name == "port" else {}),
                   **{"fleet-replicas": [{"id": "peer", "url": server.url}], "fleet-lambda": 1})
        provider = svc_cls(cfg)
        svc = provider.get_completions_service({})
        holder = svc if name == "port" else svc.holder
        holder._params = weights()[1] if name == "port" else weights()[0]
        # the peer holds the prompt's prefix: affinity routes there
        tokens = holder.tokenizer.encode(text) if name == "port" else holder.tokenizer().encode(text)
        peer.generate(tokens, (GenerationOptions if name == "port" else JaxOptions)(
            max_new_tokens=1), timeout=WAIT)
        with serving(fmod, peer, "peer"):
            res, chunks = _collect(svc, text, opts)
            stats = svc.fleet_stats()
        asyncio.run(provider.close())
        out[name] = (res.content, res.finish_reason, res.completion_tokens, chunks,
                     stats["fleet-routed-affinity-total"], stats["fleet-replica-count"])
    assert out["port"] == out["jax"]
    assert out["port"][3] and out["port"][3][-1][2] and out["port"][4:] == (1, 2)


def test_provider_serves_the_fleet_keys(engines, port_server, f32_presets):
    """The keys the port refused before (``fleet*``, ``cancel-key``) are
    served: ``fleet-role`` builds the migration staging, the router gets the
    JAX provider's knobs, a bad role or mode raises, ``mesh`` stays refused."""
    cfg = dict(PROVIDER, device="cpu", **{
        "fleet-role": "prefill", "fleet-replicas": [port_server.url], "fleet-lambda": 64,
        "fleet-policy": "least-loaded", "fleet-prefill-threshold": 96, "fleet-migrate": "off",
        "fleet-migrate-timeout-s": 7, "fleet-p2p": "off", "fleet-p2p-threshold": 128,
        "fleet-replica-id": "me", "fleet-self-url": "http://me:1"})
    svc = tserving.TorchCompletionsService(cfg)
    svc._params = weights()[1]
    try:
        router = svc.fleet_router()
        assert router.lam == 64 and router.policy == "least-loaded"
        assert router.prefill_route_threshold == 96 and not router.migrate_enabled
        assert router.migrate_timeout_s == 7 and not router.p2p_enabled
        assert router.p2p_threshold == 128
        assert [r.handle.replica_id for r in router._replicas.values()] == ["me", port_server.url]
        assert svc.engine()._mig_stage is not None
        beacon = tfleet.local_state()["replicas"][0]
        assert beacon["id"] == "me" and beacon["role"] == "prefill"
        assert beacon["url"] == "http://me:1"
        assert svc.fleet_stats()["fleet-replica-count"] == 2
    finally:
        svc.close()
    assert tfleet.local_state()["replicas"] == []
    for key, value, match in (("fleet-role", "turbo", "fleet-role"),
                              ("fleet", "sometimes", "fleet mode")):
        with pytest.raises(ValueError, match=match):
            tserving.TorchCompletionsService(dict(PROVIDER, device="cpu", **{key: value}))
    # a seq mesh is served since ring prefill was ported (its ranks join
    # when the engine is built)
    svc = tserving.TorchCompletionsService(dict(PROVIDER, device="cpu", mesh={"seq": 2}))
    assert svc.mesh_axes == {"seq": 2} and svc.world == 2


def test_begin_drain_empties_state_before_the_engine_drains(port_server, f32_presets,
                                                            monkeypatch):
    svc = tserving.TorchCompletionsService(dict(PROVIDER, device="cpu", fleet="off"))
    svc._params = weights()[1]
    engine = svc.engine()
    seen = {}
    real = engine.drain

    def drain(grace_s):
        with urllib.request.urlopen(port_server.url + "/state", timeout=10) as r:
            seen["replicas"] = json.loads(r.read())["replicas"]
        seen["draining"] = engine._draining
        return real(grace_s)

    monkeypatch.setattr(engine, "drain", drain)
    with urllib.request.urlopen(port_server.url + "/state", timeout=10) as r:
        assert [b["id"] for b in json.loads(r.read())["replicas"]] == ["local"]
    svc.begin_drain()
    assert seen == {"replicas": [], "draining": False}
    assert engine._draining
    svc.begin_drain()  # idempotent: no second drain
    svc.close()
    assert engine._dead is not None or not engine._thread.is_alive()


# -- the standalone replica ----------------------------------------------------


def test_standalone_replica_serves_cancels_and_exits_cleanly(f32_presets):
    """``python -m langstream_tpu_torch.serving.fleet`` in a subprocess (its
    tokens trickle: the ``client`` stall): the start line, its first stream
    cut by its ``wire-fault-injection`` (``net-cut@1``), one generate, then
    a provider in THIS process with the replica as its peer routes a prompt
    the replica holds there under a ``cancel-key``; ``lifecycle.cancel`` here
    forwards ``POST /fleet/cancel`` and the remote decode ends cancelled at
    its next chunk, its slot freed. Closing stdin drains and exits 0 with
    the exit line (the engine's counters and the kernel counts)."""
    config = {"model": "tiny-test", "device": "cpu", "max-batch": 2, "max-seq-len": 128,
              "decode-chunk": 4, "prefill-buckets": [16, 32, 64], "page-size": 16,
              "prefix-cache": "auto", "fleet-replica-id": "sub", "fleet-role": "decode",
              "drain-grace-s": 2, "fault-injection": "client@1+", "fault-stall-s": 0.02,
              "wire-fault-injection": "net-cut@1"}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch.serving.fleet", "--config",
         json.dumps(config)], cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    provider = None
    try:
        start = json.loads(proc.stdout.readline())
        assert start["replica"] == "sub" and start["url"].startswith("http://127.0.0.1:")
        replica = tfleet.HttpReplica("sub", start["url"])
        assert replica.fetch_beacon()["role"] == "decode"
        text = "user: cancel me from the other process, please, right now\nassistant:"
        prompt = ByteTokenizer().encode(text)
        # the replica's wire cuts its first stream (its ``wire-fault-injection``)
        with pytest.raises(tfleet.ReplicaError, match="stream read failed"):
            replica.generate(prompt, {"max-tokens": 40, "temperature": 0.0})
        out = replica.generate(prompt, {"max-tokens": 5, "temperature": 0.0})
        assert len(out["tokens"]) == 5 and out["finish_reason"] == "length"
        # the provider's router sends the prompt the replica now holds there
        provider = tserving.TorchServingProvider(dict(
            PROVIDER, device="cpu", **{"fleet-replicas": [start["url"]], "fleet-lambda": 1}))
        svc = provider.get_completions_service({})
        svc._params = weights()[1]
        chunks: list = []

        def on_chunk(chunk) -> None:
            chunks.append(chunk)
            if len(chunks) == 2:
                assert lifecycle.cancel("sess-1") == 0  # nothing of it runs here
        res = asyncio.run(svc.get_text_completions(
            [text], {"max-tokens": 80, "temperature": 0.0, "cancel-key": "sess-1",
                     "min-chunks-per-message": 1}, on_chunk))
        assert res.finish_reason == "cancelled" and 0 < res.completion_tokens < 80
        assert svc.fleet_stats()["fleet-routed-affinity-total"] == 1
        assert lifecycle._remote_by_key == {} and lifecycle.active_keys() == []
        deadline = time.monotonic() + 30
        while replica.fetch_beacon()["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert replica.fetch_beacon()["active_slots"] == 0
        proc.stdin.close()
        exit_line = json.loads(proc.stdout.readline())
        assert proc.wait(timeout=60) == 0
    finally:
        if provider is not None:
            asyncio.run(provider.close())
        if proc.poll() is None:
            proc.kill()
    st = exit_line["stats"]
    # the cut stream's request and the forwarded cancel
    assert exit_line["replica"] == "sub" and st["cancelled-total"] == 2
    assert st["decode-steps-total"] > 0 and st["active-slots"] == 0
    assert st["kv-pages-in-use"] * st["kv-bytes-per-page"] == st["prefix-pool-bytes-in-use"]
    calls = {k: v["cpu_calls"] for k, v in exit_line["kernels"].items() if v["cpu_calls"]}
    assert calls and all(v["launches"] == 0 for v in exit_line["kernels"].values())
    assert exit_line["wire"]["v2"] > 0  # the frames2 streams the clients asked for
