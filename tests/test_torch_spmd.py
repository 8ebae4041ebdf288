"""The port's SPMD serving plane (``parallel/spmd_serving.py`` and the
engine's ``_spmd_*`` side) on the CPU, against the JAX package's.

- Packed blocks: the port's ``_pack`` arrays equal the JAX channel's,
  element for element, for every op; phases and unpacking agree.
- The wire units of ``tests/test_spmd_recovery.py`` (seq wrap and epoch
  reset, gap fatal / resync / second gap, wedge, drop, receive timeout,
  dump reasons, fault sites).
- Loopback pairs (leader and follower engines in one process, one weight
  tree, echo on): the plain tier on both layouts and the fast tier (paged,
  prefix reuse, speculation) give the JAX loopback pair's greedy tokens,
  the follower's echo holds on every chunk and the device state stays in
  lockstep. Lockstep on the paged layout leaves out the sink page and the
  token chain: rows past their reservation and masked rows write into the
  one sink page, where rows collide in one scatter (JAX drops those
  writes), so the sink's bytes — and the garbage tokens of rows that read
  it, which no request is delivered — are not deterministic.
- Two processes: the provider with ``mesh: {data: 2}`` starts its
  follower (``python -m langstream_tpu_torch.parallel.spmd_serving``) over
  gloo; tokens equal the single-process engine's and the JAX engine's, and
  ``close()`` sees the follower exit 0 (the counterpart of
  ``tests/test_spmd_serving.py``'s two-process test).
- The recovery drills of ``tests/test_spmd_recovery.py`` /
  ``test_spmd_parity.py`` on a port pair: an ``spmd-crash`` recovers both
  sides in place, a silenced leader trips the follower's watchdog, a lost
  heartbeat resyncs, and a corrupted echo is caught.

f32 tiny-test; tokens are compared exactly."""

import asyncio
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.parallel import spmd_serving as jwire
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.parallel import spmd_serving as wire
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from langstream_tpu_torch.serving.observability import (
    DUMP_REASONS,
    FlightRecorder,
    recent_dumps,
    validate_flight_dump,
)

torch.backends.cuda.matmul.allow_tf32 = False

JCFG = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
MAX_SEQ, PAGE, BUCKETS, MAX_BATCH = 128, 8, (16, 32), 3


def kw(layout="paged", fast=False, **over):
    out = dict(max_batch=MAX_BATCH, max_seq_len=MAX_SEQ, decode_chunk=4, prefill_buckets=BUCKETS,
               prefill_batch=4, kv_layout=layout, page_size=PAGE,
               prefix_cache="auto" if fast else "off", speculation="auto" if fast else "off",
               speculation_tokens=4, restart_backoff_s=0.05)
    out.update(over)
    return out


def channel_kw(layout="paged", fast=False, echo=True, **over):
    out = dict(prefill_batch=4, max_width=max(BUCKETS), max_batch=MAX_BATCH,
               table_len=(MAX_SEQ // PAGE) if layout == "paged" else 0,
               spec_tokens=4 if fast else 0, echo=echo, decode_chunk=4)
    out.update(over)
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")


# a 16-token preamble (the smallest bucket boundary: it publishes), warm
# and cold prompts, a repetitive one (drafts) and a long one (segments)
PREAMBLE = [(7 + i) % 512 for i in range(16)]
PROMPTS = [[5, 6, 7], PREAMBLE + [3, 1], PREAMBLE + [9, 2, 4], [4, 8, 15, 16, 23, 42] * 4,
           [(3 + i) % 512 for i in range(40)]]
WARM = PREAMBLE + [8, 8, 1]
NEW = 6


# -- packed blocks ---------------------------------------------------------


def _blocks(mod):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 500, (3, 16)).astype(np.int32)
    common = dict(slots=np.array([0, 2], np.int32), mask=np.array([1, 0, 1], np.int32))
    return {
        "idle": mod.ControlBlock(op=mod.OP_IDLE),
        "prefill": mod.ControlBlock(op=mod.OP_PREFILL, width=16, n_rows=3, tokens=tok,
                                    lengths=np.array([3, 9, 16], np.int32),
                                    slots=np.array([0, 1, 3], np.int32),
                                    temps=np.array([0, 0.7, 1.0], np.float32),
                                    top_ks=np.array([0, 5, 0], np.int32),
                                    top_ps=np.array([1, 1, 0.9], np.float32)),
        "long_seg": mod.ControlBlock(op=mod.OP_LONG_SEG, width=16, n_rows=1, tokens=tok[:1],
                                     s0=32, seg_len=9, kv_bound=48, t_long=64, long_start=True,
                                     long_final=True, long_idx=2, prompt_len=41, entry_row=3,
                                     temps=np.array([0.5], np.float32),
                                     top_ks=np.array([3], np.int32),
                                     top_ps=np.array([0.8], np.float32)),
        "decode": mod.ControlBlock(op=mod.OP_DECODE, steps=4, n_rows=2, kv_bound=77,
                                   width=2, **common),
        "stop": mod.ControlBlock(op=mod.OP_STOP),
        "verify": mod.ControlBlock(op=mod.OP_VERIFY, steps=4, n_rows=2, kv_bound=0,
                                   drafts=rng.integers(0, 500, (3, 4)).astype(np.int32),
                                   **common),
        "prefix_admit": mod.ControlBlock(op=mod.OP_PREFIX_ADMIT, width=16, n_rows=1,
                                         tokens=tok[:1], s0=16, seg_len=3, kv_bound=32,
                                         entry_row=1, long_idx=0, prompt_len=19,
                                         temps=np.zeros(1, np.float32),
                                         top_ks=np.zeros(1, np.int32),
                                         top_ps=np.ones(1, np.float32)),
        "prefix_publish": mod.ControlBlock(op=mod.OP_PREFIX_PUBLISH, long_idx=1, entry_row=4),
        "page_bind": mod.ControlBlock(op=mod.OP_PAGE_BIND, long_idx=1, count=3,
                                      pages=np.array([7, 2, 9], np.int32), cow_src=5,
                                      cow_dst=9),
        "page_free": mod.ControlBlock(op=mod.OP_PAGE_FREE, long_idx=2),
        "page_zero": mod.ControlBlock(op=mod.OP_PAGE_ZERO, count=2,
                                      pages=np.array([4, 11], np.int32)),
        "row_reset": mod.ControlBlock(op=mod.OP_ROW_RESET, n_rows=1,
                                      slots=np.array([2], np.int32)),
        "echo": mod.ControlBlock(op=mod.OP_ECHO, long_idx=1, count=18,
                                 echo=rng.integers(-1, 500, 18).astype(np.int32)),
        "warmup": mod.ControlBlock(op=mod.OP_WARMUP, count=mod.WARMUP_VERIFY_LADDER),
        "recover": mod.ControlBlock(op=mod.OP_RECOVER, count=3),
        "resync": mod.ControlBlock(op=mod.OP_RESYNC, long_idx=4, n_rows=3, width=16, count=51,
                                   echo=rng.integers(-1, 50, 51).astype(np.int32)),
        "ring": mod.ControlBlock(op=mod.OP_RING, width=16, n_rows=2, tokens=tok[:2],
                                 seg_len=20, long_start=True, prompt_len=20,
                                 temps=np.zeros(1, np.float32), top_ks=np.zeros(1, np.int32),
                                 top_ps=np.ones(1, np.float32)),
    }


@pytest.mark.parametrize("name", sorted(_blocks(wire)))
def test_packed_blocks_equal_jax(name):
    ckw = channel_kw(fast=True)
    mine = wire.SpmdChannel(**ckw)._pack(_blocks(wire)[name])
    theirs = jwire.SpmdChannel(**ckw)._pack(_blocks(jwire)[name])
    assert len(mine) == len(theirs) == 11
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    op = _blocks(wire)[name].op
    p1, pay = wire.SpmdChannel._phases(mine, op)
    q1, qay = jwire.SpmdChannel._phases(theirs, op)
    assert len(p1) == len(q1) and (pay is None) == (qay is None)
    back = wire.SpmdChannel(**ckw)._unpack(mine)
    assert back.op == op and back.count == _blocks(wire)[name].count


def test_ops_and_head_layout_equal_jax():
    names = [n for n in dir(jwire) if n.startswith(("OP_", "_H_", "WARMUP_", "ECHO_"))]
    assert names and all(getattr(wire, n) == getattr(jwire, n) for n in names)
    assert wire.SpmdChannel.SEQ_MOD == jwire.SpmdChannel.SEQ_MOD


def test_broadcast_wire_round_trips_one_block_per_phase(monkeypatch):
    """The transport's phase arrays ride as ONE int32 tensor (float32 by its
    bits) and come back bit-equal; bytes are counted as JAX counts them."""
    import torch.distributed as dist

    sent = []

    class _Work:
        def wait(self, timeout=None):
            return True

    def fake_broadcast(t, src, group=None, async_op=False):
        if sent:
            t.copy_(sent.pop(0))
        else:
            sent.append(t.clone())
        return _Work()

    monkeypatch.setattr(dist, "broadcast", fake_broadcast)
    ch = wire.SpmdChannel(**channel_kw())
    block = _blocks(wire)["prefill"]
    packed = ch._pack(block)
    p1, pay = ch._phases(packed, block.op)
    for phase in (p1, pay):
        ch._broadcast(phase)  # the leader's send: recorded
        templates = tuple(np.zeros_like(a) for a in phase)
        got = ch._broadcast(templates)  # the follower's receive
        for a, b in zip(got, phase):
            np.testing.assert_array_equal(a, b)
    jch = jwire.LoopbackChannel(**channel_kw())
    jch.announce(_blocks(jwire)["prefill"])
    lch = wire.LoopbackChannel(**channel_kw())
    lch.announce(_blocks(wire)["prefill"])
    assert lch.bytes_announced_total == jch.bytes_announced_total > 0


# -- wire units (tests/test_spmd_recovery.py) ---------------------------------


class _StubEngine:
    def __init__(self):
        self._injector = None
        self.recovered: list[int] = []
        self.dumps: list[tuple] = []

    def _spmd_follower_recover(self, epoch: int) -> None:
        self.recovered.append(int(epoch))

    def _flight_dump(self, reason, extra=None, force=False):
        self.dumps.append((reason, dict(extra or {})))


def _loop(**over):
    return wire.LoopbackChannel(**channel_kw(echo=False, **over))


def test_seq_wrap_and_epoch_reset():
    ch = _loop()
    ch._seq = wire.SpmdChannel.SEQ_MOD - 1
    for _ in range(3):
        ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    assert ch._seq == 2
    ch.announce(wire.ControlBlock(op=wire.OP_RECOVER, count=7))
    ch.reset_seq()
    for _ in range(2):
        ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch.announce(wire.ControlBlock(op=wire.OP_STOP))
    stub = _StubEngine()
    wire.follower_loop(stub, ch)
    assert stub.recovered == [7] and not stub.dumps


def test_seq_gap_without_side_channel_is_fatal():
    ch = _loop()
    ch.report_divergence = lambda *a, **k: False
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch._seq += 1
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    stub = _StubEngine()
    with pytest.raises(wire.SpmdDivergenceError):
        wire.follower_loop(stub, ch)
    assert [r for r, _ in stub.dumps] == ["spmd-divergence"]
    assert "sequence gap" in stub.dumps[0][1]["why"]


def test_seq_gap_requests_resync_and_keeps_replaying():
    ch = _loop()
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch._seq += 1
    for op in (wire.OP_IDLE, wire.OP_IDLE, wire.OP_STOP):
        ch.announce(wire.ControlBlock(op=op))
    stub = _StubEngine()
    wire.follower_loop(stub, ch)
    req = ch.poll_divergence()
    assert req is not None and "sequence gap" in req["why"]
    assert ch.poll_divergence() is None
    assert [r for r, _ in stub.dumps] == ["spmd-divergence"]


def test_second_gap_while_resync_pending_is_fatal():
    ch = _loop()
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch._seq += 1
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch._seq += 1
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    with pytest.raises(wire.SpmdDivergenceError):
        wire.follower_loop(_StubEngine(), ch)


def test_on_warmup_runs_after_each_replayed_warmup():
    ch = _loop()
    for kind in (wire.WARMUP_PAGED, wire.WARMUP_VERIFY_LADDER, wire.WARMUP_PREFILL_BUCKETS):
        ch.announce(wire.ControlBlock(op=wire.OP_WARMUP, count=kind))
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch.announce(wire.ControlBlock(op=wire.OP_STOP))
    stub = _StubEngine()
    events: list = []
    stub._capture_set = lambda kind: events.append(kind)
    wire.follower_loop(stub, ch, on_warmup=lambda: events.append("warm"))
    assert events == ["decode", "warm", "verify", "warm", "warm"]


def test_wedge_site_silences_the_wire():
    ch = _loop(fault_injector=FaultInjector("spmd-wedge@1", seed=0))
    for _ in range(3):
        ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    assert ch._q.empty() and ch._seq == 3 and ch.announces_total == 0
    assert ch.last_announce_t > 0


def test_drop_site_loses_one_idle_heartbeat():
    ch = _loop(fault_injector=FaultInjector("spmd-drop@1", seed=0))
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    ch.announce(wire.ControlBlock(op=wire.OP_IDLE))
    block = ch.recv()
    assert block.op == wire.OP_IDLE and block.seq == 2 and ch.announces_total == 1


def test_recv_timeout_raises_spmd_timeout():
    ch = _loop()
    t0 = time.monotonic()
    with pytest.raises(wire.SpmdTimeout):
        ch.recv(timeout_s=0.1)
    assert time.monotonic() - t0 < 2.0


def test_dump_reasons_schema_and_debounce():
    assert "spmd-recover" in DUMP_REASONS and "spmd-wedge" in DUMP_REASONS
    rec = FlightRecorder(capacity=8)
    for reason in ("spmd-recover", "spmd-wedge", "spmd-divergence"):
        doc = rec.dump(reason, counters={"spmd-recoveries": 1}, extra={"epoch": 1, "why": "x"})
        assert doc is not None
        validate_flight_dump(doc)
        assert rec.dump(reason, counters={}) is None


def test_spmd_fault_sites_parse():
    inj = FaultInjector("spmd-crash@3,spmd-wedge@1,spmd-drop@2:5", seed=0)
    assert set(inj.stats()) == {"spmd-crash", "spmd-wedge", "spmd-drop"}


# -- loopback pairs ----------------------------------------------------------


class PortPair:
    """A port leader and follower in one process over a loopback channel,
    one weight tree; the follower's exit captured."""

    def __init__(self, params, layout="paged", fast=False, echo=True, injector=None,
                 watchdog_s=0.0, channel_injector=None, **over):
        self.channel = wire.LoopbackChannel(**channel_kw(layout, fast, echo,
                                                         watchdog_s=watchdog_s,
                                                         fault_injector=channel_injector))
        self.leader = ServingEngine(CFG, params, device="cpu", spmd=self.channel,
                                    fault_injector=injector, **kw(layout, fast, **over))
        self.follower = ServingEngine(CFG, params, device="cpu", spmd=self.channel,
                                      **kw(layout, fast, **over))
        self.error: list = []

        def run():
            try:
                wire.follower_loop(self.follower, self.channel)
            except BaseException as e:  # noqa: BLE001 — asserted by the tests
                self.error.append(e)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def submit_all(self, prompts, new=NEW):
        opts = GenerationOptions(max_new_tokens=new, temperature=0.0)
        return [self.leader.submit(GenerationRequest(prompt_tokens=list(p), options=opts))
                for p in prompts]

    def stop(self, expect_exit=True):
        self.leader.stop()
        self.thread.join(timeout=60)
        if expect_exit:
            assert not self.thread.is_alive(), "follower never saw STOP"

    def assert_lockstep(self):
        from langstream_tpu_torch.serving.pagepool import pool_leaves

        np.testing.assert_array_equal(self.leader._positions_dev.numpy(),
                                      self.follower._positions_dev.numpy())
        if self.leader._paged:
            pairs = zip(pool_leaves(self.leader._pagepool.dev),
                        pool_leaves(self.follower._pagepool.dev))
            for a, b in pairs:
                assert torch.equal(a[:, :-1], b[:, :-1])  # the sink page left out
        else:
            np.testing.assert_array_equal(self.leader._tokens_dev.numpy(),
                                          self.follower._tokens_dev.numpy())
            for a, b in zip(pool_leaves(self.leader._cache), pool_leaves(self.follower._cache)):
                assert torch.equal(a, b)


def jax_pair_tokens(jp, layout, fast, prompts=PROMPTS, new=NEW):
    """The JAX loopback pair's greedy tokens, every request submitted before
    the leader starts."""
    ch = jwire.LoopbackChannel(**channel_kw(layout, fast))
    jkw = kw(layout, fast)
    jkw["prefix_cache"] = jkw["prefix_cache"] == "auto"
    jkw["speculation"] = jkw["speculation"] == "auto"
    leader = JaxEngine(JCFG, jp, spmd=ch, **jkw)
    follower = JaxEngine(JCFG, jp, **jkw)
    errors = []

    def run():
        try:
            jwire.follower_loop(follower, ch)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    opts = JaxOptions(max_new_tokens=new, temperature=0.0)
    reqs = [leader.submit(JaxRequest(prompt_tokens=list(p), options=opts)) for p in prompts]
    leader.start()
    try:
        out = [r.result(timeout=300).tokens for r in reqs]
        # a second wave: the preamble is published now, so this one is warm
        return out + [leader.submit(JaxRequest(prompt_tokens=list(WARM), options=opts))
                      .result(timeout=300).tokens]
    finally:
        leader.stop()
        t.join(timeout=60)
        assert not errors, errors


@pytest.mark.parametrize("layout, fast", [("paged", False), ("dense", False), ("paged", True)],
                         ids=["paged", "dense", "paged-fast"])
def test_loopback_pair_tokens_equal_jax_pair(weights, layout, fast):
    want = jax_pair_tokens(weights[0], layout, fast)
    pair = PortPair(weights[1], layout, fast)
    reqs = pair.submit_all(PROMPTS)
    pair.leader.start()
    try:
        got = [r.result(timeout=120).tokens for r in reqs]
        got += [r.result(timeout=120).tokens for r in pair.submit_all([WARM])]
        stats = pair.leader.stats()
    finally:
        pair.stop()
    assert not pair.error, pair.error
    assert got == want
    pair.assert_lockstep()
    assert stats["spmd"] and stats["spmd-announces-total"] > 0
    assert 0 < stats["spmd-announce-bytes-total"] <= pair.channel.bytes_announced_total
    if fast:
        assert stats["spec-verify-dispatches-total"] > 0 and stats["warm-admissions-total"] > 0


def test_multi_rank_turns_the_unwired_tiers_off(weights, caplog):
    """Under SPMD the host KV tier, the durable tier, adapters and
    constrained decoding are off, as the JAX engine turns them off."""
    ch = wire.LoopbackChannel(**channel_kw(fast=True))
    engine = ServingEngine(CFG, weights[1], device="cpu", spmd=ch,
                           host_kv_fraction=1.0, durable_dir="/nonexistent-dir",
                           adapters=[{"name": "a", "rank": 4, "seed": 1}],
                           constrained_decoding="on", **kw(fast=True))
    assert not engine._spill_on and not engine._durable_on
    assert engine._adapters is None and engine._constrain_reg is None
    with pytest.raises(Exception, match="SPMD"):
        engine.migrate_limits() if False else engine._migrate_rpc("snapshot", {}, 0.1)


# -- two processes over gloo --------------------------------------------------


def test_two_process_provider_tokens_equal_single_process(tmp_path):
    """The provider with ``mesh: {data: 2}``: this process is rank 0 and
    starts rank 1 as ``python -m langstream_tpu_torch.parallel
    .spmd_serving``; with echo on, the completions equal a single-process
    provider's on the same drawn weights and the follower exits 0."""
    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider

    resource = {"model": "tiny-test", "device": "cpu", "max-seq-len": MAX_SEQ,
                "prefill-buckets": list(BUCKETS), "max-batch": MAX_BATCH, "decode-chunk": 4,
                "page-size": PAGE, "prefill-batch": 4, "spmd-parity-echo": True,
                "mesh": {"data": 2}}
    prompts = ["hello world", "the quick brown fox jumps over the lazy dog"]

    async def serve(res):
        provider = TorchServingProvider(res)
        svc = provider.get_completions_service({})
        try:
            out = [await svc.get_text_completions([p], {"max-tokens": 8, "temperature": 0})
                   for p in prompts]
            return [r.content for r in out], svc, svc.engine_stats()
        finally:
            await provider.close()

    got, svc, stats = asyncio.run(serve(resource))
    assert svc.follower_exit_codes == [0]
    exit_line = svc.follower_exit_lines[0]
    assert exit_line["follower"] == 1 and exit_line["exit"] == "stop"
    # a follower on the CPU runs the plain versions: no launch at all
    assert exit_line["kernels"] and not any(exit_line["kernels"].values())
    assert stats["spmd"] and stats["spmd-announces-total"] > 0
    solo = {k: v for k, v in resource.items() if k not in ("mesh", "spmd-parity-echo")}
    want, _, _ = asyncio.run(serve(solo))
    assert got == want


def test_two_process_gloo_tokens_equal_jax(weights, tmp_path):
    """Two spawned ranks over gloo, {data: 2}: rank 0 leads, rank 1 replays
    with echo on — greedy tokens equal the JAX single-process engine's."""
    import pickle

    from torch_spmd_worker import spawn

    jp = weights[0]
    path = tmp_path / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    job = {"name": "data2", "kind": "engine", "model": "tiny-test", "axes": {"data": 2},
           "overrides": {"dtype": "float32"}, "params": str(path), "engine": kw(),
           "channel": channel_kw(), "prompts": PROMPTS, "new_tokens": NEW}
    got = spawn(job, 2, tmp_path)
    jkw = kw()
    jkw["prefix_cache"], jkw["speculation"] = False, False
    jengine = JaxEngine(JCFG, jp, **jkw)
    opts = JaxOptions(max_new_tokens=NEW, temperature=0.0)
    reqs = [jengine.submit(JaxRequest(prompt_tokens=list(p), options=opts)) for p in PROMPTS]
    jengine.start()
    try:
        want = [r.result(timeout=300).tokens for r in reqs]
    finally:
        jengine.stop()
    assert got["tokens"] == want
    assert got["stats"]["spmd-announces-total"] > 0


# -- drills (tests/test_spmd_recovery.py, test_spmd_parity.py) -----------------


def test_spmd_crash_recovers_both_sides_in_place(weights):
    """An ``spmd-crash`` at the leader's iteration top: OP_RECOVER, both
    sides rebuild (generator re-seeded from seed + epoch) with the follower
    thread alive; the prompt served again gives the same tokens."""
    pair = PortPair(weights[1], injector=FaultInjector("spmd-crash@40", seed=0))
    pair.leader.start()
    try:
        opts = GenerationOptions(max_new_tokens=NEW, temperature=0.0)
        before = pair.leader.generate(PROMPTS[4], opts, timeout=60).tokens
        deadline = time.monotonic() + 30
        while pair.leader.stats()["spmd-recoveries-total"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        after = pair.leader.generate(PROMPTS[4], opts, timeout=60).tokens
        stats = pair.leader.stats()
        assert pair.thread.is_alive(), "follower exited (must recover in place)"
    finally:
        pair.stop()
    assert not pair.error, pair.error
    assert stats["spmd-recoveries-total"] == 1 and stats["spmd-recovery-epoch"] == 1
    assert after == before
    assert pair.follower._spmd_epoch == 1
    pair.assert_lockstep()
    dumps = [d for d in recent_dumps() if d.get("reason") == "spmd-recover"]
    assert dumps and dumps[-1]["extra"]["epoch"] >= 1
    validate_flight_dump(dumps[-1])


def test_follower_watchdog_detects_silenced_leader(weights):
    pair = PortPair(weights[1])
    pair.leader.start()
    try:
        pair.leader.generate(PROMPTS[0], GenerationOptions(max_new_tokens=4), timeout=60)
        pair.channel.watchdog_s = 0.2
        time.sleep(0.3)  # heartbeats flow
        assert pair.thread.is_alive()
        pair.channel.injector = FaultInjector("spmd-wedge@1", seed=0)
        t0 = time.monotonic()
        pair.thread.join(timeout=10)
        took = time.monotonic() - t0
    finally:
        pair.stop(expect_exit=False)
    assert pair.error and isinstance(pair.error[0], wire.SpmdWedgeError)
    assert took < 4 * 0.2 + 1.0
    dumps = [d for d in recent_dumps() if d.get("reason") == "spmd-wedge"]
    assert dumps
    validate_flight_dump(dumps[-1])


def test_dropped_heartbeat_resyncs_and_rejoins(weights):
    pair = PortPair(weights[1])
    pair.leader.start()
    try:
        opts = GenerationOptions(max_new_tokens=NEW, temperature=0.0)
        want = pair.leader.generate(PROMPTS[3], opts, timeout=60).tokens
        pair.channel.watchdog_s = 0.4
        pair.channel.injector = FaultInjector("spmd-drop@1", seed=0)
        deadline = time.monotonic() + 10
        while pair.leader.stats()["spmd-resyncs-total"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        got = pair.leader.generate(PROMPTS[3], opts, timeout=60).tokens
        stats = pair.leader.stats()
        assert pair.thread.is_alive()
    finally:
        pair.stop()
    assert not pair.error, pair.error
    assert stats["spmd-resyncs-total"] == 1 and got == want


def test_corrupted_echo_is_caught(weights):
    """A leader echo that disagrees with the follower's device result —
    twice, inside the resync window — ends the follower with
    ``SpmdDivergenceError`` and an ``spmd-divergence`` dump."""
    pair = PortPair(weights[1])
    real = pair.leader._spmd_echo

    def corrupt(kind, host):
        host = np.array(host, copy=True)
        host.reshape(-1)[0] += 1
        real(kind, host)

    pair.leader._spmd_echo = corrupt
    pair.leader.start()
    try:
        pair.leader.generate(PROMPTS[0], GenerationOptions(max_new_tokens=12), timeout=60)
        pair.thread.join(timeout=10)
    finally:
        pair.stop(expect_exit=False)
    assert pair.error and isinstance(pair.error[0], wire.SpmdDivergenceError)
    assert "token divergence" in str(pair.error[0])
    dumps = [d for d in recent_dumps() if d.get("reason") == "spmd-divergence"]
    assert dumps
    validate_flight_dump(dumps[-1])
