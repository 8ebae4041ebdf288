"""Adapters, constrained decoding and the host KV tier on a multi-rank
replica of the port (the SPMD wire, ``parallel/spmd_serving.py``), against
the JAX engine built with a single-process mesh of the same axes on the
conftest's virtual CPU devices, same weights and same prompts.

- Tensor parallelism over gloo (``tests/torch_spmd_worker.py``, job
  ``tiers``): rank 0 leads with echo on, the other ranks replay. World 2
  ({model: 2}) and world 4 ({model: 4}) on tiny-test, paged (adapters,
  grammar and the host tier, served one request at a time so a session's
  prefix spills, demotes and restores) and dense (adapters and grammar with
  speculation, every request queued before ``start()``); the host tier with
  int8 KV ("jnp" attention both sides, prompts of 16 tokens or fewer); and
  tiny-moe-test ({model: 2} and {expert: 2, model: 2}, attention-only
  adapters). Greedy tokens equal JAX's, every constrained output walks its
  grammar, every rank's restored pages equal the arena blocks they came
  from, and each rank's memory plan counts its slices.
- The ``spmd-restore`` drill rots one follower slot before its verify: the
  agreed verdict falls back on every rank, and the tokens are JAX's.
- The port's new ops round-trip through the channel (payloads spanning
  blocks, text, the verdict), and a multi-host flag keeps the three tiers
  off with the warning.

f32; tokens are compared exactly. The model-dtype pool here is f32 (bf16
on the card)."""

import dataclasses
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.parallel.mesh import build_mesh as jax_build_mesh
from langstream_tpu.parallel.sharding import shard_params as jax_shard_params
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS
from langstream_tpu_torch.parallel import spmd_serving as wire
from langstream_tpu_torch.parallel.sharding import local_config
from langstream_tpu_torch.serving.adapters import lora_pool_bytes
from langstream_tpu_torch.serving.constrain import compile_response_format
from langstream_tpu_torch.serving.engine import ServingEngine
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer

torch.backends.cuda.matmul.allow_tf32 = False

V = 512
DIGITS = {"type": "regex", "regex": "[0-9]+"}
OBJECT = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object", "properties": {"n": {"type": "integer"}}, "required": ["n"]}}}
ADAPTERS = [{"name": "a", "rank": 4, "seed": 11, "scale": 0.5},
            {"name": "b", "rank": 4, "seed": 12, "scale": 0.5}]
AGENTIC = dict(adapters=ADAPTERS, adapter_pool_rows=3, constrained_decoding="on",
               grammar_slots=4, grammar_states=64, grammar_exceptions=4096)

# the host tier as ``test_torch_tiered_kv.py`` drives it: two 45-token
# sessions over a 16/32/64 ladder at page 16, 5 pages, so B's admission
# demotes A's hibernated prefix and A's next turn restores it
PROMPT_A = [(7 + 3 * i) % V for i in range(45)]
PROMPT_B = [(5 + 11 * i) % V for i in range(45)]
PROMPT_C = [(3 + 5 * i) % V for i in range(20)]
TIER = dict(max_batch=2, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32, 64),
            page_size=16, kv_pages=5, host_kv_fraction=2.0, spill_idle_s=0.0,
            prefix_cache="auto", prefix_cache_entries=8, prefill_batch=2, kv_layout="paged")
TIER_REQUESTS = [
    {"prompt": PROMPT_A},
    {"prompt": PROMPT_B, "wait_spilled": 2},
    {"prompt": PROMPT_A},  # restored
    {"prompt": PROMPT_C, "adapter": "a"},
    {"prompt": PROMPT_C, "grammar": DIGITS},
    {"prompt": PROMPT_B[:30], "adapter": "b", "grammar": OBJECT},
]
# int8 KV: prompts of 16 tokens or fewer, an 8/16 ladder at page 8, 3 pages
INT8 = dict(TIER, prefill_buckets=(8, 16), page_size=8, kv_pages=3, max_seq_len=64)
INT8_REQUESTS = [
    {"prompt": PROMPT_A[:15]},
    {"prompt": PROMPT_B[:15], "wait_spilled": 1},
    {"prompt": PROMPT_A[:15]},
    {"prompt": PROMPT_C[:12], "adapter": "a", "grammar": DIGITS},
]
DENSE = dict(max_batch=4, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32),
             prefill_batch=4, kv_layout="dense", speculation="auto", speculation_tokens=3)
BATCH_REQUESTS = [
    {"prompt": PROMPT_C},
    {"prompt": PROMPT_C, "adapter": "a"},
    {"prompt": [4, 8, 15, 16, 23, 42] * 3, "grammar": DIGITS},
    {"prompt": PROMPT_B[:12], "adapter": "b", "grammar": OBJECT},
]
MOE = dict(max_batch=4, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32),
           prefill_batch=4, kv_layout="paged", page_size=16)
NEW = 8

# name → (model, axes, engine kwargs, requests, batch, config overrides)
RUNS = {
    "paged-model2": ("tiny-test", {"model": 2}, dict(TIER, **AGENTIC), TIER_REQUESTS, False, {}),
    "paged-model4": ("tiny-test", {"model": 4}, dict(TIER, **AGENTIC), TIER_REQUESTS, False, {}),
    "dense-model2": ("tiny-test", {"model": 2}, dict(DENSE, **AGENTIC), BATCH_REQUESTS, True, {}),
    "dense-model4": ("tiny-test", {"model": 4}, dict(DENSE, **AGENTIC), BATCH_REQUESTS, True, {}),
    "int8-model2": ("tiny-test", {"model": 2}, dict(INT8, **AGENTIC), INT8_REQUESTS, False,
                    {"kv_cache_dtype": "int8", "attention_impl": "jnp"}),
    "moe-model2": ("tiny-moe-test", {"model": 2}, dict(MOE, **AGENTIC), BATCH_REQUESTS, True, {}),
    "moe-expert2-model2": ("tiny-moe-test", {"expert": 2, "model": 2}, dict(MOE, **AGENTIC),
                           BATCH_REQUESTS, True, {}),
}
WORLD2 = ["paged-model2", "dense-model2", "int8-model2", "moe-model2"]
WORLD4 = ["paged-model4", "dense-model4", "moe-expert2-model2"]
DRILL = "spmd-restore@1"


def _jax_params(model):
    cfg = dataclasses.replace(JAX_PRESETS[model], dtype="float32")
    return jax_init_params(cfg, jax.random.PRNGKey(0))


def _channel(engine: dict) -> dict:
    paged = engine["kv_layout"] == "paged"
    return dict(prefill_batch=engine["prefill_batch"], max_width=max(engine["prefill_buckets"]),
                max_batch=engine["max_batch"],
                table_len=engine["max_seq_len"] // engine["page_size"] if paged else 0,
                spec_tokens=engine.get("speculation_tokens", 0)
                if engine.get("speculation") == "auto" else 0,
                echo=True, decode_chunk=engine["decode_chunk"])


def _job(name: str, paths: dict, faults: str = "") -> dict:
    model, axes, engine, requests, batch, over = RUNS[name]
    return {"kind": "tiers", "model": model, "axes": axes, "params": paths[model],
            "overrides": dict(over, dtype="float32"), "engine": engine,
            "channel": _channel(engine), "requests": requests, "batch": batch,
            "new_tokens": NEW, "faults": faults}


def _jax_tokens(name: str, params: dict) -> list:
    """The JAX engine on a single-process mesh of the run's axes."""
    import time

    model, axes, engine_kw, requests, batch, over = RUNS[name]
    cfg = dataclasses.replace(JAX_PRESETS[model], dtype="float32", **over)
    mesh = jax_build_mesh(axes)
    engine = JaxEngine(cfg, jax_shard_params(params[model], mesh, cfg), mesh=mesh, **engine_kw)

    def options(r):
        return JaxOptions(max_new_tokens=NEW, temperature=0.0, adapter=r.get("adapter"),
                          response_format=r.get("grammar"))

    from langstream_tpu.serving.engine import GenerationRequest as JaxRequest

    try:
        if batch:
            reqs = [engine.submit(JaxRequest(prompt_tokens=list(r["prompt"]),
                                             options=options(r))) for r in requests]
            engine.start()
            return [q.result(timeout=300).tokens for q in reqs]
        engine.start()
        out = []
        for r in requests:
            deadline = time.monotonic() + 60
            while (engine.stats()["spill-pages-total"] < r.get("wait_spilled", 0)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            out.append(engine.generate(list(r["prompt"]), options(r), timeout=300).tokens)
        return out
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One world-2 and one world-4 spawn running every run of the file (the
    drill last on world 2), while this process computes the JAX tokens."""
    from torch_spmd_worker import spawn_async

    tmp = tmp_path_factory.mktemp("tiers")
    params, paths = {}, {}
    for model in ("tiny-test", "tiny-moe-test"):
        params[model] = _jax_params(model)
        paths[model] = str(tmp / f"{model}.pkl")
        with open(paths[model], "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, params[model]), f)
    jobs2 = [_job(n, paths) for n in WORLD2] + [_job("paged-model2", paths, DRILL)]
    (tmp / "w2").mkdir()
    (tmp / "w4").mkdir()
    waits = [
        spawn_async({"name": "tiers2", "kind": "multi", "model": "tiny-test", "axes": {},
                     "params": paths["tiny-test"], "jobs": jobs2}, 2, tmp / "w2", 300),
        spawn_async({"name": "tiers4", "kind": "multi", "model": "tiny-test", "axes": {},
                     "params": paths["tiny-test"], "jobs": [_job(n, paths) for n in WORLD4]},
                    4, tmp / "w4", 300),
    ]
    jax_tokens = {name: _jax_tokens(name, params) for name in RUNS}
    got2, got4 = (wait() for wait in waits)
    port = dict(zip(WORLD2, got2[:-1]))
    port.update(zip(WORLD4, got4))
    return port, jax_tokens, got2[-1]


def _in_grammar(tokens, response_format) -> bool:
    dfa = compile_response_format(response_format, ByteTokenizer(), V, None)
    state = 0
    for t in tokens:
        state = dfa.advance(state, int(t))
        if state < 0:
            return False
    return True


# -- F15 ------------------------------------------------------------------------


def test_tp_replica_serves_adapter_and_grammar_requests(served):
    """F15: a TP world-2 replica serves an adapter request with its
    adapter's tokens and a constrained request inside its grammar — the JAX
    single-process mesh engine's tokens (before the tiers rode the wire, a
    multi-rank replica served both as base, free-form text)."""
    port, want, _ = served
    got = port["paged-model2"]
    base, adapted, constrained = (got["tokens"][i] for i in (0, 3, 4))
    assert adapted == want["paged-model2"][3] and constrained == want["paged-model2"][4]
    assert adapted != served[0]["dense-model2"]["tokens"][0], "the adapter changed nothing"
    assert _in_grammar(constrained, DIGITS)
    assert got["stats"]["adapter-swaps-total"] >= 2 and got["stats"]["constrained-requests-total"]


@pytest.mark.parametrize("name", list(RUNS))
def test_tiers_tokens_equal_jax_mesh(served, name):
    """Greedy tokens equal the JAX mesh engine's on every run; every
    constrained output walks its grammar; the leader's echo held on every
    chunk (a mismatch would have crashed the replica); durable stays off
    and migration is refused."""
    port, want, _ = served
    got = port[name]
    assert got["tokens"] == want[name]
    requests = RUNS[name][3]
    constrained = [(t, r["grammar"]) for t, r in zip(got["tokens"], requests) if r.get("grammar")]
    assert constrained and all(_in_grammar(t, g) for t, g in constrained)
    assert not got["durable_on"] and got["migrate_refused"]
    if RUNS[name][2]["kv_layout"] == "paged":
        assert "SPMD" in got["migrate_refused"]
    assert got["stats"]["spmd"] and got["announces"] > 0


@pytest.mark.parametrize("name", [n for n in RUNS if RUNS[n][2].get("host_kv_fraction")])
def test_host_tier_restores_bit_equal_on_every_rank(served, name):
    """Restored hits > 0 with no recompute, and every rank's restored pages
    equal the arena blocks (verified against their spill-time stamps) they
    were uploaded from; each rank restored the same pages, agreeing once a
    restore."""
    port, _, _ = served
    got = port[name]
    assert got["stats"]["restored-hits-total"] > 0
    assert got["stats"]["recompute-fallbacks-total"] == 0
    pages = got["stats"]["restore-pages-total"]
    for rank in got["ranks"]:
        assert rank["restored"] and all(rank["restored"]), rank["coords"]
        assert len(rank["restored"]) == pages and rank["restore_failures"] == 0
    assert got["agreements"] >= got["stats"]["restored-hits-total"]


@pytest.mark.parametrize("name", ["paged-model2", "paged-model4", "dense-model4",
                                  "moe-expert2-model2"])
def test_each_rank_holds_its_slices(served, name):
    """Every rank holds the same grammar planes and adapter rows; its plan
    counts its adapter-pool slice (the pool at the rank's shapes) and an
    arena of its own heads' pages."""
    model, axes, engine, _, _, _ = RUNS[name]
    got = served[0][name]
    ranks = got["ranks"]
    assert all(r["grammar_rows"] == ranks[0]["grammar_rows"] for r in ranks)
    assert all(r["adapter_rows"] == ranks[0]["adapter_rows"] for r in ranks)
    assert ranks[0]["grammar_rows"] and ranks[0]["adapter_rows"]
    from langstream_tpu_torch.parallel.mesh import axis_sizes

    cfg = MODEL_PRESETS[model]
    shape = dict(zip(("data", "expert", "seq", "model"), axis_sizes(axes)))
    local = local_config(cfg, type("M", (), {"shape": shape})())
    want = lora_pool_bytes(local, engine["adapter_pool_rows"], 4, "float32")
    assert all(r["adapter_pool_bytes"] == want for r in ranks)
    assert want < lora_pool_bytes(cfg, engine["adapter_pool_rows"], 4, "float32")
    if engine.get("host_kv_fraction"):
        ways = axes.get("model", 1)
        full = 2 * engine["kv_pages"] * 2 * cfg.n_layers * cfg.n_kv_heads * engine["page_size"] \
            * cfg.resolved_head_dim * 4
        assert all(r["arena_bytes"] == r["host_spill_bytes"] == full // ways for r in ranks)


def test_follower_corruption_drill_falls_back_on_every_rank(served):
    """``spmd-restore``: one follower slot rots before its verify, so the
    agreed verdict is a counted fallback on every rank, no rank uploads,
    and the recomputed session gives the JAX tokens."""
    _, want, drill = served
    assert drill["tokens"] == want["paged-model2"]
    assert drill["stats"]["recompute-fallbacks-total"] >= 1
    assert drill["stats"]["restore-failures-total"] >= 1
    for rank in drill["ranks"]:
        assert rank["restore_failures"] >= 1 and not rank["restored"], rank["coords"]


# -- the wire ----------------------------------------------------------------------


def _loopback(**over):
    kw = dict(prefill_batch=2, max_width=4, max_batch=3, table_len=4, spec_tokens=2,
              decode_chunk=2)
    kw.update(over)
    return wire.LoopbackChannel(**kw)


class _View:
    """The follower engine's side of a payload: its buffer alone."""

    def __init__(self) -> None:
        self._spmd_payload_buf: list = []


@pytest.mark.parametrize("op, n, width, data", [
    (wire.OP_ADMIT_ROWS, 2, 0, np.array([[1, 0], [2, 3], [5, 0]], np.int32)),
    (wire.OP_VERIFY_STATES, 3, 3, np.arange(9, dtype=np.int32).reshape(3, 3)),
    (wire.OP_HOST_SPILL, 4, 0, np.array([7, 1, 2, 9, 0, 3, 5, 6], np.int32)),
    (wire.OP_HOST_RESTORE, 5, 1, np.arange(10, dtype=np.int32)),
])
def test_payload_ops_round_trip(op, n, width, data):
    """A payload op longer than the echo buffer spans blocks of one op
    (the first ``long_start``, the last ``long_final``) and comes back
    whole; a lost piece is a divergence."""
    ch = _loopback()
    ch.echo_pad = 3  # force several blocks
    ch.announce_payload(wire.ControlBlock(op=op, n_rows=n, width=width), data)
    view = _View()
    blocks = [ch.recv(timeout_s=1) for _ in range(-(-data.size // 3))]
    assert blocks[0].long_start and blocks[-1].long_final
    assert all(b.op == op and b.n_rows == n and b.width == width for b in blocks)
    got = [wire._gather_payload(view, b) for b in blocks]
    assert all(g is None for g in got[:-1])
    np.testing.assert_array_equal(got[-1], data.reshape(-1))
    assert ch._q.empty() and len(blocks) > 1
    with pytest.raises(wire.SpmdDivergenceError, match="lost"):
        wire._gather_payload(_View(), blocks[-1])  # its first pieces never arrived


def test_text_ops_and_slot_rows_round_trip():
    """Swaps carry their text (an adapter's spec, a grammar's key) in words
    with its byte length; the slot rows ride phase 1 alone."""
    ch = _loopback()
    key = '{"regex":"[0-9]+é","type":"regex"}'
    ch.announce_payload(wire.ControlBlock(op=wire.OP_GRAMMAR_SWAP, long_idx=3,
                                          prompt_len=len(key.encode())), wire.text_words(key))
    view = _View()
    data = None
    while data is None:
        block = ch.recv(timeout_s=1)
        data = wire._gather_payload(view, block)
    assert block.long_idx == 3 and wire.words_text(data, block.prompt_len) == key
    before = ch.bytes_announced_total
    ch.announce(wire.ControlBlock(op=wire.OP_SLOT_ROWS, n_rows=3,
                                  slots=np.array([0, 2, 1], np.int32),
                                  mask=np.array([4, 0, 1], np.int32)))
    rows = ch.recv(timeout_s=1)
    assert list(rows.slots) == [0, 2, 1] and list(rows.mask[:3]) == [4, 0, 1]
    phase1 = wire._HEAD_LEN + ch.n_pad + ch.max_batch
    assert ch.bytes_announced_total - before == 4 * phase1, "slot rows shipped a payload"
    assert all(wire.SpmdChannel._payload_kind(op) == "echo" for op in wire.PAYLOAD_OPS)
    assert wire.SpmdChannel._payload_kind(wire.OP_SLOT_ROWS) is None
    assert wire.OP_ADAPTER_SWAP > wire.OP_RESYNC and len(
        {wire.OP_ADAPTER_SWAP, wire.OP_GRAMMAR_SWAP, wire.OP_ADMIT_ROWS, wire.OP_SLOT_ROWS,
         wire.OP_VERIFY_STATES, wire.OP_HOST_SPILL, wire.OP_HOST_RESTORE}) == 7


def test_loopback_verdict_is_the_and_of_both_ranks():
    """``agree``: the restore verdict is True only when both ranks' are."""
    import threading

    ch = _loopback(watchdog_s=5.0)
    for mine, theirs in ((True, True), (True, False), (False, True)):
        out = []
        t = threading.Thread(target=lambda: out.append(ch.agree(theirs, leader=False)))
        t.start()
        assert ch.agree(mine) == (mine and theirs)
        t.join(5)
        assert out == [mine and theirs]
    assert ch.agreements_total == 6


def test_runtime_adapter_registration_rides_the_swap():
    """An adapter registered on a leader at run time reaches the follower
    with its first swap (the announcement carries its spec): a loopback
    pair serves it with a single engine's tokens, the echo holding, and
    both adapter pools and grammar pools end bit-equal."""
    import threading

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.serving.engine import GenerationRequest

    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params("tiny-test")), cfg,
                               device="cpu")
    kw = dict(dict(MOE, **AGENTIC), adapters=ADAPTERS[:1])
    late = dict(ADAPTERS[1], name="late", seed=21)
    ch = wire.LoopbackChannel(**_channel(kw))
    leader = ServingEngine(cfg, params, device="cpu", spmd=ch, **kw)
    follower = ServingEngine(cfg, params, device="cpu", spmd=ch, **kw)
    errors: list = []
    thread = threading.Thread(target=lambda: _follow(follower, ch, errors), daemon=True)
    thread.start()
    solo = ServingEngine(cfg, params, device="cpu", **kw)
    leader.start()
    solo.start()
    try:
        for engine in (leader, solo):
            engine.register_adapter(late)
        got, want = [], []
        for adapter, grammar in (("late", None), ("a", DIGITS), ("late", OBJECT)):
            opts = GenerationOptions(max_new_tokens=NEW, temperature=0.0, adapter=adapter,
                                     response_format=grammar)
            for engine, out in ((leader, got), (solo, want)):
                out.append(engine.submit(GenerationRequest(prompt_tokens=list(PROMPT_C),
                                                           options=opts))
                           .result(timeout=120).tokens)
    finally:
        leader.stop()
        solo.stop()
        thread.join(timeout=60)
    assert not errors and not thread.is_alive(), errors
    assert got == want
    assert follower._adapters._by_name["late"].row == leader._adapters._by_name["late"].row
    for proj, ab in leader._adapters.pool.items():
        mine = follower._adapters.pool[proj]
        assert torch.equal(ab, mine) if proj == "scale" else all(
            torch.equal(ab[f], mine[f]) for f in ("a", "b"))
    assert all(torch.equal(a, b) for a, b in zip(leader._constrain_reg.pool,
                                                 follower._constrain_reg.pool))


def _follow(engine, channel, errors: list) -> None:
    try:
        wire.follower_loop(engine, channel)
    except BaseException as e:  # noqa: BLE001 — asserted by the caller
        errors.append(e)


# -- a multi-host replica --------------------------------------------------------


def test_multihost_keeps_the_tiers_off_with_the_warning(caplog):
    """``multihost``: adapters, constrained decoding and the host tier stay
    off with JAX's warning; in one pod the same engine serves them."""
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, _jax_params("tiny-test")), cfg,
                               device="cpu")
    kw = dict(dict(TIER, **AGENTIC), max_batch=2)
    ch = wire.LoopbackChannel(**_channel(TIER))
    with caplog.at_level(logging.WARNING):
        off = ServingEngine(cfg, params, device="cpu", spmd=ch, multihost=True, **kw)
    assert not off._spill_on and off._adapters is None and off._constrain_reg is None
    assert "multi-host replica" in caplog.text and "host-kv-fraction" in caplog.text
    on = ServingEngine(cfg, params, device="cpu", spmd=ch, **kw)
    assert on._spill_on and on._adapters is not None and on._constrain_reg is not None
