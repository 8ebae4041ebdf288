"""Ring prefill over the sequence axis on the CPU: the port's
``parallel/ring_attention.py``, ``parallel/sp.py``, the engine's ring
admission, ``OP_RING`` on the SPMD wire and the provider's ``mesh.seq``,
held against the JAX package (the counterparts of
``tests/test_parallel.py``'s ring tests and ``tests/test_spmd_serving.py``'s
ring lockstep test).

- Spawned gloo ranks (``torch_spmd_worker.py``), one world-8 spawn for
  every mesh: ``sequence_parallel_forward`` at seq 2 ({data: 4, seq: 2}),
  4 ({model: 2, seq: 4}) and 8 against JAX's ``forward`` and JAX's
  ``sequence_parallel_forward`` on the 8-device virtual CPU mesh, within
  2e-4 (an indivisible length raises "divisible"); ``ring_prefill`` at
  {model: 2, seq: 4} (prompt 100 padded to 128) against JAX's
  ``ring_prefill`` and JAX's dense ``prefill``, logits and ``K/V[..., :100]``
  (rank 0's kv heads) within 2e-4; a dense {model: 2, seq: 4} engine whose
  100-token prompt takes the ring, greedy tokens equal to JAX's
  single-device engine and JAX's ring engine, over an f32 cache and an
  int8 cache ("jnp" against "jnp"); a paged engine on the same mesh has
  no ring admit.
- ``OP_RING`` lockstep: a loopback pair in this process (seq ranks 0 and 1
  through ``LoopbackRing``) and two gloo processes {seq: 2}; the 100-token
  prompt is two ``OP_RING`` chunks of prefill_batch x max_width = 64;
  tokens equal JAX's, the tokens, positions and cache bit-equal between
  the ranks; a follower's recovery between chunks leaves no stale chunk.
- The provider with ``mesh: {seq: 2}``, ``kv-layout: dense`` and
  ``device: cpu`` starts its follower process: completions equal the
  single-process provider's; two seq ranks on one card are refused.

f32 tiny-test; tokens are compared exactly."""

import asyncio
import dataclasses
import pickle
import threading
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import forward as jax_forward
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from langstream_tpu.models.transformer import prefill as jax_prefill
from langstream_tpu.parallel.mesh import build_mesh as jax_build_mesh
from langstream_tpu.parallel.sharding import shard_params as jax_shard_params
from langstream_tpu.parallel.sp import ring_prefill as jax_ring_prefill
from langstream_tpu.parallel.sp import sequence_parallel_forward as jax_sp_forward
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.parallel import spmd_serving as wire
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from torch_spmd_worker import spawn

TOL = 2e-4
JCFG = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
INT8 = {"kv_cache_dtype": "int8", "attention_impl": "jnp"}
# the JAX ring engine test's settings: buckets (16, 32), so a 100-token
# prompt is long; prefill_batch 2 x max_width 32 = 64 tokens an OP_RING chunk
ENGINE_KW = dict(max_batch=2, max_seq_len=512, prefill_buckets=(16, 32), decode_chunk=4,
                 prefill_batch=2)
CHANNEL_KW = dict(prefill_batch=2, max_width=32, max_batch=2, decode_chunk=4, echo=True)
PROMPT = [7 + (i % 23) for i in range(100)]
NEW = 10
SP_MESHES = [{"data": 4, "seq": 2}, {"model": 2, "seq": 4}, {"seq": 8}]


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.fixture(scope="module")
def params_path(weights, tmp_path_factory):
    path = tmp_path_factory.mktemp("ring") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, weights[0]), f)
    return str(path)


def _inputs():
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                           JCFG.vocab_size), np.int64)
    rng = np.random.default_rng(3)
    padded = np.zeros((1, 128), np.int64)
    padded[0, :100] = rng.integers(1, JCFG.vocab_size, size=100)
    return tokens, padded, np.array([100], np.int64)


def _engine_job(layout="dense", **over):
    return {"kind": "engine", "engine": dict(ENGINE_KW, kv_layout=layout),
            "channel": dict(CHANNEL_KW, table_len=0), "prompts": [PROMPT], "new_tokens": NEW,
            "overrides": dict(over, dtype="float32")}


@pytest.fixture(scope="module")
def world8(params_path, tmp_path_factory):
    """One world-8 spawn for every mesh of the file, one job after another."""
    tokens, padded, lengths = _inputs()
    mesh42 = {"model": 2, "seq": 4}
    jobs = [{"kind": "sp_forward", "axes": axes, "tokens": tokens} for axes in SP_MESHES]
    jobs += [
        {"kind": "ring_prefill", "axes": mesh42, "tokens": padded, "lengths": lengths},
        dict(_engine_job(), axes=mesh42),
        dict(_engine_job(**INT8), axes=mesh42),
        {"kind": "probe", "axes": mesh42, "engine": dict(ENGINE_KW, kv_layout="paged")},
    ]
    job = {"name": "ring8", "kind": "multi", "model": "tiny-test", "axes": {},
           "overrides": {"dtype": "float32"}, "params": params_path, "jobs": jobs}
    out = spawn(job, 8, tmp_path_factory.mktemp("ring8"))
    return {"sp": dict(zip(("seq2", "seq4", "seq8"), out[:3])), "ring_prefill": out[3],
            "engine": out[4], "engine_int8": out[5], "probe": out[6]}


_JAX_TOKENS: dict = {}


def jax_tokens(jp, mesh_axes=None, **over):
    """The JAX engine's greedy tokens for PROMPT: single-device, or on a
    ring mesh (dense, the model axis' slices), once per setting."""
    key = (tuple(sorted((mesh_axes or {}).items())), tuple(sorted(over.items())))
    if key not in _JAX_TOKENS:
        cfg = dataclasses.replace(JCFG, **over)
        kw = dict(ENGINE_KW)
        if mesh_axes is not None:
            mesh = jax_build_mesh(mesh_axes)
            engine = JaxEngine(cfg, jax_shard_params(jp, mesh, cfg), mesh=mesh,
                               kv_layout="dense", **kw)
            assert engine._ring_admit is not None
        else:
            engine = JaxEngine(cfg, jp, kv_layout="dense", **kw)
        engine.start()
        try:
            _JAX_TOKENS[key] = engine.generate(
                PROMPT, JaxOptions(max_new_tokens=NEW, temperature=0.0), timeout=300).tokens
        finally:
            engine.stop()
    return _JAX_TOKENS[key]


# -- sequence_parallel_forward / ring_prefill ----------------------------------


@pytest.mark.parametrize("name, n", [("seq2", 2), ("seq4", 4), ("seq8", 8)])
def test_sequence_parallel_forward_matches_jax(world8, weights, name, n):
    jp = weights[0]
    tokens, _, _ = _inputs()
    got = world8["sp"][name]
    want = np.asarray(jax_forward(jp, tokens, JCFG))
    np.testing.assert_allclose(got["logits"], want, rtol=TOL, atol=TOL)
    ringed = np.asarray(jax_sp_forward(jp, jnp.asarray(tokens), JCFG, jax_build_mesh({"seq": n})))
    np.testing.assert_allclose(got["logits"], ringed, rtol=TOL, atol=TOL)
    assert "divisible" in got["indivisible"]


def test_sequence_parallel_forward_rejects_indivisible_length(weights):
    from langstream_tpu_torch.parallel.sp import ring_prefill, sequence_parallel_forward

    ring = wire.LoopbackRing.ranks(8, timeout_s=1.0)[0]
    tokens = torch.zeros((1, 30), dtype=torch.long)
    with pytest.raises(ValueError, match="divisible"):
        sequence_parallel_forward(weights[1], tokens, CFG, ring)
    with pytest.raises(ValueError, match="divisible"):
        ring_prefill(weights[1], tokens, torch.tensor([30]), CFG, ring)


def test_ring_prefill_matches_jax_ring_and_dense_prefill(world8, weights):
    jp = weights[0]
    _, padded, lengths = _inputs()
    got = world8["ring_prefill"]
    cache = jax_make_kv_cache(JCFG, 1, 128)
    dense_logits, cache = jax_prefill(jp, jnp.asarray(padded, jnp.int32),
                                      jnp.asarray(lengths, jnp.int32), cache, JCFG)
    ring_logits, kv = jax_ring_prefill(jp, jnp.asarray(padded, jnp.int32),
                                       jnp.asarray(lengths, jnp.int32), JCFG,
                                       jax_build_mesh({"seq": 4}))
    for want in (dense_logits, ring_logits):
        np.testing.assert_allclose(got["logits"], np.asarray(want), rtol=TOL, atol=TOL)
    # rank 0 holds the model axis' first half of the kv heads
    heads = got["k"].shape[2]
    for name in ("k", "v"):
        for want in (cache[name], kv[name]):
            np.testing.assert_allclose(got[name][:, :, :, :100],
                                       np.asarray(want)[:, :, :heads, :100],
                                       rtol=TOL, atol=TOL)


# -- the engine's ring admission ------------------------------------------------


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_ring_engine_tokens_equal_jax(world8, weights, cache):
    """{model: 2, seq: 4}, world 8, dense: the 100-token prompt is admitted
    by the ring; greedy tokens equal JAX's single-device segment loop and
    JAX's ring engine."""
    over = INT8 if cache == "int8" else {}
    got = world8["engine" if cache == "f32" else "engine_int8"]
    assert got["stats"]["ring-admissions-total"] == 1
    assert got["stats"]["prefill-segments-total"] == 0
    assert got["tokens"] == [jax_tokens(weights[0], **over)]
    assert got["tokens"] == [jax_tokens(weights[0], {"model": 2, "seq": 4}, **over)]


def test_paged_engine_on_a_seq_mesh_has_no_ring_admit(world8):
    assert world8["probe"] == {"ring_admit": False}


def _assert_rank_states_equal(states: list) -> None:
    """The ranks of each seq group (same model coordinate) hold bit-equal
    tokens, positions and caches."""
    groups: dict = {}
    for st in states:
        groups.setdefault(st["coords"]["model"], []).append(st)
    for members in groups.values():
        a = members[0]
        for b in members[1:]:
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["positions"], b["positions"])
            for x, y in zip(a["cache"], b["cache"]):
                np.testing.assert_array_equal(x, y)


# -- OP_RING lockstep -------------------------------------------------------------


class RingPair:
    """Seq ranks 0 and 1 of one replica in this process: a leader and a
    follower engine over a loopback channel, their ring a ``LoopbackRing``."""

    def __init__(self, params, **over):
        self.channel = wire.LoopbackChannel(**dict(CHANNEL_KW, table_len=0))
        rings = wire.LoopbackRing.ranks(2, timeout_s=60.0)
        cfg = dataclasses.replace(CFG, **over)
        self.leader = ServingEngine(cfg, params, device="cpu", spmd=self.channel, ring=rings[0],
                                    kv_layout="dense", **ENGINE_KW)
        self.follower = ServingEngine(cfg, params, device="cpu", spmd=self.channel,
                                      ring=rings[1], kv_layout="dense", **ENGINE_KW)
        self.error: list = []

        def run():
            try:
                wire.follower_loop(self.follower, self.channel)
            except BaseException as e:  # noqa: BLE001 — asserted by the tests
                self.error.append(e)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def stop(self):
        self.leader.stop()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive(), "follower never saw STOP"


def test_loopback_ring_pair_lockstep_and_tokens_equal_jax(weights):
    pair = RingPair(weights[1])
    assert pair.leader._ring_admit and pair.follower._ring_admit
    ring_ops = []
    announce = pair.channel.announce

    def counting(block):
        if block.op == wire.OP_RING:
            ring_ops.append((block.long_start, block.long_final, block.seg_len))
        announce(block)

    pair.channel.announce = counting
    pair.leader.start()
    try:
        got = pair.leader.generate(PROMPT, GenerationOptions(max_new_tokens=NEW, temperature=0.0),
                                   timeout=120).tokens
        stats = pair.leader.stats()
    finally:
        pair.stop()
    assert not pair.error, pair.error
    assert ring_ops == [(True, False, 64), (False, True, 36)]
    assert stats["ring-admissions-total"] == 1 and stats["prefill-segments-total"] == 0
    assert got == jax_tokens(weights[0])
    assert torch.equal(pair.leader._tokens_dev, pair.follower._tokens_dev)
    assert torch.equal(pair.leader._positions_dev, pair.follower._positions_dev)
    for name in ("k", "v"):
        assert torch.equal(pair.leader._cache[name], pair.follower._cache[name])


def test_follower_recovery_between_ring_chunks_leaves_no_stale_chunk(weights):
    """An OP_RECOVER between a prompt's chunks clears the follower's ring
    buffer; the next stream starts from its own first chunk."""
    ring = wire.LoopbackRing.ranks(2, timeout_s=1.0)[1]
    follower = ServingEngine(CFG, weights[1], device="cpu", ring=ring, kv_layout="dense",
                             spmd=wire.LoopbackChannel(**dict(CHANNEL_KW, table_len=0)),
                             **ENGINE_KW)
    follower._spmd_follower = True
    first = wire.ControlBlock(op=wire.OP_RING, width=32, n_rows=2,
                              tokens=np.arange(64, dtype=np.int32).reshape(2, 32), seg_len=64,
                              long_start=True, long_idx=0, prompt_len=100,
                              temps=np.zeros(1, np.float32), top_ks=np.zeros(1, np.int32),
                              top_ps=np.ones(1, np.float32))
    wire._replay(follower, first, follower._spmd, deque())
    assert len(follower._spmd_ring_buf) == 1
    follower._spmd_follower_recover(1)
    assert follower._spmd_ring_buf == []


def test_two_process_ring_lockstep_equals_jax(weights, params_path, tmp_path):
    """{seq: 2} over gloo: rank 0 leads, rank 1 replays the OP_RING chunks
    and makes its half of the ring; tokens equal JAX's, both ranks' state
    bit-equal."""
    job = dict(_engine_job(), name="seq2", model="tiny-test", axes={"seq": 2},
               params=params_path, gather_state=True)
    got = spawn(job, 2, tmp_path)
    assert got["tokens"] == [jax_tokens(weights[0])]
    assert got["stats"]["ring-admissions-total"] == 1
    _assert_rank_states_equal(got["states"])


# -- the provider -------------------------------------------------------------------


def test_provider_seq_mesh_tokens_equal_single_process():
    from langstream_tpu_torch.ai.torch_serving import TorchServingProvider

    resource = {"model": "tiny-test", "device": "cpu", "max-seq-len": 512,
                "prefill-buckets": [16, 32], "max-batch": 2, "decode-chunk": 4,
                "prefill-batch": 2, "kv-layout": "dense", "spmd-parity-echo": True,
                "mesh": {"seq": 2}}
    prompts = ["the quick brown fox jumps over the lazy dog " * 3, "hello world"]

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
    assert stats["ring-admissions-total"] == 1
    solo = {k: v for k, v in resource.items() if k not in ("mesh", "spmd-parity-echo")}
    want, _, solo_stats = asyncio.run(serve(solo))
    assert solo_stats["ring-admissions-total"] == 0
    assert got == want


@pytest.mark.parametrize("axes", [{"seq": 2}, {"model": 2}, {"data": 2, "seq": 2}])
def test_provider_refuses_two_device_group_ranks_on_one_card(monkeypatch, axes):
    """NCCL cannot put two ranks of one group on one card: a seq (or model)
    axis above 1 on a one-card host is refused when the service is built."""
    from langstream_tpu_torch.ai import torch_serving

    monkeypatch.setattr(torch_serving, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card"):
        torch_serving.TorchCompletionsService({"model": "tiny-test", "mesh": axes,
                                               "kv-layout": "dense"})
