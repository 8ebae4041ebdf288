"""The decode chunk as a captured graph, off the card: a stand-in graph
object that replays the captured callable drives the engine's replay path
on the CPU (tiny-test, f32). The chunk function writes only into static
buffers (their addresses never change), its tokens equal the JAX engine's
on both layouts, every sampling branch is captured once, in order, and the
kernel counts are exact per replay: a capture's own calls are not counted,
k replays count k times one chunk's launches."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import (
    add_counts,
    count_delta,
    count_snapshot,
    kernel_counts,
    reset_kernel_counts,
)
from langstream_tpu_torch.serving.engine import DECODE_BRANCHES, GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault

JCFG = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
ENGINE_KW = dict(max_batch=4, max_seq_len=256, decode_chunk=4, prefill_buckets=(32, 64, 128))
PROMPT_LENS = (3, 17, 40, 63, 100, 150)  # the 150-token prompt takes 2 segments of 128
NEW_TOKENS = 20


class ReplayGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` off the card: ``capture``
    runs the function once (the recording), ``replay`` runs it again with
    the kernel counts held where they were — a real replay runs no host
    code, so only the engine's per-replay accounting may count it."""

    def __init__(self) -> None:
        self.fn = None
        self.replays = 0

    def capture(self, fn) -> None:
        self.fn = fn
        fn()

    def replay(self) -> None:
        before = count_snapshot()
        self.fn()
        add_counts(count_delta(before, count_snapshot()), -1)
        self.replays += 1


class FailingGraph(ReplayGraph):
    def capture(self, fn) -> None:
        raise RuntimeError("capture refused")


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, CFG.vocab_size, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(params):
    out = {}
    for layout in ("paged", "dense"):
        engine = JaxEngine(JCFG, params[0], kv_layout=layout, **ENGINE_KW)
        opts = JaxOptions(max_new_tokens=NEW_TOKENS)
        reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts)) for p in prompts()]
        engine.start()
        try:
            out[layout] = [r.result(timeout=300).tokens for r in reqs]
        finally:
            engine.stop()
    return out


def graphed_engine(tparams, layout, **kw):
    engine = ServingEngine(CFG, tparams, device="cpu", kv_layout=layout, **{**ENGINE_KW, **kw})
    engine._graph_factory = ReplayGraph
    return engine


def static_addresses(engine) -> dict:
    names = ("_tokens_dev", "_positions_dev", "_temp_dev", "_top_k_dev", "_top_p_dev",
             "_chunk_out", "_table_dev")
    out = {n: getattr(engine, n).data_ptr() for n in names if getattr(engine, n) is not None}
    tree = engine._pagepool.dev if engine._paged else engine._cache
    for name, entry in tree.items():
        for leaf, t in (entry.items() if isinstance(entry, dict) else ((name, entry),)):
            out[f"kv.{name}.{leaf}"] = t.data_ptr()
    return out


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_replayed_chunks_keep_static_buffers_and_give_jax_tokens(params, jax_tokens, layout):
    """Every chunk through the stand-in graphs: the chain, table, output
    and KV buffers keep their addresses over many chunks, and the tokens
    are the JAX engine's (every request submitted before either engine
    starts, so both form the same admit groups)."""
    engine = graphed_engine(params[1], layout)
    opts = GenerationOptions(max_new_tokens=NEW_TOKENS)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts()]
    engine.start()
    before = static_addresses(engine)
    try:
        results = [r.result(timeout=300) for r in reqs]
    finally:
        engine.stop()
    assert [r.tokens for r in results] == jax_tokens[layout]
    stats = engine.stats()
    assert stats["decode-chunks-total"] >= 8
    assert stats["graph-replays-total"] == stats["decode-chunks-total"]
    assert static_addresses(engine) == before


def test_every_branch_is_captured_once_in_order(params):
    engine = graphed_engine(params[1], "paged")
    engine._capture_graphs()
    assert list(engine._graphs) == list(DECODE_BRANCHES)
    stats = engine.stats()
    assert stats["compiled_programs"] == 3 and stats["graph-captures-total"] == 3
    # the sampling branch follows the active slots' options
    engine.start()
    try:
        for opts, branch in (
            (GenerationOptions(max_new_tokens=6), (False, False)),
            (GenerationOptions(max_new_tokens=6, temperature=0.8), (True, False)),
            (GenerationOptions(max_new_tokens=6, temperature=0.8, top_k=5), (True, True)),
        ):
            graph = engine._graphs[branch][0]
            replays = graph.replays
            res = engine.generate([3, 4, 5], opts, timeout=120)
            assert len(res.tokens) == 6
            assert graph.replays > replays
    finally:
        engine.stop()
    assert engine.stats()["graph-captures-total"] == 3  # no capture after start


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_launch_counts_are_exact_per_replay(params, layout):
    """A capture's own calls are removed from the counts; k replays add k
    times one chunk's calls (layers x steps of the decode kernel)."""
    reset_kernel_counts()
    engine = graphed_engine(params[1], layout)
    engine._capture_graphs()
    assert all(v == {"launches": 0, "cpu_calls": 0} for v in kernel_counts().values())
    kernel = "paged_decode" if layout == "paged" else "dense_decode"
    graph, delta = engine._graphs[(False, False)]
    assert delta == {kernel: (0, CFG.n_layers * engine.decode_chunk)}
    with torch.no_grad():
        for k in range(1, 4):
            engine._run_chunk((False, False))
            assert kernel_counts()[kernel]["cpu_calls"] == k * CFG.n_layers * engine.decode_chunk
    assert graph.replays == 3
    others = {n: c for n, c in kernel_counts().items() if n != kernel}
    assert all(c == {"launches": 0, "cpu_calls": 0} for c in others.values())


def test_served_decode_counts_equal_layers_times_steps(params):
    reset_kernel_counts()
    engine = graphed_engine(params[1], "paged")
    engine.start()
    try:
        before = engine.stats()
        reset_kernel_counts()
        engine.generate([3, 4, 5], GenerationOptions(max_new_tokens=13), timeout=120)
        after = engine.stats()
    finally:
        engine.stop()
    steps = after["decode-steps-total"] - before["decode-steps-total"]
    assert steps > 0
    assert after["kernels"]["paged_decode"]["cpu_calls"] == CFG.n_layers * steps


def test_a_failed_capture_raises_from_start(params):
    engine = ServingEngine(CFG, params[1], device="cpu", **ENGINE_KW)
    engine._graph_factory = FailingGraph
    with pytest.raises(RuntimeError, match="capture refused"):
        engine.start()
    assert engine._thread is None and not engine._graphs


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_a_restart_rebuilds_the_buffers_and_captures_again(params, layout):
    engine = graphed_engine(
        params[1], layout, max_batch=1, restart_backoff_s=0.01,
        fault_injector=FaultInjector("decode@2", seed=0),
    )
    engine.start()
    first = static_addresses(engine)
    try:
        doomed = engine.submit(GenerationRequest(
            prompt_tokens=[3, 4], options=GenerationOptions(max_new_tokens=40)
        ))
        with pytest.raises(InjectedFault):
            doomed.result(timeout=120)
        res = engine.generate([5, 6], GenerationOptions(max_new_tokens=6), timeout=120)
        assert len(res.tokens) == 6
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["engine-restarts-total"] == 1
    assert stats["graph-captures-total"] == 6 and stats["compiled_programs"] == 3
    rebuilt = static_addresses(engine)
    assert rebuilt.keys() == first.keys()
    # the graphs hold raw pointers: after the rebuild they read the new buffers
    assert all(g.fn is not None for g, _ in engine._graphs.values())
