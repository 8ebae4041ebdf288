"""The port's request lifecycle and fault recovery on the CPU (tiny sizes),
driven by its fault injector: the behaviours of the JAX package's
``tests/test_engine_faults.py`` that the port serves, with the survivors of
every fault held token-exact against the JAX engine's greedy tokens on the
same weights (through ``bridge``).

Variants: tiny-test on the paged and the dense layout, in f32 and with int8
KV (int8 through the reference attention on both sides, "jnp" against
"jnp": the JAX package's CPU ``auto`` path quantizes q and p, the port's
kernel path does not), and tiny-moe-test on the paged layout. Every test
runs under its own wall-clock bound (``bounded``), so a wedged engine fails
its test instead of stalling the run."""

import dataclasses
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving.engine import (
    DeadlineExceededError,
    GenerationRequest,
    LogitsNaNError,
    ServingEngine,
    ShedError,
    _TokenFetcher,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault

# name → (preset, kv cache dtype, attention_impl, layout)
VARIANTS = {
    "paged-f32": ("tiny-test", "model", "auto", "paged"),
    "paged-int8": ("tiny-test", "int8", "jnp", "paged"),
    "dense-f32": ("tiny-test", "model", "auto", "dense"),
    "dense-int8": ("tiny-test", "int8", "jnp", "dense"),
    "paged-moe": ("tiny-moe-test", "model", "auto", "paged"),
}
WAIT = 90.0  # a single result() wait


def bounded(seconds: float):
    """Run the test body on a thread and fail the test when it outlives
    ``seconds``: no engine that wedges can stall the whole run."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box: dict = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            thread = threading.Thread(target=body, daemon=True)
            thread.start()
            thread.join(seconds)
            if thread.is_alive():
                pytest.fail(f"{fn.__name__} outlived its {seconds:.0f}s bound")
            if "error" in box:
                raise box["error"]

        return run

    return wrap


@functools.lru_cache(maxsize=None)
def _configs(variant: str):
    preset, kv, impl, layout = VARIANTS[variant]
    fields = dict(dtype="float32", attention_impl=impl, kv_cache_dtype=kv)
    return (
        dataclasses.replace(JAX_PRESETS[preset], **fields),
        dataclasses.replace(MODEL_PRESETS[preset], **fields),
        layout,
    )


@functools.lru_cache(maxsize=None)
def _weights(preset: str):
    jcfg = dataclasses.replace(JAX_PRESETS[preset], dtype="float32")
    tcfg = dataclasses.replace(MODEL_PRESETS[preset], dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_solo(variant: str, prompt: tuple, max_new: int, max_batch: int = 2,
             max_seq_len: int = 128) -> list[int]:
    """The JAX engine's greedy tokens for ``prompt`` admitted alone, on an
    engine of the same shape as the port's."""
    jcfg, _, layout = _configs(variant)
    engine = JaxEngine(
        jcfg, _weights(VARIANTS[variant][0])[0], max_batch=max_batch,
        max_seq_len=max_seq_len, decode_chunk=4, kv_layout=layout,
    )
    engine.start()
    try:
        return engine.generate(
            list(prompt), JaxOptions(max_new_tokens=max_new), timeout=WAIT
        ).tokens
    finally:
        engine.stop()


def make_engine(variant: str = "paged-f32", **kw) -> ServingEngine:
    _, tcfg, layout = _configs(variant)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("restart_backoff_s", 0.02)
    engine = ServingEngine(
        tcfg, _weights(VARIANTS[variant][0])[1], kv_layout=layout, device="cpu", **kw
    )
    engine.start()
    return engine


def submit_and_wait_first_token(engine, prompt, max_new, **opts):
    """Submit and block until the first token lands: the request is then
    active in a slot, its prefill dispatched."""
    got = threading.Event()
    req = GenerationRequest(
        prompt_tokens=list(prompt),
        options=GenerationOptions(max_new_tokens=max_new, **opts),
        on_token=lambda _t: got.set(),
    )
    engine.submit(req)
    assert got.wait(WAIT), "first token never arrived"
    return req


def _kv_rows_zero(engine, idx: int, upto: int) -> bool:
    """Dense: the big cache's row ``idx`` is zero over columns [0, upto)."""
    leaves = [
        leaf for e in engine._cache.values()
        for leaf in (e.values() if isinstance(e, dict) else (e,))
    ]
    return all(bool((leaf[:, idx, :, :upto] == 0).all()) for leaf in leaves)


def _pages_zero(engine, pages) -> bool:
    leaves = [
        leaf for e in engine._pagepool.dev.values()
        for leaf in (e.values() if isinstance(e, dict) else (e,))
    ]
    idx = torch.tensor(sorted(pages), dtype=torch.long)
    return all(bool((leaf[:, idx] == 0).all()) for leaf in leaves)


# -- injected dispatch faults: only the touched work fails -----------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
@bounded(150)
def test_prefill_fault_fails_only_its_group(variant):
    p1, p2, p3 = [3, 4, 5], [7, 8], [9, 10, 11]
    ref = jax_solo(variant, tuple(p1), 20)
    engine = make_engine(variant, fault_injector=FaultInjector("prefill@2", seed=0))
    try:
        r1 = submit_and_wait_first_token(engine, p1, 20)  # prefill dispatch 1
        r2 = engine.submit(GenerationRequest(
            prompt_tokens=p2, options=GenerationOptions(max_new_tokens=20)
        ))  # prefill dispatch 2: the injected fault
        with pytest.raises(InjectedFault):
            r2.result(timeout=WAIT)
        assert r1.result(timeout=WAIT).tokens == ref
        r3 = engine.generate(p3, GenerationOptions(max_new_tokens=5), timeout=WAIT)
        assert len(r3.tokens) == 5
        stats = engine.stats()
        assert stats["engine-restarts-total"] == 0  # a group failure is no crash
        assert stats["fault-injection"] == {"prefill": 1}
        if engine._pagepool is not None:
            assert engine._pagepool.pages_in_use == 0
    finally:
        engine.stop()


@pytest.mark.parametrize("variant", list(VARIANTS))
@bounded(150)
def test_nan_quarantines_one_slot_and_zeroes_its_kv(variant):
    """The ``nan`` site fails one slot: its request raises LogitsNaNError,
    its pages (paged) or its row (dense) read back as zeros, the survivor
    is token-exact against the JAX engine, the slot serves again."""
    p1, p2 = [3, 4, 5], [7, 8]
    refs = {tuple(p): jax_solo(variant, tuple(p), 20) for p in (p1, p2)}
    engine = make_engine(variant, fault_injector=FaultInjector("nan@3", seed=0))
    quarantined: dict = {}
    if engine._paged:
        keep = engine._quarantine_pages

        def recording(idx):
            quarantined[idx] = engine._pagepool.slot_pages(idx)
            keep(idx)

        engine._quarantine_pages = recording
    try:
        r1 = submit_and_wait_first_token(engine, p1, 20)
        r2 = submit_and_wait_first_token(engine, p2, 20)
        outcomes = {}
        for req, prompt in ((r1, p1), (r2, p2)):
            try:
                outcomes[tuple(prompt)] = req.result(timeout=WAIT)
            except LogitsNaNError:
                outcomes[tuple(prompt)] = None
        victims = [k for k, v in outcomes.items() if v is None]
        assert len(victims) == 1, "exactly one slot must be quarantined"
        survivor = next(k for k in outcomes if k not in victims)
        assert outcomes[survivor].tokens == refs[survivor]
        stats = engine.stats()
        assert stats["nan-guard-total"] == 1
        assert stats["quarantined-slots-total"] == 1
        assert stats["engine-restarts-total"] == 0
        deadline = time.monotonic() + WAIT  # zeroed at the next iteration's top
        if engine._paged:
            (pages,) = quarantined.values()
            assert pages, "the victim held pages"
            while engine._pending_page_zero and time.monotonic() < deadline:
                time.sleep(0.01)
            assert _pages_zero(engine, pages)
        else:
            victim_slot = 0 if victims[0] == tuple(p1) else 1
            while engine._pending_row_resets and time.monotonic() < deadline:
                time.sleep(0.01)
            # columns below the prompt's end are never written again
            assert _kv_rows_zero(engine, victim_slot, len(victims[0]))
        r3 = engine.generate([9, 9], GenerationOptions(max_new_tokens=4), timeout=WAIT)
        assert len(r3.tokens) == 4
    finally:
        engine.stop()


@pytest.mark.parametrize("variant", list(VARIANTS))
@bounded(150)
def test_decode_fault_restarts_engine_and_keeps_the_queue(variant):
    p1, p2 = [3, 4, 5], [7, 8]
    ref2 = jax_solo(variant, tuple(p2), 10, max_batch=1)
    engine = make_engine(
        variant, max_batch=1, fault_injector=FaultInjector("decode@3", seed=0)
    )
    try:
        r1 = submit_and_wait_first_token(engine, p1, 100)  # hits decode 3
        r2 = engine.submit(GenerationRequest(
            prompt_tokens=p2, options=GenerationOptions(max_new_tokens=10)
        ))  # queued behind r1, never dispatched before the crash
        with pytest.raises(InjectedFault):
            r1.result(timeout=WAIT)
        assert r2.result(timeout=WAIT).tokens == ref2
        stats = engine.stats()
        assert stats["engine-restarts-total"] == 1
        assert stats["quarantined-slots-total"] == 1
        r3 = engine.generate([1, 2], GenerationOptions(max_new_tokens=4), timeout=WAIT)
        assert len(r3.tokens) == 4
    finally:
        engine.stop()


@bounded(120)
def test_restart_budget_exhausted_fails_engine():
    engine = make_engine(
        max_batch=1, fault_injector=FaultInjector("decode@1+", seed=0),
        restart_backoff_s=0.01, max_restarts=2,
    )
    try:
        failures = 0
        deadline = time.monotonic() + WAIT
        while engine._dead is None and time.monotonic() < deadline:
            req = GenerationRequest(
                prompt_tokens=[3, 4], options=GenerationOptions(max_new_tokens=8)
            )
            try:
                engine.submit(req)
            except RuntimeError:
                break  # declared dead between the check and the submit
            with pytest.raises(InjectedFault):
                req.result(timeout=WAIT)
            failures += 1
        assert engine._dead is not None, "the supervisor never gave up"
        assert failures == 3  # a budget of 2 restarts: the third crash is fatal
        assert engine.stats()["engine-restarts-total"] == 2
        with pytest.raises(RuntimeError, match="stopped"):
            engine.submit(GenerationRequest(
                prompt_tokens=[1], options=GenerationOptions(max_new_tokens=2)
            ))
    finally:
        engine.stop()


@bounded(120)
def test_sticky_cuda_error_fails_everything_without_a_restart():
    """A CUDA error that poisons the context (an illegal address) cannot be
    recovered in-process: the loop fails every request instead of
    restarting into the same error."""
    engine = make_engine(max_batch=1, max_restarts=5)
    keep = engine._run_chunk

    def poisoned(branch):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    try:
        engine._run_chunk = poisoned
        req = engine.submit(GenerationRequest(
            prompt_tokens=[3, 4], options=GenerationOptions(max_new_tokens=8)
        ))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            req.result(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while engine._dead is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine._dead is not None
        assert engine.stats()["engine-restarts-total"] == 0
    finally:
        engine._run_chunk = keep
        engine.stop()


@bounded(120)
def test_segment_fault_fails_only_its_stream():
    """The ``segment`` site fails the long prompt's stream (its pages come
    back) while a short request decodes on, token-exact."""
    short = [3, 4, 5]
    ref = jax_solo("paged-f32", tuple(short), 12, max_seq_len=256)
    engine = make_engine(
        max_seq_len=256, prefill_buckets=(32, 64),
        fault_injector=FaultInjector("segment@2", seed=0),
    )
    try:
        r1 = submit_and_wait_first_token(engine, short, 12)
        long_req = engine.submit(GenerationRequest(
            prompt_tokens=[(5 + i) % 200 + 1 for i in range(150)],
            options=GenerationOptions(max_new_tokens=4),
        ))
        with pytest.raises(InjectedFault):
            long_req.result(timeout=WAIT)
        assert r1.result(timeout=WAIT).tokens == ref
        assert engine._pagepool.pages_in_use == 0
        assert not engine._longs
    finally:
        engine.stop()


@bounded(120)
def test_page_table_corruption_quarantines_only_the_victim():
    """The ``page`` site corrupts one active slot's table row: the integrity
    check before the decode dispatch fails that slot only, its pages come
    back through the owned list, the survivor stays token-exact."""
    p1, p2 = [3, 4, 5], [7, 8]
    refs = {tuple(p): jax_solo("paged-f32", tuple(p), 16) for p in (p1, p2)}
    engine = make_engine(fault_injector=FaultInjector("page@4", seed=0))
    try:
        r1 = submit_and_wait_first_token(engine, p1, 16)
        r2 = submit_and_wait_first_token(engine, p2, 16)
        outcomes = {}
        for req, prompt in ((r1, p1), (r2, p2)):
            try:
                outcomes[tuple(prompt)] = req.result(timeout=WAIT).tokens
            except RuntimeError as e:
                assert "page-table corruption" in str(e)
                outcomes[tuple(prompt)] = None
        survivors = {k: v for k, v in outcomes.items() if v is not None}
        assert len(survivors) == 1
        for k, v in survivors.items():
            assert v == refs[k]
        assert engine.stats()["quarantined-slots-total"] == 1
        assert engine._pagepool.pages_in_use == 0
    finally:
        engine.stop()


# -- shedding ----------------------------------------------------------------------


@bounded(90)
def test_full_queue_sheds_instead_of_blocking():
    engine = make_engine(max_batch=1, max_seq_len=1024, queue_depth=2, shed_policy="reject")
    try:
        busy = submit_and_wait_first_token(engine, [3, 4], 800)
        queued = [
            engine.submit(GenerationRequest(
                prompt_tokens=[5 + i], options=GenerationOptions(max_new_tokens=2)
            ))
            for i in range(2)
        ]
        t0 = time.monotonic()
        with pytest.raises(ShedError) as e:
            engine.submit(GenerationRequest(
                prompt_tokens=[9], options=GenerationOptions(max_new_tokens=2)
            ))
        assert time.monotonic() - t0 < 1.0, "a shed must be immediate, not a block"
        assert e.value.retry_after_s > 0
        assert engine.stats()["shed-total"] >= 1
        assert len(queued) == 2
        busy.cancel()
    finally:
        engine.stop()


@bounded(90)
def test_hopeless_deadline_shed_at_submit():
    engine = make_engine(max_batch=1, max_seq_len=1024)
    try:
        busy = submit_and_wait_first_token(engine, [3, 4], 800)
        engine._queue_wait_ema_s = 5.0  # a long observed queue wait
        engine.submit(GenerationRequest(  # the queue is not empty
            prompt_tokens=[5], options=GenerationOptions(max_new_tokens=2)
        ))
        with pytest.raises(ShedError):
            engine.submit(GenerationRequest(
                prompt_tokens=[6],
                options=GenerationOptions(max_new_tokens=2, deadline_s=0.5),
            ))
        assert engine.stats()["shed-total"] == 1
        busy.cancel()
    finally:
        engine.stop()


# -- deadlines -----------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["paged-f32", "dense-f32"])
@bounded(90)
def test_deadline_in_queue_resolves_promptly_while_slots_busy(variant):
    engine = make_engine(variant, max_batch=1, max_seq_len=1024)
    try:
        busy = submit_and_wait_first_token(engine, [3, 4], 800)
        req = GenerationRequest(
            prompt_tokens=[5, 6],
            options=GenerationOptions(max_new_tokens=4, max_queue_wait_s=0.05),
        )
        t0 = time.monotonic()
        engine.submit(req)
        with pytest.raises(DeadlineExceededError):
            req.result(timeout=WAIT)
        # the sweep resolves it within iterations, not when the slot frees
        assert time.monotonic() - t0 < 10.0
        assert engine.stats()["deadline-queue-total"] == 1
        busy.cancel()
    finally:
        engine.stop()


@bounded(120)
def test_deadline_in_long_prompt_backlog_resolves_promptly():
    """A long prompt whose max-queue-wait expires while it waits in the
    long backlog (one prefill stream, held by another long prompt) resolves
    through the sweep, not when the stream frees."""
    engine = make_engine(max_batch=2, max_seq_len=2048, prefill_buckets=(16, 32))
    engine.MAX_PREFILL_STREAMS = 1
    try:
        busy = engine.submit(GenerationRequest(
            prompt_tokens=[(3 + i) % 200 + 1 for i in range(1900)],
            options=GenerationOptions(max_new_tokens=4),
        ))
        deadline = time.monotonic() + WAIT
        while not engine._longs and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine._longs, "the saturating stream never started"
        req = GenerationRequest(
            prompt_tokens=[(5 + i) % 200 + 1 for i in range(100)],  # wider than 32
            options=GenerationOptions(max_new_tokens=4, max_queue_wait_s=0.2),
        )
        t0 = time.monotonic()
        engine.submit(req)
        with pytest.raises(DeadlineExceededError):
            req.result(timeout=WAIT)
        assert time.monotonic() - t0 < 15.0
        assert engine.stats()["deadline-queue-total"] == 1
        busy.cancel()
    finally:
        engine.stop()


@pytest.mark.parametrize("variant", ["paged-f32", "dense-f32"])
@bounded(120)
def test_deadline_mid_decode_returns_partial_tokens(variant):
    engine = make_engine(variant, max_batch=1, max_seq_len=4096)
    try:
        req = GenerationRequest(
            prompt_tokens=[3, 4],
            options=GenerationOptions(max_new_tokens=100000, deadline_s=1.0),
        )
        engine.submit(req)
        result = req.result(timeout=WAIT)
        assert result.finish_reason == "deadline"
        assert 0 < len(result.tokens) < 4000
        # the partial tokens are the greedy ones
        ref = jax_solo(variant, (3, 4), len(result.tokens), max_batch=1, max_seq_len=4096)
        assert result.tokens == ref
        assert engine.stats()["deadline-decode-total"] == 1
    finally:
        engine.stop()


# -- cancellation --------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["paged-f32", "dense-f32"])
@bounded(90)
def test_cancel_frees_slot_within_one_chunk(variant):
    engine = make_engine(variant, max_batch=1, max_seq_len=2048)
    try:
        r1 = submit_and_wait_first_token(engine, [3, 4], 100000)
        chunks = engine.stats()["decode-chunks-total"]
        r1.cancel()
        res = r1.result(timeout=WAIT)
        assert res.finish_reason == "cancelled" and res.error is None
        # processed within the chunk in flight and the one after it
        assert engine.stats()["decode-chunks-total"] - chunks <= 3
        r2 = engine.generate([5, 6], GenerationOptions(max_new_tokens=4), timeout=WAIT)
        assert len(r2.tokens) == 4
        assert engine.stats()["cancelled-total"] == 1
        if engine._pagepool is not None:
            assert engine._pagepool.pages_in_use == 0
    finally:
        engine.stop()


@bounded(90)
def test_cancel_queued_request_resolves_without_admission():
    engine = make_engine(max_batch=1, max_seq_len=1024)
    try:
        busy = submit_and_wait_first_token(engine, [3, 4], 800)
        req = engine.submit(GenerationRequest(
            prompt_tokens=[5], options=GenerationOptions(max_new_tokens=4)
        ))
        req.cancel()
        res = req.result(timeout=30)  # the sweep, while the slot is busy
        assert res.finish_reason == "cancelled" and res.tokens == []
        assert engine.stats()["admit-groups-total"] == 1
        busy.cancel()
    finally:
        engine.stop()


@bounded(90)
def test_generate_timeout_cancels_the_orphan():
    engine = make_engine(max_batch=1, max_seq_len=2048)
    try:
        with pytest.raises(TimeoutError):
            engine.generate([3, 4], GenerationOptions(max_new_tokens=100000), timeout=1.0)
        r2 = engine.generate([5], GenerationOptions(max_new_tokens=3), timeout=WAIT)
        assert len(r2.tokens) == 3
        assert engine.stats()["cancelled-total"] >= 1
    finally:
        engine.stop()


# -- drain ---------------------------------------------------------------------------


@bounded(90)
def test_drain_finishes_accepted_work_and_rejects_new():
    engine = make_engine(max_batch=1)
    try:
        active = submit_and_wait_first_token(engine, [3, 4], 12)
        queued = engine.submit(GenerationRequest(
            prompt_tokens=[5, 6], options=GenerationOptions(max_new_tokens=6)
        ))
        assert engine.drain(grace_s=WAIT) is True
        with pytest.raises(ShedError):
            engine.submit(GenerationRequest(
                prompt_tokens=[7], options=GenerationOptions(max_new_tokens=2)
            ))
        assert active.result(timeout=5).finish_reason == "length"
        assert queued.result(timeout=5).finish_reason == "length"
        assert engine.stats()["draining"] is True
    finally:
        engine.stop()


@bounded(90)
def test_drain_grace_expires_with_work_in_flight():
    engine = make_engine(max_batch=1, max_seq_len=2048)
    try:
        r1 = submit_and_wait_first_token(engine, [3, 4], 100000)
        assert engine.drain(grace_s=0.2) is False
        r1.cancel()
    finally:
        engine.stop()


# -- stall sites and the fetch thread --------------------------------------------------


@pytest.mark.parametrize("variant", ["paged-f32", "dense-f32"])
@bounded(120)
def test_fetch_and_client_stalls_do_not_corrupt_output(variant):
    prompt = [3, 4, 5]
    ref = jax_solo(variant, tuple(prompt), 16)
    engine = make_engine(
        variant, fault_injector=FaultInjector("fetch@1:2,client@1:3", seed=0, stall_s=0.02)
    )
    try:
        res = engine.generate(prompt, GenerationOptions(max_new_tokens=16), timeout=WAIT)
        assert res.tokens == ref
        fired = engine.stats()["fault-injection"]
        assert fired["fetch"] >= 1 and fired["client"] >= 1
    finally:
        engine.stop()


@bounded(60)
def test_fetch_thread_keeps_submission_order():
    """Fetches land in the order they were submitted, a stall on the fetch
    thread included; a fetch made while no thread runs is read inline."""
    fetcher = _TokenFetcher(FaultInjector("fetch@1:2", seed=0, stall_s=0.01))
    inline = fetcher.submit(torch.tensor([7]))
    assert inline.result().tolist() == [7]  # no thread: read inline
    fetcher.start()
    try:
        order: list[int] = []
        handles = [fetcher.submit(torch.full((2, 3), i)) for i in range(12)]
        for h in handles:
            assert h.result()[0, 0] >= 0
        landed = [h.done for h in handles]
        assert all(landed)
        for i, h in enumerate(handles):
            order.append(int(h.result()[0, 0]))
        assert order == list(range(12))
    finally:
        fetcher.stop()


# -- the injector itself -------------------------------------------------------------


def test_fault_injector_schedules_are_deterministic():
    for spec, expect in [
        ("decode@3", [False, False, True, False, False, False]),
        ("decode@2+", [False, True, True, True, True, True]),
        ("decode@2:2", [False, True, False, True, False, True]),
    ]:
        inj = FaultInjector(spec, seed=0)
        assert [inj.fires("decode") for _ in range(6)] == expect, spec
        assert all(not inj.fires("prefill") for _ in range(4))  # untargeted
    a = FaultInjector("decode~0.5", seed=7)
    b = FaultInjector("decode~0.5", seed=7)
    seq_a = [a.fires("decode") for _ in range(32)]
    seq_b = [b.fires("decode") for _ in range(32)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)


def test_fault_injector_matches_the_jax_injector():
    """The port's copy fires on the same calls, and draws the same nan
    victims, as the JAX package's injector for the same spec and seed."""
    from langstream_tpu.serving import faultinject as jax_fi
    from langstream_tpu_torch.serving import faultinject as port_fi

    # the port adds one site of its own (the multi-rank host tier's drill)
    assert port_fi.SITES == jax_fi.SITES + ("spmd-restore",)
    spec = "decode@2:3,nan~0.4,fetch@1+"
    a, b = port_fi.FaultInjector(spec, seed=11), jax_fi.FaultInjector(spec, seed=11)
    for site in ("decode", "nan", "fetch", "prefill") * 8:
        assert a.fires(site) == b.fires(site)
    snapshot = [(i, None) for i in range(5)]
    host = np.zeros((4, 5), np.int64)
    for _ in range(6):
        (ha, va), (hb, vb) = a.corrupt_tokens(host, snapshot), b.corrupt_tokens(host, snapshot)
        assert va == vb
        np.testing.assert_array_equal(ha, hb)
    assert a.stats() == b.stats()


def test_fault_injector_env_activation():
    assert FaultInjector.from_env({}) is None
    inj = FaultInjector.from_env({
        "LSTPU_FAULTS": "nan@2", "LSTPU_FAULT_SEED": "3", "LSTPU_FAULT_STALL_S": "0.5",
    })
    assert inj is not None and inj.seed == 3 and inj.stall_s == 0.5
    with pytest.raises(ValueError):
        FaultInjector("warp@1")  # an unknown site fails fast


@bounded(90)
def test_engine_reads_the_injector_from_the_environment(monkeypatch):
    monkeypatch.setenv("LSTPU_FAULTS", "client@1")
    engine = make_engine()
    try:
        res = engine.generate([3, 4], GenerationOptions(max_new_tokens=3), timeout=WAIT)
        assert len(res.tokens) == 3
        assert engine.stats()["fault-injection"] == {"client": 1}
    finally:
        engine.stop()


# -- no waker sees a half-torn slot ----------------------------------------------------


@bounded(120)
def test_finish_waker_never_observes_half_torn_slot():
    """``_finish`` wakes the waiter at once (on_done runs inside it), so
    every teardown must land before it: an injected decode crash routes the
    request through ``_recover``, and on_done checks that no slot or stream
    still holds the request and the result's tokens are a detached list."""
    observed = []
    holder: dict = {}

    def on_done(result):
        engine, req = holder["engine"], holder["request"]
        observed.append({
            "slot_refs": sum(1 for s in engine._slots if s.request is req),
            "long_refs": sum(1 for st in engine._longs.values() if st["request"] is req),
            "aliased": any(result.tokens is s.generated for s in engine._slots),
        })

    engine = make_engine(
        fault_injector=FaultInjector("decode@2", seed=0), restart_backoff_s=0.01, max_restarts=2
    )
    holder["engine"] = engine
    try:
        request = GenerationRequest(
            prompt_tokens=[5, 6, 7], options=GenerationOptions(max_new_tokens=32),
            on_done=on_done,
        )
        holder["request"] = request
        engine.submit(request)
        with pytest.raises(InjectedFault):
            request.result(timeout=WAIT)
        assert observed == [{"slot_refs": 0, "long_refs": 0, "aliased": False}]
        ok = engine.generate([5, 6, 7], GenerationOptions(max_new_tokens=4), timeout=WAIT)
        assert ok.tokens == jax_solo("paged-f32", (5, 6, 7), 4)
    finally:
        engine.stop()


@bounded(90)
def test_fail_all_waker_never_observes_half_torn_slot():
    observed = []
    holder: dict = {}

    def on_done(result):
        engine, req = holder["engine"], holder["request"]
        observed.append(sum(1 for s in engine._slots if s.request is req))

    engine = make_engine(fault_injector=FaultInjector("decode@2", seed=0), max_restarts=0)
    holder["engine"] = engine
    try:
        request = GenerationRequest(
            prompt_tokens=[5, 6, 7], options=GenerationOptions(max_new_tokens=32),
            on_done=on_done,
        )
        holder["request"] = request
        engine.submit(request)
        with pytest.raises(InjectedFault):
            request.result(timeout=WAIT)
        assert observed == [0]
    finally:
        engine.stop()


# -- options and provider keys -------------------------------------------------------


def test_lifecycle_options_parse_as_in_the_jax_package():
    for d in (
        {"deadline": 2.5, "max-queue-wait": 0.5},
        {"deadline-s": "2.5", "max-queue-wait-s": "0.5"},
        {"deadline_s": 2.5, "max_queue_wait_s": 0.5},
        {},
    ):
        port, ref = GenerationOptions.from_dict(d), JaxOptions.from_dict(d)
        assert (port.deadline_s, port.max_queue_wait_s) == (ref.deadline_s, ref.max_queue_wait_s)


def test_provider_forwards_the_lifecycle_keys():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "device": "cpu", "queue-depth": 3, "shed-policy": "reject",
        "engine-restart-backoff": 0.5, "engine-max-restarts": 2,
        "fault-injection": "client@1", "fault-seed": 4, "max-batch": 2,
    })
    try:
        engine = svc.engine()
        assert engine._queue.maxsize == 3 and engine.shed_policy == "reject"
        assert engine.restart_backoff_s == 0.5 and engine.max_restarts == 2
        assert engine._injector.spec == "client@1" and engine._injector.seed == 4
    finally:
        svc.close()
    with pytest.raises(ValueError, match="shed-policy"):
        TorchCompletionsService({"device": "cpu", "shed-policy": "drop"})
