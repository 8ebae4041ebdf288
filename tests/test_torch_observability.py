"""Engine observability in the port against the JAX package, on the CPU
(tiny-test, paged, f32, weights carried over by ``bridge``).

- ``api/metrics``: ``log_buckets`` and ``Histogram`` buckets, sums, counts
  and percentiles equal to JAX's for the same samples; ``load_score`` on a
  grid; the histogram taxonomy, the flight schema, its iteration fields
  and its dump reasons equal to JAX's.
- Flight dumps in both directions: the port's recorder dumps pass JAX's
  ``validate_flight_dump`` and JAX's pass the port's; both refuse a dump
  that carries token content.
- The engine: one TTFT sample a request, one ``engine.request`` span with
  its ``engine.queued`` / ``engine.prefill`` / ``engine.decode`` children
  a request in the port's ``TRACER`` (under the request's trace id), the
  histograms recorded where JAX records them; dumps on a NaN quarantine
  (written to ``flight_dir`` too), a page quarantine, an engine restart, a
  shed burst, a brownout transition and ``stats(dump=True)``, each valid
  under both validators and free of token content; ``observability``
  off records nothing and serves the same tokens as JAX.
"""

import dataclasses
import functools
import json
import time

import jax
import numpy as np
import pytest

from langstream_tpu.api import metrics as jm
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving import observability as jo
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.api import metrics as tm
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import observability as to
from langstream_tpu_torch.serving.engine import (
    GenerationRequest,
    LogitsNaNError,
    ServingEngine,
    ShedError,
)
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
from langstream_tpu_torch.tracing import TRACER, record_trace_id

WAIT = 120.0
ENGINE_KW = dict(max_batch=2, max_seq_len=128, decode_chunk=4)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 8], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20])


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
    tcfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def port_engine(**kw):
    _, tcfg, _, tp = weights()
    return ServingEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})


def both_valid(doc) -> None:
    assert to.validate_flight_dump(doc) and jo.validate_flight_dump(doc)
    text = json.dumps(doc)
    for key in ("tokens", "prompt", "generated", "drafts", "text"):
        assert f'"{key}"' not in text


# -- histograms, the load score, the schema ------------------------------------


@pytest.mark.parametrize("lo, hi, per", [(1e-3, 120.0, 4), (1e-5, 10.0, 4), (0.5, 7.0, 3),
                                         (1.0, 1.5, 1)])
def test_log_buckets_match_jax(lo, hi, per):
    assert tm.log_buckets(lo, hi, per) == jm.log_buckets(lo, hi, per)


@pytest.mark.parametrize("lo, hi", [(0.0, 1.0), (2.0, 1.0), (-1.0, 3.0)])
def test_log_buckets_refuse_like_jax(lo, hi):
    with pytest.raises(ValueError) as ours:
        tm.log_buckets(lo, hi)
    with pytest.raises(ValueError) as ref:
        jm.log_buckets(lo, hi)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("name", sorted(jo.ENGINE_HISTOGRAMS))
def test_histograms_match_jax(name):
    """Every engine histogram: the same samples (inside, below and past the
    bounds) give the same snapshot (cumulative buckets, sum, count, p50 /
    p90 / p99) and percentiles; a reset empties it."""
    spec = to.ENGINE_HISTOGRAMS[name]
    assert spec["buckets"] == jo.ENGINE_HISTOGRAMS[name]["buckets"]
    assert spec["help"] == jo.ENGINE_HISTOGRAMS[name]["help"]
    ours = to.build_histograms()[name]
    ref = jo.build_histograms()[name]
    assert ours.snapshot() == ref.snapshot()  # empty
    rng = np.random.default_rng(len(name))
    bounds = spec["buckets"]
    values = np.concatenate([
        np.exp(rng.uniform(np.log(bounds[0]) - 1, np.log(bounds[-1]) + 1, 300)), [0.0, bounds[3]],
    ])
    for v in values:
        ours.record(float(v))
        ref.record(float(v))
    assert ours.snapshot() == ref.snapshot()
    for p in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert ours.percentile(p) == ref.percentile(p)
    ours.reset()
    assert ours.count == 0 and ours.sum == 0.0


def test_load_score_and_schema_match_jax():
    for wait in (0.0, 0.3, 2.5, -1.0):
        for occ in (-0.5, 0.0, 0.5, 1.0, 1.7):
            for pressure in (0.0, 0.25, 1.0, 3.0):
                assert to.load_score(wait, occ, pressure) == jo.load_score(wait, occ, pressure)
    assert set(to.ENGINE_HISTOGRAMS) == set(jo.ENGINE_HISTOGRAMS)
    assert to.FLIGHT_SCHEMA == jo.FLIGHT_SCHEMA == "lstpu-flight-v1"
    assert to.ITERATION_FIELDS == jo.ITERATION_FIELDS
    assert to.DUMP_REASONS == jo.DUMP_REASONS
    assert to._FORBIDDEN_KEYS == jo._FORBIDDEN_KEYS


# -- flight dumps in both directions -------------------------------------------


def _frame(i):
    return {"i": i, "t": 1.0 + i, "active": 1, "queued": 0, "dispatch": "decode", "steps": 4,
            "kv_pages": 3, "host_pages": 0, "programs": 3,
            "phase_ms": {"sweep": 0.1, "prefill": 0.0, "dispatch": 0.2, "process": 0.3,
                         "spill": 0.0, "restore": 0.0}}


@pytest.mark.parametrize("maker, checker", [(to, jo), (jo, to)], ids=["port-dump", "jax-dump"])
def test_flight_dumps_validate_both_ways(maker, checker, tmp_path):
    rec = maker.FlightRecorder(capacity=8, dump_dir=str(tmp_path), min_dump_interval_s=60.0)
    for i in range(12):
        rec.record(_frame(i))
    doc = rec.dump("nan-quarantine", counters={"shed": 1}, extra={"slot": 0})
    assert checker.validate_flight_dump(doc)
    assert [f["i"] for f in doc["iterations"]] == list(range(4, 12))  # the ring keeps 8
    assert rec.dump("nan-quarantine") is None  # debounced per reason
    assert rec.dump("brownout") is not None and rec.dumps_total == 2
    written = sorted(tmp_path.glob("flight-*.json"))
    assert [p.name for p in written] == ["flight-0001-nan-quarantine.json",
                                         "flight-0002-brownout.json"]
    assert checker.validate_flight_dump(json.loads(written[0].read_text()))
    for bad, match in (
        ({**doc, "extra": {"tokens": [1, 2]}}, "token-content"),
        ({**doc, "reason": "whim"}, "reason"),
        ({**doc, "schema": "v0"}, "schema"),
        ({**doc, "iterations": [{"i": 1}]}, "missing field"),
    ):
        with pytest.raises(ValueError, match=match):
            checker.validate_flight_dump(bad)
        with pytest.raises(ValueError, match=match):
            maker.validate_flight_dump(bad)
    for _ in range(4):
        assert not rec.note_shed()
    assert rec.note_shed()  # the fifth within a second is a burst


def test_record_trace_id_reads_the_header():
    class H:
        def __init__(self, key, value):
            self.key, self._value = key, value

        def value_as_string(self):
            return self._value

    class R:
        headers = (H("other", "x"), H("ls-trace-id", "abc123"))

    assert record_trace_id(R()) == "abc123"
    assert record_trace_id(object()) is None


# -- the engine ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_tokens(max_new: int = 12) -> list:
    jcfg, _, jp, _ = weights()
    engine = JaxEngine(jcfg, jp, kv_layout="paged", **ENGINE_KW)
    reqs = [engine.submit(JaxRequest(prompt_tokens=list(p),
                                     options=JaxOptions(max_new_tokens=max_new)))
            for p in PROMPTS]
    engine.start()
    try:
        return [r.result(timeout=WAIT).tokens for r in reqs]
    finally:
        engine.stop()


def _serve_before_start(engine, max_new=12, trace=True):
    reqs = [engine.submit(GenerationRequest(
        prompt_tokens=list(p), options=GenerationOptions(max_new_tokens=max_new),
        trace_id=f"trace-{i}" if trace else None)) for i, p in enumerate(PROMPTS)]
    engine.start()
    try:
        results = [r.result(timeout=WAIT) for r in reqs]
        stats = engine.stats(dump=True)
    finally:
        engine.stop()
    return results, stats


@pytest.mark.parametrize("on", [True, False])
def test_histograms_spans_and_dump_on_demand(on):
    TRACER.clear()
    engine = port_engine(observability=on)
    results, stats = _serve_before_start(engine)
    assert [r.tokens for r in results] == jax_tokens()
    assert stats["observability"] is on
    if not on:
        assert stats["histograms"] == {} and stats["flight-recorder"] is None
        assert not TRACER.find("engine.request") and stats["flight-dumps-total"] == 0
        return
    hist = stats["histograms"]
    assert set(hist) == set(to.ENGINE_HISTOGRAMS)
    assert hist["engine_ttft_s"]["count"] == len(PROMPTS)
    assert hist["engine_queue_wait_s"]["count"] == len(PROMPTS)
    assert hist["engine_prefill_dispatch_s"]["count"] == stats["admit-groups-total"] >= 1
    assert hist["engine_decode_step_s"]["count"] > 0
    assert hist["engine_intertoken_s"]["count"] > 0
    assert hist["engine_fetch_s"]["count"] > 0
    for empty in ("engine_spill_s", "engine_restore_s", "engine_durable_restore_s",
                  "engine_accepted_tokens_per_step", "engine_weight_load_s"):
        assert hist[empty]["count"] == 0
    assert stats["load-score"] == to.load_score(hist["engine_queue_wait_s"]["p90"], 0.0, 0.0)
    tenants = stats["tenants"]["default"]
    assert tenants["admitted-total"] == len(PROMPTS)
    assert tenants["generated-tokens-total"] == sum(len(r.tokens) for r in results)
    for i, (p, r) in enumerate(zip(PROMPTS, results)):
        roots = TRACER.find("engine.request", f"trace-{i}")
        assert len(roots) == 1
        root = roots[0]
        assert root.attributes["prompt_len"] == len(p)
        assert root.attributes["generated_tokens"] == len(r.tokens)
        assert root.attributes["path"] == "cold" and root.status == "ok"
        kids = [s for s in TRACER.find("engine.queued", f"trace-{i}")
                + TRACER.find("engine.prefill", f"trace-{i}")
                + TRACER.find("engine.decode", f"trace-{i}")]
        assert sorted(s.name for s in kids) == ["engine.decode", "engine.prefill",
                                                "engine.queued"]
        assert all(s.parent_id == root.span_id for s in kids)
    dump = stats["flight-recorder"]
    both_valid(dump)
    assert dump["reason"] == "on-demand" and dump["iterations"]
    assert all(f["programs"] == 0 for f in dump["iterations"])  # the CPU captures nothing
    assert dump["counters"]["total-requests"] == len(PROMPTS)


def test_nan_quarantine_leaves_a_valid_dump_in_flight_dir(tmp_path):
    """``nan@2``: one slot quarantined, one ``nan-quarantine`` dump (in the
    stats, in ``flight_dir``) that validates both ways and carries the
    injector's firing and no token content."""
    engine = port_engine(fault_injector=FaultInjector("nan@2"), flight_dir=str(tmp_path))
    reqs = [engine.submit(GenerationRequest(prompt_tokens=list(p),
                                            options=GenerationOptions(max_new_tokens=12)))
            for p in PROMPTS[:2]]
    engine.start()
    try:
        outcomes = []
        for r in reqs:
            try:
                outcomes.append(len(r.result(timeout=WAIT).tokens))
            except LogitsNaNError:
                outcomes.append("nan")
        stats = engine.stats()
    finally:
        engine.stop()
    assert sorted(outcomes, key=str) == [12, "nan"]
    files = list(tmp_path.glob("flight-*-nan-quarantine.json"))
    assert len(files) == 1 and stats["flight-dumps-total"] == 1
    doc = json.loads(files[0].read_text())
    both_valid(doc)
    assert doc["extra"]["injector-events"][0]["site"] == "nan"
    assert doc["counters"]["nan-guard"] == 1
    # the frames before the incident: the one it happened in is not closed yet
    assert doc["iterations"] and doc["iterations"][-1]["injector"] == {"nan": 0}


def test_page_quarantine_and_restart_dump():
    page = port_engine(fault_injector=FaultInjector("page@2"))
    page.start()
    try:
        with pytest.raises(RuntimeError, match="page-table corruption"):
            page.generate(PROMPTS[0], GenerationOptions(max_new_tokens=12), timeout=WAIT)
    finally:
        page.stop()
    doc = page._obs.flight.last_dump
    both_valid(doc)
    assert doc["reason"] == "page-quarantine"
    crash = port_engine(max_batch=1, fault_injector=FaultInjector("decode@2"),
                        restart_backoff_s=0.01)
    crash.start()
    try:
        with pytest.raises(InjectedFault):
            crash.generate(PROMPTS[0], GenerationOptions(max_new_tokens=12), timeout=WAIT)
        res = crash.generate(PROMPTS[1], GenerationOptions(max_new_tokens=12), timeout=WAIT)
    finally:
        crash.stop()
    assert res.tokens == jax_tokens()[1]
    doc = crash._obs.flight.last_dump
    both_valid(doc)
    assert doc["reason"] == "engine-restart" and doc["extra"]["error"] == "InjectedFault"


def test_shed_burst_dump():
    """Five sheds within a second (a full queue, shed policy "reject") leave
    one ``shed-burst`` dump, each shed counted against its tenant."""
    engine = port_engine(queue_depth=1, shed_policy="reject")
    engine.submit(GenerationRequest(prompt_tokens=[1, 2], options=GenerationOptions()))
    for _ in range(5):
        with pytest.raises(ShedError, match="queue full"):
            engine.submit(GenerationRequest(prompt_tokens=[1, 2],
                                            options=GenerationOptions(tenant="t")))
    stats = engine.stats()
    assert stats["shed-total"] == 5 and stats["tenants"]["t"]["shed-total"] == 5
    assert stats["flight-dumps-total"] == 1
    doc = engine._obs.flight.last_dump
    both_valid(doc)
    assert doc["reason"] == "shed-burst" and doc["counters"]["shed"] == 5
    engine.stop()


def test_brownout_transition_dump_and_reversal():
    """A low enter load and no dwell: the first iterations with a slot busy
    walk the ladder up, each step a ``brownout`` dump (debounced), and the
    ladder walks back down once the engine idles — tokens unchanged."""
    engine = port_engine(brownout_enter_load=0.1, brownout_exit_load=0.05,
                         brownout_dwell_s=0.0)
    engine._obs.flight.min_dump_interval_s = 0.0
    engine.start()
    try:
        res = engine.generate(PROMPTS[0], GenerationOptions(max_new_tokens=24), timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while engine.stats()["brownout-level"] > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["brownout-transitions-total"] >= 2
    assert stats["brownout"]["engagements"]["spec-shrink"] >= 1
    doc = engine._obs.flight.last_dump
    both_valid(doc)
    assert doc["reason"] == "brownout" and doc["extra"]["brownout-to"] == 0
    assert engine.brownout_dumps_total == stats["flight-dumps-total"] >= 2
    jax_engine = JaxEngine(weights()[0], weights()[2], kv_layout="paged", **ENGINE_KW)
    jax_engine.start()
    try:
        want = jax_engine.generate(PROMPTS[0], JaxOptions(max_new_tokens=24), timeout=WAIT)
    finally:
        jax_engine.stop()
    assert res.tokens == want.tokens


def test_queued_death_spans_and_tenant_counters():
    """A request cancelled in the queue gets a root and its queued child
    only; its tenant's cancelled counter moves."""
    TRACER.clear()
    engine = port_engine()
    req = engine.submit(GenerationRequest(prompt_tokens=[1, 2], trace_id="dead",
                                          options=GenerationOptions(tenant="t")))
    req.cancel()
    engine.start()
    try:
        assert req.result(timeout=WAIT).finish_reason == "cancelled"
        stats = engine.stats()
    finally:
        engine.stop()
    assert stats["tenants"]["t"]["cancelled-total"] == 1
    names = sorted(s.name for s in TRACER.find("engine.request", "dead")
                   + TRACER.find("engine.queued", "dead") + TRACER.find("engine.prefill", "dead"))
    assert names == ["engine.queued", "engine.request"]
