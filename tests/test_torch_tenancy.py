"""Multi-tenant overload control in the port against the JAX package, on the
CPU (tiny-test, paged, f32, weights carried over by ``bridge``).

- The host classes of ``serving/tenancy.py`` against JAX's, operation by
  operation with the same injected clock: ``TenantSpec.from_dict`` and its
  errors, token-bucket balances, ``TenantRegistry`` snapshots and its cap
  on client-invented names, ``TenantQueue`` pop sequences (weight ratio,
  lone tenant, priority ties, queue-share shed, ``skip``),
  ``BrownoutController.observe`` sequences with ``draft_k``, and
  ``effective_max_new_tokens``; ``GenerationOptions.from_dict``'s tenancy
  fields and refusals.
- The port engine against the JAX paged engine, every request submitted
  before ``start()``: equal tokens and per-tenant counters, the
  ``max_slots`` cap in every flight frame, ``ShedError`` at forced levels
  3 and 4, ``max_cost_tokens`` capping and refusing as JAX does, and the
  ``tenant-burst`` site's sheds against "chaos-burst".
- Brownout with speculation: level 2 serves decode chunks and level 1
  halves the drafts, both token-exact against JAX's plain greedy tokens;
  through a stand-in graph both graph sets are captured, replays are
  counted by kind, and a restart captures both again.
- The provider: the new keys reach the engine, refused keys and options
  raise NotImplementedError, ``close()`` lets a request in flight finish,
  the HF chat template renders as the JAX provider renders it, and the
  memory plan's graph-pool terms.
"""

import asyncio
import dataclasses
import functools
import queue as stdlib_queue
import threading
import time

import jax
import numpy as np
import pytest

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving import tenancy as jt
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.engine import ShedError as JaxShedError
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.ops.attention import kernel_counts, reset_kernel_counts
from langstream_tpu_torch.serving import tenancy as tt
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine, ShedError
from langstream_tpu_torch.serving.faultinject import FaultInjector, InjectedFault
from test_torch_graphs import ReplayGraph

WAIT = 120.0
K = 4
ENGINE_KW = dict(max_batch=4, max_seq_len=128, decode_chunk=4)
# per-tenant counters that do not depend on timing
COUNTERS = ("submitted-total", "admitted-total", "shed-total", "deadline-total",
            "cancelled-total", "prefill-tokens-total", "generated-tokens-total")
REPETITIVE = ([5, 9, 11, 7] * 10)[:40]
PLAIN = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
    tcfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def jax_engine(**kw):
    jcfg, _, jp, _ = weights()
    return JaxEngine(jcfg, jp, kv_layout="paged", **{**ENGINE_KW, **kw})


def port_engine(**kw):
    _, tcfg, _, tp = weights()
    return ServingEngine(tcfg, tp, device="cpu", **{**ENGINE_KW, **kw})


def serve(engine, items, jax_side: bool):
    """Submit every (prompt, options dict) before ``start()``, wait for all
    → (results, stats)."""
    req_cls, opt_cls = (JaxRequest, JaxOptions) if jax_side else (GenerationRequest,
                                                                   GenerationOptions)
    reqs = [engine.submit(req_cls(prompt_tokens=list(p), options=opt_cls(**o)))
            for p, o in items]
    engine.start()
    try:
        results = [r.result(timeout=WAIT) for r in reqs]
        stats = engine.stats()
    finally:
        engine.stop()
    return results, stats


def counters(stats):
    return {name: {k: t[k] for k in COUNTERS} for name, t in stats["tenants"].items()}


# -- TenantSpec, the token bucket, the registry ---------------------------------

SPECS = [
    {"name": "acme", "weight": 4, "max-slots": 6, "queue-share": 0.5, "token-rate": 100},
    {"name": "b", "max_slots": 2, "queue_share": 1.0, "token_rate": 5.5, "burst_s": 0.5},
    {"name": ""},
    {"name": "x", "weight": 0},
    {"name": "x", "weight": -2},
    {"name": "x", "max-slots": 0},
    {"name": "x", "queue-share": 1.5},
    {"name": "x", "queue-share": 0},
    {"name": "x", "token-rate": -1},
]


@pytest.mark.parametrize("d", SPECS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_tenant_spec_from_dict_matches_jax(d):
    try:
        want = jt.TenantSpec.from_dict(d)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tt.TenantSpec.from_dict(d)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tt.TenantSpec.from_dict(d)) == dataclasses.asdict(want)


def test_token_bucket_balances_match_jax():
    """The same charges at the same injected times give the same balances,
    quota verdicts and retry-after, the bucket starting full at t=100."""
    rng = np.random.default_rng(0)
    ours, ref = tt._TokenBucket(40.0, 2.0), jt._TokenBucket(40.0, 2.0)
    ours._at = ref._at = 100.0
    t = 100.0
    for _ in range(60):
        t += float(rng.uniform(0, 0.5))
        n = float(rng.integers(0, 60))
        ours.charge(n, t)
        ref.charge(n, t)
        t += float(rng.uniform(0, 0.2))
        assert ours.balance(t) == ref.balance(t)
        assert ours.over_quota(t) == ref.over_quota(t)
        assert ours.retry_after_s(t) == ref.retry_after_s(t)


def _registry_ops(reg):
    reg.note_submit("a")
    reg.note_submit("a")
    reg.note_admitted("a", 40)
    reg.note_generated("a", 3)
    reg.note_shed("b")
    reg.note_deadline("b")
    reg.note_cancelled("a")
    for w in (0.5, 0.1, 0.9):
        reg.note_queue_wait("a", w)
    for v in (0.002, 0.03, 0.4, 1.5):
        reg.note_ttft("a", v)
    reg.charge("metered", 1e6)
    for i in range(5):  # "b" and two clients reach the cap of 3: the rest fold
        reg.note_submit(f"client-{i}")


def test_registry_snapshot_and_name_cap_match_jax():
    specs = [{"name": "metered", "token-rate": 10.0}, {"name": "a", "weight": 2}]
    ours = tt.TenantRegistry([tt.TenantSpec.from_dict(d) for d in specs], max_dynamic=3)
    ref = jt.TenantRegistry([jt.TenantSpec.from_dict(d) for d in specs], max_dynamic=3)
    _registry_ops(ours)
    _registry_ops(ref)
    q, a = {"a": 2, "metered": 1}, {"a": 1}
    assert ours.snapshot(q, a) == ref.snapshot(q, a)
    assert ours.folded_tenants_total == ref.folded_tenants_total == 3
    with pytest.raises(ValueError, match="duplicate"):
        tt.TenantRegistry([tt.TenantSpec("a"), tt.TenantSpec("a")])


# -- TenantQueue ----------------------------------------------------------------


class _Opt:
    def __init__(self, tenant=None, priority="normal"):
        self.tenant = tenant
        self.priority = priority


class _Req:
    def __init__(self, ident, tenant=None, priority="normal", n=8):
        self.ident = ident
        self.prompt_tokens = [1] * n
        self.options = _Opt(tenant, priority)


def _drive(mod, specs, maxsize, cost, quantum, script):
    """Run a script of queue operations → what each returned or raised."""
    reg = mod.TenantRegistry([mod.TenantSpec.from_dict(d) for d in specs])
    tq = mod.TenantQueue(maxsize, reg, cost_fn=cost, quantum=quantum)
    out = []
    for i, op in enumerate(script):
        try:
            if op[0] == "put":
                tq.put_nowait(_Req(i, *op[1:]))
                out.append(("put", tq.qsize(), tq.depth_by_tenant()))
            elif op[0] == "bput":
                tq.put(_Req(i, *op[1:]), timeout=0.01)
                out.append(("bput", tq.qsize()))
            else:
                r = tq.get_nowait(skip=set(op[1]) if len(op) > 1 else None)
                out.append(("pop", r.ident, r.options.tenant, r.options.priority,
                            tq.tenants_with_work()))
        except (stdlib_queue.Full, stdlib_queue.Empty) as e:
            out.append(type(e).__name__)
        except (jt.TenantShareExceeded, tt.TenantShareExceeded) as e:
            out.append(("share", e.tenant, e.cap, str(e)))
    return out


def _by_len(r):
    return float(len(r.prompt_tokens) * 8)


QUEUE_CASES = {
    "weight-ratio": ([{"name": "a", "weight": 2}, {"name": "b"}], 100, lambda r: 32.0, 32.0,
                     [("put", "a"), ("put", "b")] * 30 + [("pop",)] * 62),
    "lone-tenant": ([{"name": "a", "weight": 0.1}], 10, lambda r: 2048.0, 32.0,
                    [("put", "a")] * 5 + [("pop",)] * 6),
    "priority-ties": ([{"name": "a"}, {"name": "b"}], 10, lambda r: 1.0, 1.0,
                      [("put", "a", "low"), ("put", "a", "high"), ("put", "b", "low"),
                       ("put", "b", "high"), ("put", "a", "normal"), ("put", "b", "bogus")]
                      + [("pop",)] * 7),
    "queue-share": ([{"name": "burst", "queue-share": 0.25}], 8, None, 2048.0,
                    [("put", "burst")] * 3 + [("bput", "burst")] + [("put", "victim")] * 7
                    + [("bput", "victim")] + [("pop",)] * 3 + [("put", "burst")]),
    "skip": ([], 10, None, 2048.0,
             [("put", "a"), ("put", "b"), ("put", "a"), ("pop", ["a"]), ("pop", ["a"]),
              ("pop",), ("pop", ["b"]), ("pop",)]),
    "costs": ([{"name": "a", "weight": 3}, {"name": "b", "weight": 0.5}, {"name": "c"}], 64,
              _by_len, 2048.0,
              [("put", t, "normal", n) for t, n in
               (("a", 30), ("b", 200), ("c", 64), ("a", 2000), ("b", 5), ("c", 700))] * 3
              + [("pop",)] * 19),
}


@pytest.mark.parametrize("case", list(QUEUE_CASES))
def test_tenant_queue_pops_match_jax(case):
    specs, maxsize, cost, quantum, script = QUEUE_CASES[case]
    cost = cost or (lambda r: 1.0)
    got = _drive(tt, specs, maxsize, cost, quantum, script)
    assert got == _drive(jt, specs, maxsize, cost, quantum, script)
    if case == "weight-ratio":
        pops = [o[2] for o in got if o[0] == "pop"][:30]
        assert pops.count("a") == 20 and pops.count("b") == 10


# -- the brownout controller ----------------------------------------------------


def test_brownout_observe_sequences_match_jax():
    rng = np.random.default_rng(1)
    ours = tt.BrownoutController(enter_load=2.0, exit_load=1.0, dwell_s=0.3)
    ref = jt.BrownoutController(enter_load=2.0, exit_load=1.0, dwell_s=0.3)
    t = 50.0
    levels = set()
    for _ in range(400):
        t += float(rng.uniform(0.0, 0.2))
        load = float(rng.choice([0.2, 0.9, 1.5, 2.0, 2.7, 3.5]))
        assert ours.observe(load, t) == ref.observe(load, t)
        assert ours.snapshot() == ref.snapshot()
        levels.add(ours.level)
        for k in (1, 4, 8):
            assert ours.draft_k(k) == ref.draft_k(k)
        assert (ours.spec_off, ours.reject_low, ours.reject_quota) == (
            ref.spec_off, ref.reject_low, ref.reject_quota)
    assert levels == {0, 1, 2, 3, 4}
    with pytest.raises(ValueError, match="hysteresis"):
        tt.BrownoutController(enter_load=1.0, exit_load=2.0)


@pytest.mark.parametrize("budget", [None, 1, 9, 20, 200])
@pytest.mark.parametrize("prompt_len", [0, 8, 25])
def test_effective_max_new_tokens_matches_jax(budget, prompt_len):
    o = GenerationOptions(max_new_tokens=100, max_cost_tokens=budget)
    j = JaxOptions(max_new_tokens=100, max_cost_tokens=budget)
    assert tt.effective_max_new_tokens(o, prompt_len) == jt.effective_max_new_tokens(
        j, prompt_len)


def test_generation_options_tenancy_fields_match_jax():
    for d in ({"tenant": "acme", "priority": "HIGH", "max-cost-tokens": 64},
              {"max_cost_tokens": "7", "priority": None}, {}):
        ours, ref = GenerationOptions.from_dict(d), JaxOptions.from_dict(d)
        assert (ours.tenant, ours.priority, ours.max_cost_tokens) == (
            ref.tenant, ref.priority, ref.max_cost_tokens)
    with pytest.raises(ValueError) as e:
        GenerationOptions.from_dict({"priority": "urgent"})
    with pytest.raises(ValueError) as je:
        JaxOptions.from_dict({"priority": "urgent"})
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("option", [
    {"response-format": {"type": "json_object"}}, {"response_format": {"type": "json"}},
    {"grammar-resume-state": 3, "response-format": {"type": "regex", "regex": "ab"}},
    {"adapter": "support-bot"},
])
def test_refused_request_options_raise(option):
    """The agentic options parse as the JAX package parses them, and an
    engine that cannot serve one refuses it as the JAX engine does: an
    unsupported response format at submit (GrammarError), a resume state
    outside its grammar's 3 states at admission, an adapter on an engine
    without adapters at submit."""
    ours, ref = GenerationOptions.from_dict(option), JaxOptions.from_dict(option)
    assert (ours.response_format, ours.grammar_resume_state, ours.adapter) == (
        ref.response_format, ref.grammar_resume_state, ref.adapter)
    match = ("out of range" if ours.grammar_resume_state is not None
             else "no adapter registry" if ours.adapter
             else "unsupported response_format type")
    engine = port_engine(max_batch=1)
    engine.start()
    try:
        with pytest.raises(ValueError, match=match):
            engine.generate([5, 6], dataclasses.replace(ours, max_new_tokens=2), timeout=WAIT)
    finally:
        engine.stop()


# -- the engine against JAX's ---------------------------------------------------

TENANTS = [{"name": "victim", "weight": 1},
           {"name": "aggressor", "weight": 1, "max-slots": 2, "queue-share": 0.75}]


def _tenant_items():
    rng = np.random.default_rng(3)
    items = [(rng.integers(1, 250, int(n)).tolist(),
              dict(max_new_tokens=int(m), tenant="aggressor", priority="low"))
             for n, m in zip(rng.integers(4, 40, 8), rng.integers(3, 12, 8))]
    items += [(rng.integers(1, 250, int(n)).tolist(), dict(max_new_tokens=10, tenant="victim"))
              for n in (12, 30)]
    items.append((PLAIN, dict(max_new_tokens=6)))  # the default tenant
    return items


def test_tenant_engine_matches_jax_and_holds_max_slots():
    """Aggressor (low priority, max-slots 2) and victim traffic queued
    before ``start()`` on both engines: the same tokens, the same
    per-tenant counters, and no flight frame of the port with the
    aggressor above its cap."""
    items = _tenant_items()
    want, jstats = serve(jax_engine(tenants=TENANTS, queue_depth=16), items, jax_side=True)
    engine = port_engine(tenants=TENANTS, queue_depth=16)
    got, stats = serve(engine, items, jax_side=False)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert counters(stats) == counters(jstats)
    assert stats["tenants"]["aggressor"]["admitted-total"] == 8
    frames = engine._obs.flight.iterations()
    assert frames and max(f["tenants"].get("aggressor", 0) for f in frames) == 2
    # the victim's requests were admitted ahead of the aggressor's backlog
    victim_at = [f["i"] for f in frames if f["tenants"].get("victim")]
    assert victim_at[0] == frames[0]["i"]


def test_queue_share_sheds_the_burster_like_jax():
    """A queue of 8 and a share of 0.75: the aggressor's 7th entry sheds
    (its tenant's shed), the victim still queues, on both engines."""
    counts = {}
    for side in ("jax", "port"):
        engine = (jax_engine if side == "jax" else port_engine)(tenants=TENANTS, queue_depth=8)
        req_cls, opt_cls, shed = ((JaxRequest, JaxOptions, JaxShedError) if side == "jax"
                                  else (GenerationRequest, GenerationOptions, ShedError))
        outcomes = []
        for i, tenant in enumerate(["aggressor"] * 7 + ["victim"]):
            try:
                engine.submit(req_cls(prompt_tokens=[3, 4 + i],
                                      options=opt_cls(max_new_tokens=2, tenant=tenant)))
                outcomes.append("queued")
            except shed as e:
                outcomes.append(("shed", str(e), e.retry_after_s))
        engine.start()
        engine.stop()
        counts[side] = (outcomes, counters(engine.stats()))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0][6][0] == "shed" and counts["port"][0][7] == "queued"


@pytest.mark.parametrize("level", [3, 4])
def test_forced_brownout_levels_shed_like_jax(level):
    """Level 3 sheds low priority at submit, level 4 an over-quota tenant;
    the others still serve — the same outcomes, messages and counters as
    the JAX engine's."""
    specs = [{"name": "metered", "token-rate": 1.0, "burst-s": 1.0}]
    seen = {}
    for side in ("jax", "port"):
        engine = (jax_engine if side == "jax" else port_engine)(
            tenants=specs, brownout_dwell_s=1e9)
        req_cls, opt_cls, shed = ((JaxRequest, JaxOptions, JaxShedError) if side == "jax"
                                  else (GenerationRequest, GenerationOptions, ShedError))
        engine._brownout.level = level
        engine._tenants.charge("metered", 1000.0)
        outcomes = []
        for tenant, priority in (("metered", "normal"), (None, "low"), ("ok", "normal")):
            try:
                r = engine.submit(req_cls(prompt_tokens=[1, 2, 3], options=opt_cls(
                    max_new_tokens=3, tenant=tenant, priority=priority)))
                outcomes.append(("queued", r))
            except shed as e:
                outcomes.append(("shed", str(e)))
        engine.start()
        try:
            done = [o if o[0] == "shed" else ("served", o[1].result(timeout=WAIT).tokens)
                    for o in outcomes]
            stats = engine.stats()
        finally:
            engine.stop()
        seen[side] = (done, counters(stats), stats["brownout-level"], stats["shed-total"])
    assert seen["port"] == seen["jax"]
    kinds = [o[0] for o in seen["port"][0]]
    assert kinds == (["served", "shed", "served"] if level == 3 else ["shed", "shed", "served"])


def test_max_cost_tokens_caps_and_refuses_like_jax():
    items = [([5, 6, 7, 8], dict(max_new_tokens=50, max_cost_tokens=10)),
             (PLAIN, dict(max_new_tokens=5, max_cost_tokens=100)),
             ([9] * 20, dict(max_new_tokens=50, max_cost_tokens=21))]
    want, jstats = serve(jax_engine(), items, jax_side=True)
    got, stats = serve(port_engine(), items, jax_side=False)
    assert [(r.tokens, r.finish_reason) for r in got] == [
        (r.tokens, r.finish_reason) for r in want]
    assert [len(r.tokens) for r in got] == [6, 5, 1]
    assert counters(stats) == counters(jstats)
    for budget, prompt in ((4, [5, 6, 7, 8]), (0, [1]), (-3, [1])):
        errors = []
        for engine, req_cls, opt_cls in ((jax_engine(), JaxRequest, JaxOptions),
                                         (port_engine(), GenerationRequest, GenerationOptions)):
            with pytest.raises(ValueError) as e:
                engine.submit(req_cls(prompt_tokens=prompt, options=opt_cls(
                    max_new_tokens=5, max_cost_tokens=budget)))
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_tenant_burst_site_sheds_against_chaos_burst_like_jax():
    """``tenant-burst@1`` at the first iteration: max-batch synthetic low
    admissions under "chaos-burst"; a queue of 2 takes 2, the rest shed
    against that tenant only, on both engines."""
    seen = {}
    for side in ("jax", "port"):
        maker = jax_engine if side == "jax" else port_engine
        engine = maker(queue_depth=2, fault_injector=FaultInjector("tenant-burst@1"))
        engine.start()
        try:
            deadline = time.monotonic() + WAIT
            while engine.stats()["tenants"].get("chaos-burst", {}).get(
                    "generated-tokens-total", 0) < 32:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            stats = engine.stats()
        finally:
            engine.stop()
        seen[side] = (counters(stats), stats["shed-total"], stats["fault-injection"])
    assert seen["port"] == seen["jax"]
    burst = seen["port"][0]["chaos-burst"]
    assert burst["submitted-total"] == 4 and burst["shed-total"] == 2
    assert burst["admitted-total"] == 2


# -- brownout with speculation, and both graph sets ----------------------------


@functools.lru_cache(maxsize=None)
def jax_plain(prompt: tuple, new: int) -> list[int]:
    engine = jax_engine(max_batch=2)
    engine.start()
    try:
        return engine.generate(list(prompt), JaxOptions(max_new_tokens=new),
                               timeout=WAIT).tokens
    finally:
        engine.stop()


def _spec_engine(**kw):
    kw = {"max_batch": 2, **kw}
    return port_engine(speculation="auto", speculation_tokens=K, brownout_dwell_s=1e9, **kw)


def test_brownout_levels_with_speculation_are_token_exact():
    """Level 2 serves decode chunks (no verify), level 1 verifies with at
    most k/2 drafts a slot, level 0 the full k — every pass equal to the
    JAX engine's plain greedy tokens; through a stand-in graph, each
    replay counted by kind and the paged decode kernel's calls exactly
    layers x (decode steps + verifies)."""
    want = [jax_plain(tuple(p), 24) for p in (REPETITIVE, PLAIN)]
    engine = _spec_engine()
    engine._graph_factory = ReplayGraph
    engine.start()
    passes = {}
    try:
        start = engine.stats()
        assert start["graph-sets"] == ["verify", "decode"]
        assert start["graph-captures-total"] == 6 and start["compiled_programs"] == 6
        assert set(start["graph-capture-parts-s"]) == {"warmup"} | {
            f"{kind}-{b}" for kind in ("verify", "decode")
            for b in ("greedy", "sampled", "filtered")}
        for level in (2, 1, 0):
            engine._brownout.level = level
            before = engine.stats()
            reset_kernel_counts()
            got = [engine.generate(p, GenerationOptions(max_new_tokens=24), timeout=WAIT).tokens
                   for p in (REPETITIVE, PLAIN)]
            after = engine.stats()
            calls = kernel_counts()["paged_decode"]["cpu_calls"]
            delta = {k: after[k] - before[k] for k in (
                "spec-verify-dispatches-total", "decode-chunks-total", "decode-steps-total",
                "spec-draft-tokens-total", "graph-replays-total")}
            kinds = {k: after["graph-replays-by-kind"][k] - before["graph-replays-by-kind"][k]
                     for k in ("decode", "verify")}
            passes[level] = (got, delta, kinds, calls)
    finally:
        engine.stop()
    layers = engine.config.n_layers
    for level, (got, delta, kinds, calls) in passes.items():
        assert got == want, level
        verifies = delta["spec-verify-dispatches-total"]
        assert kinds == {"decode": delta["decode-chunks-total"], "verify": verifies}
        assert calls == layers * (delta["decode-steps-total"] + verifies)
        if level == 2:
            assert verifies == 0 and delta["decode-chunks-total"] > 0
        else:
            assert verifies > 0 and delta["decode-chunks-total"] == 0
    # level 1 proposes at most k/2 drafts a slot and a verify, level 0 more
    assert passes[1][1]["spec-draft-tokens-total"] <= (K // 2) * passes[1][1][
        "spec-verify-dispatches-total"]
    assert passes[0][1]["spec-draft-tokens-total"] > passes[1][1]["spec-draft-tokens-total"]


def test_level_two_matches_jax_spec_off_without_graphs():
    """On the CPU's direct path too (no stand-in graph): level 2 with
    speculation gives JAX's plain greedy tokens and no verify."""
    engine = _spec_engine()
    engine._brownout.level = 2
    engine.start()
    try:
        got = engine.generate(REPETITIVE, GenerationOptions(max_new_tokens=24),
                              timeout=WAIT).tokens
        stats = engine.stats()
    finally:
        engine.stop()
    assert got == jax_plain(tuple(REPETITIVE), 24)
    assert stats["spec-verify-dispatches-total"] == 0 and stats["decode-chunks-total"] > 0


@pytest.mark.parametrize("spec, brownout, sets", [
    ("off", "auto", ["decode"]), ("auto", "off", ["verify"]), ("auto", "auto",
                                                               ["verify", "decode"]),
])
def test_graph_sets_by_configuration(spec, brownout, sets):
    engine = port_engine(max_batch=2, speculation=spec, brownout=brownout)
    engine._graph_factory = ReplayGraph
    engine._capture_graphs()
    stats = engine.stats()
    assert stats["graph-sets"] == sets
    assert stats["graph-captures-total"] == stats["compiled_programs"] == 3 * len(sets)
    assert engine.memory_plan.graph_sets == tuple(sets)


def test_restart_captures_both_sets_again():
    """``decode@3`` at level 2 of a speculative engine: the request in
    flight fails, the restart drops both sets and captures both again (12
    captures, 6 live graphs), and the queued request is served
    token-exact."""
    engine = _spec_engine(max_batch=1, fault_injector=FaultInjector("decode@3"),
                          restart_backoff_s=0.02)
    engine._graph_factory = ReplayGraph
    engine._brownout.level = 2
    opts = GenerationOptions(max_new_tokens=20)
    first = engine.submit(GenerationRequest(prompt_tokens=REPETITIVE, options=opts))
    second = engine.submit(GenerationRequest(prompt_tokens=PLAIN, options=opts))
    engine.start()
    # the graph objects themselves (held, so no id is reused)
    old = [g for g, _ in engine._graphs.values()] + [g for g, _ in engine._decode_graphs.values()]
    try:
        with pytest.raises(InjectedFault):
            first.result(timeout=WAIT)
        res = second.result(timeout=WAIT)
        stats = engine.stats()
    finally:
        engine.stop()
    assert res.tokens == jax_plain(tuple(PLAIN), 20)
    assert stats["engine-restarts-total"] == 1 and stats["graph-captures-total"] == 12
    assert stats["compiled_programs"] == 6
    new = [g for g, _ in engine._graphs.values()] + [g for g, _ in engine._decode_graphs.values()]
    assert len(new) == 6 and not any(n is o for n in new for o in old)
    assert stats["graph-replays-by-kind"]["decode"] == stats["decode-chunks-total"]


# -- the provider ---------------------------------------------------------------

BASE = {"model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "max-seq-len": 128}


def test_provider_passes_the_tenancy_and_sizing_keys():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        **BASE, "kv-pages": 40, "prefill-token-budget": 64, "max-prefill-streams": 1,
        "prefill-batch": 8, "tenants": TENANTS, "brownout": "auto",
        "brownout-enter-load": 3.0, "brownout-exit-load": 0.5, "brownout-dwell-s": 2.0,
        "observability": False, "flight-recorder-iterations": 32,
        "precompile": True, "overlap": True, "pipeline-depth": 1, "compile-cache-dir": "/x",
        "constrained-decoding": "off", "fleet": "off", "fleet-role": "mixed", "durable": "off",
    })
    try:
        engine = svc.engine()
        assert engine._pagepool.num_pages == 40
        assert engine.prefill_token_budget == 64 and engine.MAX_PREFILL_STREAMS == 1
        assert engine._tenants.state("aggressor").spec.max_slots == 2
        bo = engine._brownout
        assert (bo.enter_load, bo.exit_load, bo.dwell_s) == (3.0, 0.5, 2.0)
        assert not engine._obs.on and engine._obs.flight.capacity == 32
        stats = engine.stats()
        assert stats["kv-pages-total"] == 40 and stats["histograms"] == {}
    finally:
        svc.close()
    off = TorchCompletionsService({**BASE, "brownout": "off"})
    assert off.engine()._brownout is None
    off.close()
    with pytest.raises(ValueError, match="brownout"):
        TorchCompletionsService({**BASE, "brownout": "sometimes"})


@pytest.mark.parametrize("key, value", [
    ("mesh", {"seq": 2}), ("mesh", {"model": 1}), ("prefill-batch", 4),
])
def test_provider_refuses_what_it_cannot_serve_yet(key, value):
    """Every mesh the JAX provider takes constructs since ring prefill over
    a ``seq`` axis was ported (its ranks join when the engine is built), as
    do a world-1 mesh and any admit-group size."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({**BASE, key: value})
    assert svc.resource[key] == value
    if key == "prefill-batch":
        assert svc.prefill_batch == value
    else:
        assert svc.mesh_axes == value and svc.world == value.get("seq", 1)


def test_provider_refuses_refused_request_options():
    """A response format the grammar compiler does not support fails the
    completion with GrammarError (the JAX provider's refusal)."""
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService
    from langstream_tpu_torch.serving.constrain import GrammarError

    svc = TorchCompletionsService(BASE)
    try:
        with pytest.raises(GrammarError, match="unsupported response_format type"):
            asyncio.run(svc.get_chat_completions(
                [ChatMessage(role="user", content="hi")],
                {"max-tokens": 2, "response-format": {"type": "json_object"}},
            ))
    finally:
        svc.close()


def test_provider_close_lets_a_request_in_flight_finish():
    """``close()`` drains for ``drain-grace-s`` before it stops: a
    completion in flight when it is called ends with all its tokens."""
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({**BASE, "drain-grace-s": 60})
    engine = svc.engine()
    box = {}
    started = threading.Event()

    def on_chunk(_chunk):
        started.set()

    def run():
        box["result"] = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="hello there")],
            {"max-tokens": 40, "min-chunks-per-message": 1}, on_chunk,
        ))

    thread = threading.Thread(target=run)
    thread.start()
    assert started.wait(WAIT)
    svc.close()
    thread.join(WAIT)
    result = box["result"]
    assert result.completion_tokens == 40 and result.finish_reason == "length"
    assert engine.stats()["draining"] and svc._engine is None


def test_chat_template_renders_as_the_jax_provider(tmp_path):
    """F5: a tokenizer with a chat template renders chat prompts through
    it, as the JAX provider does; without one, ``role: content`` lines."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    from langstream_tpu.ai.tpu_serving import TpuCompletionsService, _EngineHolder
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(["hello world", "system user assistant"] * 4, vocab_size=280,
                            min_frequency=1, special_tokens=["<s>", "</s>"])
    fast = PreTrainedTokenizerFast(tokenizer_object=bpe._tokenizer, bos_token="<s>",
                                   eos_token="</s>")
    fast.chat_template = (
        "{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}</s>{% endfor %}"
        "{% if add_generation_prompt %}<|assistant|>{% endif %}"
    )
    fast.save_pretrained(str(tmp_path))
    msgs = [("system", "be brief"), ("user", "hello world")]
    svc = TorchCompletionsService({**BASE, "tokenizer": f"hf:{tmp_path}"})
    ours = svc._render_prompt([ChatMessage(role=r, content=c) for r, c in msgs])
    from langstream_tpu.ai.provider import ChatMessage as JaxMessage

    ref = TpuCompletionsService(_EngineHolder({"tokenizer": f"hf:{tmp_path}"}), {})
    want = ref._render_prompt([JaxMessage(role=r, content=c) for r, c in msgs])
    assert ours == want == "<|system|>be brief</s><|user|>hello world</s><|assistant|>"
    plain = TorchCompletionsService(BASE)._render_prompt([ChatMessage(role="user", content="x")])
    assert plain == "user: x\nassistant:"


# -- the memory plan's graph pool -----------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_memory_plan_charges_each_graph_set(quantized):
    """F4: over a ``meta`` tree, one term per captured set — its rows'
    sampling temporaries (the verify set's less the verify-chunk term),
    and with int8 weights the widened LM head and largest layer weight per
    set and once more for the eager path."""
    from langstream_tpu_torch.models.loader import expected_params
    from langstream_tpu_torch.serving.memory import (
        GRAPH_BYTES_PER_LOGIT,
        plan_serving_memory,
        widened_weight_bytes,
    )

    cfg = MODEL_PRESETS["llama-3-8b"]
    kw = dict(quantized_weights=quantized, kv_layout="paged", prefill_batch=8,
              prefill_bucket=2048, speculation_tokens=K)
    none = plan_serving_memory(cfg, 8, 2048, **kw)
    one = plan_serving_memory(cfg, 8, 2048, graph_sets=("decode",), **kw)
    verify = plan_serving_memory(cfg, 8, 2048, graph_sets=("verify",), **kw)
    both = plan_serving_memory(cfg, 8, 2048, graph_sets=("verify", "decode"), **kw)
    rows = GRAPH_BYTES_PER_LOGIT * cfg.vocab_size
    widened = widened_weight_bytes(expected_params(cfg, quantized=quantized), cfg)
    if quantized:
        d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        assert widened == 8 * d * v + 10 * d * f
    else:
        assert widened == 0
    assert none.graph_pool_bytes == 0 and none.eager_widened_bytes == widened
    assert one.graph_pool_bytes == 8 * rows + widened
    assert verify.graph_pool_bytes == 8 * (K + 1) * rows - verify.verify_chunk_bytes + widened
    assert verify.verify_chunk_bytes == 5 * 8 * (K + 1) * cfg.vocab_size * 4
    assert both.graph_pool_bytes == one.graph_pool_bytes + verify.graph_pool_bytes
    assert both.total_bytes - none.total_bytes == both.graph_pool_bytes
    assert "graph-pool (verify+decode)" in both.summary()
    # the engine plans the sets it captures
    tcfg = weights()[1]
    for spec, brownout, sets in (("off", "auto", ("decode",)), ("auto", "auto",
                                                                ("verify", "decode"))):
        engine = ServingEngine(tcfg, weights()[3], device="cpu", max_batch=2, max_seq_len=64,
                               speculation=spec, brownout=brownout)
        assert engine.memory_plan.graph_sets == sets
        assert engine.memory_plan.eager_widened_bytes == 0
