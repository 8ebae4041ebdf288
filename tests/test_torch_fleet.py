"""The port's fleet router against the JAX package's, over fake replicas.

Each scenario drives the JAX ``FleetRouter`` and the port's through the same
script — the same beacon documents, the same routes, failures, refreshes
and clock — and holds every route's decision (``replica_id``, ``kind``,
``disagg``, ``expected_match``, the P2P hint), every shed, the autoscale
hints and the routers' ``stats()`` counters equal between the two. The
clock is scripted: both modules' ``time`` is replaced by one fake whose
monotonic time only moves when a scenario advances it.

Also: ``beacon_from_engine`` of a port engine validates under both
packages' ``validate_beacon`` and carries no token content.
"""

import dataclasses
import json

import pytest
import torch

from langstream_tpu.serving import fleet as jfleet
from langstream_tpu_torch.models.bridge import init_params
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import fleet as tfleet
from langstream_tpu_torch.serving.engine import ServingEngine
from langstream_tpu_torch.serving.pagepool import prefix_digest

PROMPT = [11 + i % 60 for i in range(70)]
SHORT = [11 + i % 60 for i in range(12)]
OTHER = [5 + (7 * i) % 60 for i in range(70)]
# the statistics that are wall-clock timings of the host, not decisions
TIMED = ("-p50-ms", "-p99-ms")


class FakeClock:
    """Stands in for the ``time`` module in both fleet modules."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now

    def time(self) -> float:
        return 1.7e9 + self.now

    def sleep(self, s: float) -> None:
        self.now += s


class Fake:
    """A replica whose beacon the scenario scripts; ``generate`` answers
    with fixed tokens, or raises the error it was given."""

    is_local = False

    def __init__(self, mod, rid: str, role: str = "mixed", **beacon) -> None:
        self.mod = mod
        self.replica_id = rid
        self.url = f"fake:{rid}"
        self.beacon = dict(role=role, **beacon)
        self.error = None
        self.down = False

    def fetch_beacon(self) -> dict:
        if self.down:
            raise self.mod.ReplicaError(f"replica {self.replica_id}: unreachable")
        doc = {
            "schema": self.mod.BEACON_SCHEMA, "id": self.replica_id, "url": self.url,
            "at": 0.0, "load_score": 0.0, "queue_wait_ema_s": 0.0, "active_slots": 0,
            "max_batch": 4, "queued": 0, "queue_depth": 16, "draining": False,
            "quarantined": False, "prefixes": [],
        }
        doc.update(self.beacon)
        return doc

    def generate(self, tokens, options=None, timeout_s=600.0) -> dict:
        if self.error is not None:
            raise self.error(f"replica {self.replica_id}: injected")
        return {"tokens": [1, 2, 3], "finish_reason": "length",
                "prompt_tokens": len(tokens), "ttft_s": 0.0, "total_s": 0.0}


def ads(tokens, *lengths) -> list:
    return [[prefix_digest(tokens[:n]), n] for n in lengths]


def observe(mod, router, call):
    """One scripted call's observable outcome: a decision's fields, a
    shed's class, or the call's plain result."""
    try:
        out = call()
    except mod.FleetShedError as e:
        return ("shed", str(e))
    except mod.ReplicaError:
        return ("replica-error",)
    if isinstance(out, (mod.RouteDecision,)):
        return (out.replica_id, out.kind, out.disagg, out.expected_match, out.p2p_source,
                out.p2p_match)
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], mod.RouteDecision):
        return (out[0]["tokens"], out[1].replica_id)
    return out


# -- scenarios: fn(mod, clock) -> (replicas, router kwargs, script) -----------
# a script is a list of steps, each a callable(router, fakes) returning a
# value for ``observe``


def _route(tokens, **kw):
    return lambda r, f: r.route(tokens, **kw)


def _set(rid, **beacon):
    def step(r, f):
        f[rid].beacon.update(beacon)
        return r.refresh_all()
    return step


def _advance(clock, s):
    def step(r, f):
        clock.now += s
        return None
    return step


def sc_affinity(mod, clock):
    return ([("r0", {"prefixes": ads(PROMPT, 32)}), ("r1", {})], {},
            [_route(PROMPT), _route(OTHER), _route(PROMPT, adapter="x")])


def sc_lambda_trade(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32), "load_score": 1.0}), ("r1", {})]
    return (reps, {"lam": 256.0}, [_route(PROMPT), _set("r0", load_score=0.05), _route(PROMPT)])


def sc_least_loaded_fallback(mod, clock):
    reps = [("r0", {"load_score": 0.7}), ("r1", {"load_score": 0.2}), ("r2", {"load_score": 0.9})]
    return reps, {}, [_route(OTHER), _set("r1", load_score=2.0), _route(OTHER)]


def sc_sticky_until_death(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32)}), ("r1", {})]

    def fail(r, f):
        r.mark_failed("r0")
        return None

    return reps, {}, [_route(OTHER, session_id="s"), _route(PROMPT, session_id="s"), fail,
                      _route(PROMPT, session_id="s"), _route(PROMPT, session_id="s")]


def sc_sticky_ttl(mod, clock):
    reps = [("r0", {}), ("r1", {"prefixes": ads(PROMPT, 32)})]
    return reps, {"sticky_ttl_s": 5.0, "beacon_ttl_s": 100.0}, [
        _route(OTHER, session_id="s"), _advance(clock, 3.0), _route(PROMPT, session_id="s"),
        _advance(clock, 6.0), _route(PROMPT, session_id="s"),
    ]


def sc_drain_quarantine_stale(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32), "draining": True}),
            ("r1", {"quarantined": True}), ("r2", {"load_score": 0.5}),
            ("r3", {"recovering": True})]

    def down(r, f):
        f["r2"].down = True
        return r.refresh_all()

    return reps, {"beacon_ttl_s": 10.0, "refresh_interval_s": 1.0}, [
        _route(PROMPT), _set("r0", draining=False), _route(PROMPT), down, _route(PROMPT),
        _advance(clock, 11.0), _route(PROMPT), down, down,
    ]


def sc_sheds(mod, clock):
    full = {"queued": 16, "queue_depth": 16}
    reps = [("r0", dict(full)), ("r1", {"queue_wait_ema_s": 40.0}),
            ("r2", {"tenants": {"t": {"queued": 3, "queue_wait_ema_s": 2.0,
                                      "over_quota": False}}})]
    return reps, {}, [
        _route(PROMPT), _route(PROMPT, tenant="t"), _route(PROMPT, tenant="u"),
        _set("r2", tenants={"t": {"queued": 3, "queue_wait_ema_s": 2.0, "over_quota": True}}),
        _route(PROMPT, tenant="t"), _route(PROMPT, tenant="u"), _set("r2", **full),
        _route(PROMPT),
    ]


def sc_round_robin(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32)}), ("r1", {}), ("r2", {})]
    return reps, {"policy": "round-robin"}, [_route(PROMPT) for _ in range(5)]


def sc_least_loaded_policy(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32), "load_score": 0.4}), ("r1", {"load_score": 0.1})]
    return reps, {"policy": "least-loaded"}, [_route(PROMPT, session_id="s"), _route(PROMPT)]


def sc_adapters_tenants_brownout(mod, clock):
    reps = [("r0", {"adapters": ["a1"]}),
            ("r1", {"tenants": {"t": {"queued": 2, "queue_wait_ema_s": 0.1,
                                      "over_quota": False}}}),
            ("r2", {"prefixes": ads(PROMPT, 32), "brownout_level": 2})]
    return reps, {}, [_route(OTHER, adapter="a1"), _route(OTHER, tenant="t"), _route(PROMPT),
                      _set("r2", brownout_level=0), _route(PROMPT)]


def sc_desired_replicas(mod, clock):
    reps = [("r0", {"queue_wait_ema_s": 2.0}), ("r1", {"queue_wait_ema_s": 1.0})]

    def hint(**kw):
        return lambda r, f: r.desired_replicas(**kw)

    return reps, {}, [
        hint(), hint(target_queue_wait_s=0.25, max_replicas=5),
        _set("r0", queue_wait_ema_s=0.0), _set("r1", queue_wait_ema_s=0.0), hint(),
        _set("r0", active_slots=4), hint(),
        lambda r, f: r.desired_replicas_by_role(),
    ]


def sc_desired_by_role(mod, clock):
    reps = [("p1", {"role": "prefill", "queue_wait_ema_s": 2.0}),
            ("d1", {"role": "decode", "active_slots": 4, "load_score": 2.5}),
            ("d2", {"role": "decode", "active_slots": 4}), ("m1", {"role": "mixed"})]

    def hint(**kw):
        return lambda r, f: r.desired_replicas_by_role(**kw)

    return reps, {}, [hint(), hint(target_queue_wait_s=4.0), _set("p1", queue_wait_ema_s=0.0),
                      _set("d1", active_slots=0, load_score=0.0), _set("d2", active_slots=0),
                      hint(min_replicas=0)]


def sc_prefill_route_disagg(mod, clock):
    reps = [("pre", {"role": "prefill", "load_score": 0.5, "caps": ["kvmig"]}),
            ("dec", {"role": "decode", "caps": ["kvmig", "dfa-resume"]}),
            ("mix", {"role": "mixed"})]

    def target(*exclude, caps=()):
        return lambda r, f: r._pick_decode_target(set(exclude), require_caps=caps)

    return reps, {"prefill_route_threshold": 32}, [
        _route(PROMPT), _route(SHORT), _route(PROMPT, session_id="s"),
        _route(PROMPT, session_id="s"), target(), target("dec"), target("dec", caps=("kvmig",)),
        target("dec", "mix"),
    ]


def sc_prefill_route_no_migrate(mod, clock):
    reps = [("pre", {"role": "prefill"}), ("dec", {"role": "decode"})]
    return reps, {"prefill_route_threshold": 32, "migrate": False}, [_route(PROMPT)]


def sc_hibernated_owner(mod, clock):
    reps = [("r0", {"spilled_prefixes": ads(PROMPT, 64), "load_score": 0.05}),
            ("r1", {"prefixes": ads(PROMPT, 16)})]
    return reps, {"spill_discount": 0.5}, [
        _route(PROMPT), _set("r0", spilled_prefixes=ads(PROMPT, 32)), _route(PROMPT),
    ]


def sc_spill_discount(mod, clock):
    reps = [("r0", {"spilled_prefixes": ads(PROMPT, 64)}), ("r1", {"prefixes": ads(PROMPT, 48)})]
    return reps, {"spill_discount": 0.9}, [_route(PROMPT)]


def sc_p2p_cost_model(mod, clock):
    owner = {"prefixes": ads(PROMPT, 64), "load_score": 1.0, "caps": ["p2p"],
             "bytes_per_page": 1 << 20, "page_size": 16}
    reps = [("own", owner), ("dst", {"caps": ["p2p"], "prefill_tps": 1000.0})]

    def bw(value):
        def step(r, f):
            r._p2p_bw_ema = value
            return None
        return step

    return reps, {"p2p_threshold": 128, "lam": 256.0}, [
        _route(PROMPT), bw(1e9), _route(PROMPT), bw(1e6), _route(PROMPT),
        _set("dst", caps=[]), _route(PROMPT),
    ]


def sc_prefetch_counts(mod, clock):
    reps = [("own", {"prefixes": ads(PROMPT, 64), "load_score": 1.0, "caps": ["p2p"]}),
            ("dst", {"caps": ["p2p"]})]

    def prefetch(tokens):
        def step(r, f):
            out = r.prefetch(tokens)
            return (out["prefetched"], out.get("replica"), out.get("source"), out.get("match"))
        return step

    return reps, {"p2p_threshold": 16}, [prefetch(PROMPT), prefetch(OTHER)]


def sc_scale_to_zero(mod, clock):
    reps = [("r0", {"caps": ["durable"]}), ("r1", {"caps": ["durable"]})]

    def hint(r, f):
        return r.desired_replicas(min_replicas=0)

    return reps, {"beacon_ttl_s": 1e6}, [
        hint, _advance(clock, 31.0), hint, _route(OTHER), hint, _advance(clock, 31.0), hint,
        _set("r1", caps=[]), hint,
    ]


def sc_generate_failover(mod, clock):
    reps = [("r0", {"prefixes": ads(PROMPT, 32)}), ("r1", {})]

    def breaks(rid, err):
        def step(r, f):
            f[rid].error = getattr(mod, err)
            return None
        return step

    return reps, {}, [
        lambda r, f: r.generate(PROMPT), breaks("r0", "ReplicaError"),
        lambda r, f: r.generate(PROMPT), breaks("r1", "FleetShedError"),
        lambda r, f: r.generate(OTHER),
    ]


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("sc_")}


def run(mod, scenario, monkeypatch) -> tuple[list, dict]:
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    reps, kw, script = scenario(mod, clock)
    fakes = {rid: Fake(mod, rid, **beacon) for rid, beacon in reps}
    kw.setdefault("refresh_interval_s", 3600.0)
    router = mod.FleetRouter(list(fakes.values()), **kw)
    router.refresh_all()
    seen = [observe(mod, router, lambda step=step: step(router, fakes)) for step in script]
    stats = {k: v for k, v in router.stats().items()
             if k != "histograms" and not k.endswith(TIMED) and not k.startswith("fleet-wire-")}
    return seen, stats


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_matches_jax(name, monkeypatch):
    want, want_stats = run(jfleet, SCENARIOS[name], monkeypatch)
    got, got_stats = run(tfleet, SCENARIOS[name], monkeypatch)
    assert got == want
    assert got_stats == want_stats


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, device="cpu", max_batch=2, max_seq_len=128, decode_chunk=4,
                        prefill_buckets=(16, 32, 64), page_size=16, prefix_cache="auto")
    eng.start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def jax_engine():
    import jax

    from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
    from langstream_tpu.models.transformer import init_params as jax_init_params
    from langstream_tpu.serving.engine import ServingEngine as JaxEngine

    cfg = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
    eng = JaxEngine(cfg, jax_init_params(cfg, jax.random.PRNGKey(0)), kv_layout="paged",
                    max_batch=2, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32, 64),
                    page_size=16, prefix_cache="auto")
    eng.start()
    yield eng
    eng.stop()


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_port_beacon_validates_under_both_packages(engine, jax_engine, role):
    from langstream_tpu.models.configs import GenerationOptions as JaxOptions

    prompt = [3 + (5 * i) % 90 for i in range(40)]
    engine.generate(prompt, GenerationOptions(max_new_tokens=2), timeout=60)
    jax_engine.generate(prompt, JaxOptions(max_new_tokens=2), timeout=60)
    doc = tfleet.beacon_from_engine("r", engine, role=role)
    assert tfleet.validate_beacon(doc) and jfleet.validate_beacon(doc)
    # the router's fetch-vs-prefill cost model reads these three: the page
    # geometry equal to the JAX engine's, the landed prefill rate measured
    # (a timing: only its presence is compared)
    want = jfleet.beacon_from_engine("r", jax_engine, role=role)
    assert (doc["page_size"], doc["bytes_per_page"]) == (want["page_size"], want["bytes_per_page"])
    assert doc["page_size"] == 16 and doc["prefill_tps"] > 0 and want["prefill_tps"] > 0
    assert set(doc) == set(want) and set(doc["caps"]) == set(want["caps"])
    assert doc["role"] == role and doc["prefixes"] == ads(prompt, 32)
    assert {"kvmig", "dfa-resume", "p2p"} <= set(doc["caps"])
    text = json.dumps(doc)
    assert str(prompt[:8])[1:-1] not in text
    for key in ("tokens", "prompt", "text", "prompt_tokens"):
        assert key not in doc
    with pytest.raises(ValueError, match="token-content"):
        tfleet.validate_beacon(dict(doc, prompt_tokens=prompt))
    with pytest.raises(ValueError, match="unknown fleet role"):
        tfleet.beacon_from_engine("r", engine, role="turbo")
