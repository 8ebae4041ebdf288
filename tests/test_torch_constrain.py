"""Grammar-constrained decoding in the PyTorch port
(``serving/constrain.py``, the mask of ``serving/sampling.py``, the
engine's on-device DFA advance), held against the JAX package on the CPU
(tiny-test, f32, ``ByteTokenizer``):

- equal: the token DFA ``compile_response_format`` builds and its packed
  tables (``pack_next_table``), ``verify_states``, the mask expansion (the
  port's int32 words against JAX's uint32), the DFA advance over random
  (row, state, token) triples (the -1 sentinel included), and the
  registry's rows after the same swaps and LRU evictions;
- the sampler: the mask lands after the NaN guard, sampled tokens land on
  legal ids only and follow the masked distribution (as
  ``tests/test_constrain.py`` holds JAX's), the masked verify equals JAX's;
- the engines token-exact against the JAX engine (every request submitted
  before ``start()``): constrained paged engine with ``speculation="auto"``,
  the resume state (complete, in range, out of range), a pinned grammar
  pool that sheds with a retry-after;
- replays: a stand-in graph drives the decode and verify replays with the
  tier on; tokens equal the direct calls', and every buffer a graph reads
  keeps its address;
- the provider serves ``response-format`` end to end.
"""

import asyncio
import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.serving import constrain as jc
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu.serving.engine import _dfa_advance as jax_dfa_advance
from langstream_tpu.serving.sampling import _expand_allowed as jax_expand
from langstream_tpu.serving.sampling import speculative_verify as jax_verify
from langstream_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving import constrain as tc
from langstream_tpu_torch.serving.engine import (
    GenerationRequest,
    ServingEngine,
    ShedError,
    _dfa_advance,
    _dfa_mask,
)
from langstream_tpu_torch.serving.sampling import _expand_allowed, sample, speculative_verify
from langstream_tpu_torch.serving.tokenizer import ByteTokenizer
from test_torch_graphs import ReplayGraph

WAIT = 300.0
TOK = ByteTokenizer()
V = MODEL_PRESETS["tiny-test"].vocab_size
SCHEMA = {"type": "object", "properties": {"name": {"type": "string", "maxLength": 8},
                                           "n": {"type": "integer"}}}
RF = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
FORMATS = {
    "object": RF,
    "flat-schema": {"type": "json_schema", "schema": {
        "type": "object", "properties": {"ok": {"type": "boolean"},
                                         "tags": {"type": "array", "maxItems": 3,
                                                  "items": {"enum": ["a", "b"]}}}}},
    "number": {"type": "json_schema", "json_schema": {"schema": {"type": "number"}}},
    "regex": {"type": "regex", "regex": "(yes|no)-[0-9]{2,4}"},
    "class": {"type": "regex", "regex": "[a-c]+x?\\.[^a-z\\n]{1,3}"},
}
BAD_FORMATS = [
    {"type": "json_object"},
    {"type": "regex"},
    {"type": "json_schema", "json_schema": {"schema": {"type": "object"}}},
    {"type": "regex", "regex": "(ab"},
    {"type": "regex", "regex": "a{3,1}"},
]
RX = FORMATS["regex"]
AGENTIC_KEYS = ("constrained-decoding", "constrained-requests-total", "grammars-resident",
                "grammar-swaps-total", "grammar-pool-bytes")


def both_dfas(rf, vocab=V):
    want = jc.compile_response_format(rf, JaxByteTokenizer(), vocab, 257)
    got = tc.compile_response_format(rf, ByteTokenizer(), vocab, 257)
    return want, got


# -- the host compiler -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_compile_response_format_and_packing_match_jax(name):
    want, got = both_dfas(FORMATS[name])
    np.testing.assert_array_equal(got.next, want.next)
    assert (got.accepting, got.complete, got.key) == (want.accepting, want.complete, want.key)
    for g, w in zip(got.packed(), want.packed()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.n_exceptions == want.n_exceptions
    # the no-dead-end invariant: every reachable state has a legal token
    assert (got.next >= 0).any(axis=1).all()


@pytest.mark.parametrize("rf", BAD_FORMATS, ids=lambda rf: json.dumps(rf)[:40])
def test_grammar_errors_match_jax(rf):
    with pytest.raises(tc.GrammarError) as got:
        tc.compile_response_format(rf, ByteTokenizer(), V, 257)
    with pytest.raises(jc.GrammarError) as want:
        jc.compile_response_format(rf, JaxByteTokenizer(), V, 257)
    assert str(got.value) == str(want.value)


def test_pack_next_table_matches_jax_on_random_tables():
    rng = np.random.default_rng(0)
    for states, vocab in ((3, 31), (5, 64), (7, 100)):
        table = rng.integers(-1, states, (states, vocab)).astype(np.int32)
        for g, w in zip(tc.pack_next_table(table), jc.pack_next_table(table)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["object", "regex"])
def test_verify_states_match_jax(name):
    want_dfa, got_dfa = both_dfas(FORMATS[name])
    rng = np.random.default_rng(1)
    for _ in range(40):
        state = int(rng.integers(0, got_dfa.n_states))
        drafts = rng.integers(0, 130, 4).tolist()
        assert tc.verify_states(got_dfa, state, drafts) == jc.verify_states(want_dfa, state,
                                                                            drafts)


def test_token_byte_table_is_cached_on_the_tokenizer():
    tok = ByteTokenizer()
    b1, l1 = tc._token_byte_table(tok, V)
    b2, l2 = tc._token_byte_table(tok, V)
    assert b1 is b2 and l1 is l2  # grammar-independent: built once
    # ids past the byte tokenizer's 258 decode to nothing: never legal
    assert (l1[258:] == -1).all()


# -- the device half: mask expansion and the DFA advance ---------------------


def test_expand_allowed_int32_matches_jax_uint32():
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2 ** 32, (3, 4, 5), dtype=np.uint64).astype(np.uint32)
    words[0, 0, 0] = 0xFFFFFFFF
    words[0, 0, 1] = 0x80000000  # the sign bit alone
    for vocab in (160, 150, 129):
        want = np.asarray(jax_expand(jnp.asarray(words), vocab))
        got = _expand_allowed(torch.from_numpy(words.view(np.int32)), vocab)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    mask = torch.from_numpy(rng.integers(0, 2, (2, 7)).astype(bool))
    assert _expand_allowed(mask, 7) is mask


@functools.lru_cache(maxsize=None)
def both_registries(slots=3, states=64):
    """A JAX and a port registry (tiny-test's vocab) with the same three
    grammars acquired in the same order."""
    jreg = jc.GrammarRegistry(JaxByteTokenizer(), V, 257, slots=slots, max_states=states,
                              max_exceptions=4096)
    treg = tc.GrammarRegistry(ByteTokenizer(), V, 257, slots=slots, max_states=states,
                              max_exceptions=4096, device="cpu")
    for name in ("object", "regex", "class"):
        rf = FORMATS[name]
        assert treg.acquire(treg.compile(rf)) == jreg.acquire(jreg.compile(rf))
    return jreg, treg


def assert_grammar_pools_equal(jpool, tpool):
    for plane, (w, g) in enumerate(zip(jpool, tpool)):
        w = np.asarray(w)
        if plane == 0:
            w = w.view(np.int32)  # the same bits, read as int32
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


def test_registry_rows_match_jax_after_swaps_and_lru():
    """Two slots, three grammars: swap-ins into free rows, an LRU eviction
    of the released row, a re-acquire of the evicted grammar — the four
    planes equal JAX's bit for bit after every step."""
    jreg = jc.GrammarRegistry(JaxByteTokenizer(), V, 257, slots=2, max_states=64,
                              max_exceptions=4096)
    treg = tc.GrammarRegistry(ByteTokenizer(), V, 257, slots=2, max_states=64,
                              max_exceptions=4096, device="cpu")
    assert_grammar_pools_equal(jreg.pool, treg.pool)
    compiled = {n: (jreg.compile(FORMATS[n]), treg.compile(FORMATS[n]))
                for n in ("object", "regex", "class")}
    ptrs = [p.data_ptr() for p in treg.pool]
    for op, name in (("acquire", "object"), ("acquire", "regex"), ("release", "object"),
                     ("acquire", "class"), ("release", "regex"), ("acquire", "object"),
                     ("release", "class"), ("acquire", "regex")):
        jd, td = compiled[name]
        assert getattr(treg, op)(td) == getattr(jreg, op)(jd)
        assert_grammar_pools_equal(jreg.pool, treg.pool)
        assert treg.stats() == jreg.stats()
    assert [p.data_ptr() for p in treg.pool] == ptrs  # written in place, never rebound


def test_registry_refusals_match_jax():
    with pytest.raises(ValueError, match="grammar-slots <= 0"):
        tc.GrammarRegistry(ByteTokenizer(), V, 257, slots=0, device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tc.GrammarRegistry(ByteTokenizer(), 2 ** 24, 257, slots=1, max_states=256, device="cpu")
    small = tc.GrammarRegistry(ByteTokenizer(), V, 257, slots=1, max_states=4, device="cpu")
    with pytest.raises(tc.GrammarError, match="raise grammar-states"):
        small.compile(RF)
    pinned = tc.GrammarRegistry(ByteTokenizer(), V, 257, slots=1, device="cpu")
    pinned.acquire(pinned.compile(RX))
    with pytest.raises(tc.GrammarError, match="pinned"):
        pinned.acquire(pinned.compile(RF))


@pytest.mark.parametrize("slots, states, vocab, exc", [
    (64, 128, 128256, 65536), (4, 128, 256000, 65536), (0, 128, 512, 65536), (1, 2, 512, 1),
])
def test_grammar_pool_bytes_match_jax(slots, states, vocab, exc):
    assert tc.grammar_pool_bytes(slots, states, vocab, exc) == \
        jc.grammar_pool_bytes(slots, states, vocab, exc)


def test_dfa_mask_and_advance_match_jax_on_random_triples():
    """Random (grammar row, state, token) triples, the NaN sentinel -1 and
    out-of-grammar states included: the port's searchsorted advance and
    bit gather equal JAX's."""
    jreg, treg = both_registries()
    rng = np.random.default_rng(3)
    n = 512
    g = rng.integers(0, 4, n)
    state = rng.integers(0, 20, n)
    tokens = rng.integers(-1, V, n)
    tokens[:8] = -1
    want = jax_dfa_advance(jreg.pool, jnp.asarray(g, jnp.int32), jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(state, jnp.int32), V)
    got = _dfa_advance(treg.pool, torch.from_numpy(g), torch.from_numpy(tokens),
                       torch.from_numpy(state), V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # legal tokens advance exactly as the dense table of their grammar
    dfas = {row: st.dfa for row, st in treg._row_owner.items()}
    for i in range(n):
        if g[i] in dfas and state[i] < dfas[g[i]].n_states and tokens[i] >= 0:
            nxt = dfas[g[i]].next[state[i], tokens[i]]
            if nxt >= 0 and state[i] not in dfas[g[i]].complete:
                assert got[i] == nxt
    mask = _dfa_mask(treg.pool, torch.from_numpy(g), torch.from_numpy(state))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jreg.pool[0])[g, state].view(np.int32)
    )


# -- the sampler ------------------------------------------------------------


def test_sample_mask_restricts_and_keeps_the_nan_guard():
    logits = torch.linspace(0, 1, 16)[None, :]
    allowed = torch.zeros((1, 16), dtype=torch.bool)
    allowed[0, 3] = True
    zeros, ones = torch.zeros(1), torch.ones(1)
    k0 = torch.zeros(1, dtype=torch.long)
    assert int(sample(logits, None, zeros, k0, ones, allowed=allowed)[0]) == 3
    poisoned = logits.clone()
    poisoned[0, 5] = float("nan")  # an illegal column, still a fault
    assert int(sample(poisoned, None, zeros, k0, ones, allowed=allowed)[0]) == -1
    # packed words: bit 3 of word 0
    packed = torch.tensor([[1 << 3]], dtype=torch.int32)
    assert int(sample(logits, None, zeros, k0, ones, allowed=packed)[0]) == 3


def test_sampled_path_respects_the_mask_distribution():
    """As ``tests/test_constrain.py`` holds JAX's: masked sampled tokens
    land only on legal ids and follow the masked softmax."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(1, 8)).astype(np.float32))
    allowed = torch.zeros((1, 8), dtype=torch.bool)
    allowed[0, [2, 5]] = True
    gen = torch.Generator().manual_seed(0)
    n = 400
    counts = {2: 0, 5: 0}
    temp = torch.full((1,), 0.8)
    for _ in range(n):
        out = sample(logits, gen, temp, torch.zeros(1, dtype=torch.long), torch.ones(1),
                     allowed=allowed)
        counts[int(out[0])] += 1
    masked = np.where(allowed[0].numpy(), logits[0].numpy() / 0.8, -np.inf)
    probs = np.exp(masked - masked.max())
    probs /= probs.sum()
    assert abs(counts[2] / n - probs[2]) < 0.1


def test_masked_greedy_verify_matches_jax():
    rng = np.random.default_rng(5)
    b, k, v = 4, 3, 96
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    words = rng.integers(0, 2 ** 32, (b, k + 1, v // 32), dtype=np.uint64).astype(np.uint32)
    words[..., 0] |= 1  # at least one legal token a row
    drafts[0] = np.argmax(np.where(jax_expand(jnp.asarray(words), v)[0, :k], logits[0, :k],
                                   -np.inf), axis=-1)  # row 0's drafts all legal and accepted
    zeros = np.zeros(b, np.float32)
    want_out, want_acc = jax_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.zeros(b, jnp.int32), jnp.ones(b), jnp.asarray(words),
    )
    got_out, got_acc = speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts), None, torch.from_numpy(zeros),
        torch.zeros(b, dtype=torch.long), torch.ones(b), allowed=torch.from_numpy(
            words.view(np.int32)),
    )
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    assert int(got_acc[0]) == k


# -- the engines -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def weights():
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-test"], dtype="float32")
    tcfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _kw(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("eos_token_id", TOK.eos_token_id)
    kw.setdefault("brownout", "off")
    return kw


def jax_engine(**kw):
    jcfg, _, jp, _ = weights()
    return JaxEngine(jcfg, jp, grammar_tokenizer=JaxByteTokenizer(), **_kw(**kw))


def port_engine(**kw):
    _, tcfg, _, tp = weights()
    return ServingEngine(tcfg, tp, device="cpu", grammar_tokenizer=ByteTokenizer(), **_kw(**kw))


def run_all(engine, items, jax_side: bool):
    options, request = (JaxOptions, JaxRequest) if jax_side else (GenerationOptions,
                                                                   GenerationRequest)
    reqs = [engine.submit(request(prompt_tokens=list(p), options=options(**o)))
            for p, o in items]
    engine.start()
    try:
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=WAIT))
            except Exception as e:  # noqa: BLE001 — compared by type
                out.append(e)
        return out, engine.stats()
    finally:
        engine.stop()


def assert_same(want, got):
    for w, g in zip(want, got):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__, (w, g)
        else:
            assert (g.tokens, g.finish_reason) == (w.tokens, w.finish_reason)


def assert_in_grammar(result, rf):
    text = TOK.decode(result.tokens)
    if rf["type"] == "regex":
        assert re.fullmatch(rf["regex"], text), text
    else:
        doc = json.loads(text)
        assert set(doc) == set(SCHEMA["properties"]) and isinstance(doc["n"], int)
    assert result.finish_reason == "stop"


def spec_items():
    # a repetitive prompt: its n-gram drafts hit, some of them illegal
    rep = TOK.encode('{"name":"abab","n":12}' * 3)
    return [
        (rep, dict(max_new_tokens=40, response_format=RF)),
        (TOK.encode("answer: "), dict(max_new_tokens=20, response_format=RX)),
        ([5, 9, 11, 7] * 6, dict(max_new_tokens=16)),
        (rep[:20], dict(max_new_tokens=40, response_format=RF)),
    ]


def test_constrained_speculative_paged_engine_matches_jax():
    kw = dict(speculation="auto", speculation_tokens=4)
    want, jstats = run_all(jax_engine(**kw), spec_items(), True)
    got, tstats = run_all(port_engine(**kw), spec_items(), False)
    assert_same(want, got)
    keys = AGENTIC_KEYS + ("spec-draft-tokens-total", "spec-accepted-tokens-total",
                           "spec-verify-dispatches-total")
    assert {k: tstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert tstats["spec-accepted-tokens-total"] > 0
    for (_, o), r in zip(spec_items(), got):
        if "response_format" in o:
            assert_in_grammar(r, o["response_format"])


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_sampled_constrained_completions_all_parse(layout):
    items = [(TOK.encode(f"go {i}"), dict(max_new_tokens=64, temperature=t, top_k=k,
                                          response_format=rf))
             for i, (t, k, rf) in enumerate([(0.9, 0, RF), (1.3, 0, RF), (1.0, 20, RF),
                                             (1.1, 0, RX), (0.7, 5, RX), (1.5, 0, RX)])]
    got, stats = run_all(port_engine(kv_layout=layout, rng_seed=7), items, False)
    for (_, o), r in zip(items, got):
        assert_in_grammar(r, o["response_format"])
    assert stats["constrained-requests-total"] == len(items)


def test_grammar_resume_state_complete_in_range_and_out_of_range():
    """Resume states of the regex "ab(c|d)": the complete state resolves at
    submit with no tokens; state 1 (after "a") continues the derivation as
    the JAX engine does; a state past the grammar's fails the request."""
    rf = {"type": "regex", "regex": "ab(c|d)"}
    dfa = tc.compile_response_format(rf, TOK, V, TOK.eos_token_id)
    done = next(iter(dfa.complete))
    items = [(TOK.encode("x: a"), dict(max_new_tokens=8, response_format=rf,
                                       grammar_resume_state=dfa.advance(0, ord("a")))),
             (TOK.encode("x: "), dict(max_new_tokens=8, response_format=rf,
                                      grammar_resume_state=dfa.n_states + 2))]
    want, _ = run_all(jax_engine(), items, True)
    got, _ = run_all(port_engine(), items, False)
    assert_same(want, got)
    assert TOK.decode(got[0].tokens) in ("bc", "bd")
    assert isinstance(got[1], ValueError) and "out of range" in str(got[1])
    engine = port_engine()
    request = engine.submit(GenerationRequest(prompt_tokens=[5], options=GenerationOptions(
        response_format=rf, grammar_resume_state=done)))
    result = request.result(timeout=1)
    assert (result.tokens, result.finish_reason, request.dfa_state) == ([], "stop", done)


def test_host_mirror_state_is_set_before_on_token():
    seen = []
    engine = port_engine()
    engine.start()
    try:
        holder = {}

        def on_token(token):
            seen.append((token, holder["request"].dfa_state))

        request = GenerationRequest(prompt_tokens=TOK.encode("q"), on_token=on_token,
                                    options=GenerationOptions(max_new_tokens=12,
                                                              response_format=RX))
        holder["request"] = request
        engine.submit(request)
        result = request.result(timeout=WAIT)
    finally:
        engine.stop()
    dfa = engine._constrain_reg.compile(RX)
    state = 0
    for token, reported in seen:
        state = dfa.advance(state, token)
        assert reported == state
    assert_in_grammar(result, RX)


def test_pinned_grammar_pool_sheds_with_retry_after_then_serves():
    engine = port_engine(grammar_slots=1)
    engine.start()
    try:
        held = engine.submit(GenerationRequest(
            prompt_tokens=[5, 6], options=GenerationOptions(
                max_new_tokens=120, response_format={"type": "regex", "regex": "[a-z]{100,120}"}),
        ))
        with pytest.raises(ShedError) as exc:
            engine.generate([5, 6], GenerationOptions(max_new_tokens=20, response_format=RX),
                            timeout=WAIT)
        assert exc.value.retry_after_s > 0
        held.cancel()
        held.result(timeout=WAIT)
        ok = engine.generate([5, 6], GenerationOptions(max_new_tokens=20, response_format=RX),
                             timeout=WAIT)
        assert_in_grammar(ok, RX)
        stats = engine.stats()
        assert stats["grammar-swaps-total"] == 2 and stats["grammars-resident"] == 1
    finally:
        engine.stop()


def test_constrained_decoding_off_and_zero_slots_refuse_a_response_format():
    for kw in (dict(constrained_decoding="off"), dict(grammar_slots=0)):
        engine = port_engine(**kw)
        assert engine._constrain_reg is None and engine.memory_plan.grammar_pool_bytes == 0
        with pytest.raises(ValueError, match="constrained decoding is off"):
            engine.submit(GenerationRequest(prompt_tokens=[5],
                                            options=GenerationOptions(response_format=RF)))
        assert not engine.stats()["constrained-decoding"]
    on = port_engine()
    assert on.memory_plan.grammar_pool_bytes == on.stats()["grammar-pool-bytes"] > 0


# -- replays -----------------------------------------------------------------


def _replay_items():
    return [
        (TOK.encode("a: "), dict(max_new_tokens=40, response_format=RF)),
        ([5, 9, 11, 7] * 5, dict(max_new_tokens=24, adapter="tenant-a")),
        (TOK.encode("b: "), dict(max_new_tokens=20, response_format=RX, adapter="tenant-b")),
        ([3, 1, 4, 1, 5], dict(max_new_tokens=24)),
    ]


@pytest.mark.parametrize("layout, spec", [("paged", False), ("paged", True), ("dense", False)],
                         ids=["paged-decode", "paged-verify", "dense-decode"])
def test_replays_with_the_tier_on_equal_direct_calls(layout, spec):
    """A stand-in graph captures the decode chunk (or the verify) with the
    adapter gather, the mask and the advance in it, and every dispatch is
    a replay: the tokens equal an engine calling the chunk directly, the
    graph set stays one set of three, and no buffer a graph reads moved."""
    adapters = [{"name": "tenant-a", "rank": 4, "scale": 2.0, "seed": 11},
                {"name": "tenant-b", "rank": 2, "seed": 22}]
    kw = dict(kv_layout=layout, adapters=adapters,
              speculation="auto" if spec else "off")
    direct, _ = run_all(port_engine(**kw), _replay_items(), False)
    engine = port_engine(**kw)
    engine._graph_factory = ReplayGraph
    reads = [engine._tokens_dev, engine._positions_dev, engine._g_rows_dev,
             engine._dfa_state_dev, engine._arows_dev] + list(engine._constrain_reg.pool)
    if spec:
        reads.append(engine._vstates_dev)
    ptrs = [t.data_ptr() for t in reads]
    replayed, stats = run_all(engine, _replay_items(), False)
    assert_same(direct, replayed)
    assert stats["compiled_programs"] == 3
    assert stats["graph-replays-total"] > 0
    kind = "verify" if spec else "decode"
    assert stats["graph-replays-by-kind"][kind] == stats["graph-replays-total"]
    assert [t.data_ptr() for t in (engine._tokens_dev, engine._positions_dev,
                                   engine._g_rows_dev, engine._dfa_state_dev,
                                   engine._arows_dev, *engine._constrain_reg.pool)] + (
        [engine._vstates_dev.data_ptr()] if spec else []) == ptrs
    for (_, o), r in zip(_replay_items(), replayed):
        if "response_format" in o:
            assert_in_grammar(r, o["response_format"])


# -- the provider ------------------------------------------------------------


def test_provider_serves_response_format_end_to_end():
    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({
        "model": "tiny-test", "device": "cpu", "max-batch": 2, "decode-chunk": 4,
        "max-seq-len": 128, "constrained-decoding": "auto", "grammar-slots": 4,
        "grammar-states": 64, "grammar-exceptions": 4096,
    })
    try:
        chunks = []
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="a record please")],
            {"max-tokens": 64, "response-format": RF}, chunks.append,
        ))
        doc = json.loads(result.content)
        assert set(doc) == {"name", "n"} and result.finish_reason == "stop"
        assert "".join(c.content for c in chunks) == result.content
        resumed = asyncio.run(svc.get_text_completions(
            ["go"], {"max-tokens": 8, "response-format": RX, "grammar-resume-state": 0}))
        assert re.fullmatch(RX["regex"], resumed.content)
        engine = svc.engine()
        stats = engine.stats()
        assert stats["constrained-decoding"] and stats["constrained-requests-total"] == 2
        reg = engine._constrain_reg
        assert (reg.slots, reg.max_states, reg.max_exceptions) == (4, 64, 4096)
        assert reg.tokenizer is svc.tokenizer
    finally:
        svc.close()
