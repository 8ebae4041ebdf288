"""SPMD parity of the port's fast tiers and its host-detectable faults
under a loopback pair (the counterparts of ``tests/test_spmd_parity.py``
and of the leader-wedge drill of ``tests/test_spmd_recovery.py``), with
``test_torch_spmd.py``'s pair and reference helpers: the dense fast tier
and int8 KV on the paged fast tier against the JAX loopback pair's tokens,
a page-table fault quarantining its victim alone on both engines, and a
leader's wedged fetch escalating to a coordinated recovery. f32 tiny-test;
tokens compared exactly."""

import dataclasses
import time

import jax
import numpy as np
import pytest

import test_torch_spmd as base
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import GenerationOptions
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector
from test_torch_spmd import WARM, PortPair, jax_pair_tokens, kw, weights  # noqa: F401


@pytest.mark.parametrize("layout, fast, kv", [("dense", True, "model"), ("paged", True, "int8")],
                         ids=["dense-fast", "paged-fast-int8kv"])
def test_loopback_pair_more_tiers_equal_jax_pair(layout, fast, kv):
    """The dense fast tier (prefix pool and speculation) and int8 KV on the
    paged fast tier ("jnp" attention on both sides, as every int8 engine
    comparison runs): the JAX loopback pair's tokens, state in lockstep."""
    jcfg = dataclasses.replace(base.JCFG, kv_cache_dtype=kv, attention_impl="jnp")
    cfg = dataclasses.replace(base.CFG, kv_cache_dtype=kv, attention_impl="jnp")
    saved = base.JCFG, base.CFG
    base.JCFG, base.CFG = jcfg, cfg  # the helpers read the module's configs
    try:
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        prompts = base.PROMPTS[:4]
        want = jax_pair_tokens(jp, layout, fast, prompts=prompts)
        pair = PortPair(params, layout, fast)
        reqs = pair.submit_all(prompts)
        pair.leader.start()
        try:
            got = [r.result(timeout=120).tokens for r in reqs]
            got += [r.result(timeout=120).tokens for r in pair.submit_all([WARM])]
        finally:
            pair.stop()
    finally:
        base.JCFG, base.CFG = saved
    assert not pair.error, pair.error
    assert got == want
    pair.assert_lockstep()


def test_page_fault_quarantines_victim_only_on_both(weights):
    """The ``page`` site on the leader: the corrupted table row is caught
    before the dispatch and only that slot is quarantined (its pages freed
    and zeroed over the wire); the survivors keep a solo engine's tokens and
    neither engine restarts."""
    prompts = [[5, 6, 7], [8, 9, 1, 2], [3, 4]]
    opts = GenerationOptions(max_new_tokens=6, temperature=0.0)
    ref = ServingEngine(base.CFG, weights[1], device="cpu", **kw(fast=False, prefix_cache="auto"))
    reqs = [ref.submit(GenerationRequest(prompt_tokens=list(p), options=opts))
            for p in prompts]
    ref.start()
    try:
        want = {tuple(p): r.result(timeout=60).tokens for p, r in zip(prompts, reqs)}
    finally:
        ref.stop()
    pair = PortPair(weights[1], injector=FaultInjector("page@1", seed=0), prefix_cache="auto")
    reqs = [pair.leader.submit(GenerationRequest(prompt_tokens=list(p), options=opts))
            for p in prompts]
    pair.leader.start()
    try:
        outcomes = []
        for r in reqs:
            try:
                outcomes.append(("ok", r.result(timeout=60).tokens, r))
            except RuntimeError as e:
                outcomes.append(("quarantined", str(e), r))
        stats = pair.leader.stats()
    finally:
        pair.stop()
    assert not pair.error, pair.error
    assert [k for k, _, _ in outcomes].count("quarantined") == 1, outcomes
    assert stats["quarantined-slots-total"] == 1 and stats["engine-restarts-total"] == 0
    for kind, tokens, r in outcomes:
        if kind == "ok":
            assert tokens == want[tuple(r.prompt_tokens)]
    pair.assert_lockstep()


def test_leader_wedge_escalates_to_recover(weights):
    """A fetch stalled past ``spmd-watchdog-s`` raises EngineWedgedError out
    of the leader's iteration: the supervisor escalates to OP_RECOVER, the
    wedged fetch thread is abandoned, and the slice serves on."""
    opts = GenerationOptions(max_new_tokens=6, temperature=0.0)
    pair = PortPair(weights[1])
    pair.leader.start()
    try:
        pair.leader.generate([5, 6, 7], opts, timeout=60)
        inj = FaultInjector("fetch@1", seed=0, stall_s=8.0)
        pair.leader._injector = inj
        old_fetcher = pair.leader._fetcher
        old_fetcher._injector = inj
        pair.channel.watchdog_s = 0.4
        victim = GenerationRequest(prompt_tokens=[5, 6, 7], options=opts)
        pair.leader.submit(victim)
        with pytest.raises(Exception):
            victim.result(timeout=60)
        deadline = time.monotonic() + 30
        while (pair.leader.stats()["spmd-watchdog-trips-total"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        out = pair.leader.generate([5, 6, 7], opts, timeout=60)
        assert pair.leader._fetcher is not old_fetcher
        assert len(out.tokens) == 6
        stats = pair.leader.stats()
        assert stats["spmd-watchdog-trips-total"] == 1 and stats["spmd-recoveries-total"] >= 1
        assert pair.thread.is_alive()
    finally:
        pair.leader._injector = None
        pair.stop()
    assert not pair.error, pair.error
