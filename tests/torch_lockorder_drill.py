"""The port's lock-order recorder across a CPU serving drill.

Run as a script (``python tests/torch_lockorder_drill.py DIR``): it arms
``langstream_tpu_torch.analysis.lockorder`` before any other module of the
port is imported, then drives a tiny-test paged engine through the fetch
thread, a host-KV-tier spill and restore, a durable hibernate and a restore
from disk on a second engine, an in-process P2P fetch and migration between
two more engines, and an on-demand flight dump. It prints one JSON line,
``{"summary": ..., "sites": [...], "edges": [[held, acquired, n], ...],
"report": "..."}``, and exits 0.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from langstream_tpu_torch.analysis import lockorder  # noqa: E402

PRE = sorted(m for m in sys.modules if m.split(".")[0] == "langstream_tpu_torch")
assert all(m == "langstream_tpu_torch" or m.startswith("langstream_tpu_torch.analysis")
           for m in PRE), f"port modules imported before the recorder: {PRE}"
REC = lockorder.activate()

import dataclasses  # noqa: E402

import torch  # noqa: E402

from langstream_tpu_torch.models.bridge import init_params  # noqa: E402
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions  # noqa: E402
from langstream_tpu_torch.serving import fleet  # noqa: E402
from langstream_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from langstream_tpu_torch.serving.observability import validate_flight_dump  # noqa: E402

WAIT = 60.0
CFG = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
V = CFG.vocab_size
PROMPT_A = [(7 + 3 * i) % V for i in range(45)]
PROMPT_B = [(5 + 11 * i) % V for i in range(45)]
GREEDY = GenerationOptions(max_new_tokens=6, temperature=0.0)
KW = dict(max_batch=2, max_seq_len=128, decode_chunk=4, prefill_buckets=(16, 32, 64),
          page_size=16, prefix_cache="auto", device="cpu")


def wait_stat(engine, key: str, want: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while engine.stats()[key] < want:
        if time.monotonic() > deadline:
            raise AssertionError(f"{key} never reached {want}: {engine.stats()[key]}")
        time.sleep(0.01)


def main(workdir: str) -> None:
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    tier = dict(KW, kv_pages=5, host_kv_fraction=2.0, spill_idle_s=0.0,
                prefix_cache_entries=8, durable="on", durable_dir=workdir)
    # the fetch thread, a spill, a demotion and a restore from the host arena
    a = ServingEngine(CFG, params, **tier)
    a.start()
    try:
        first = a.generate(list(PROMPT_A), GREEDY, timeout=WAIT).tokens
        wait_stat(a, "spill-pages-total", 2)
        a.generate(list(PROMPT_B), GREEDY, timeout=WAIT)
        assert a.generate(list(PROMPT_A), GREEDY, timeout=WAIT).tokens == first
        wait_stat(a, "restored-hits-total", 1)
        dump = a.stats(dump=True)["flight-recorder"]
        assert dump is not None and validate_flight_dump(dump)
        ledger = a.hibernate("drill")
        assert ledger["failures"] == 0, ledger
        assert a.stats()["durable-checkpoints-total"] >= 1
    finally:
        a.stop()
    # a second engine on the same directory restores A's session from disk
    b = ServingEngine(CFG, params, **tier)
    b.start()
    try:
        assert b.generate(list(PROMPT_A), GREEDY, timeout=WAIT).tokens == first
        assert b.stats()["durable-restored-hits-total"] >= 1
    finally:
        b.stop()
    # the in-process fleet: a P2P fetch routed by the router, then a move
    c, d = ServingEngine(CFG, params, **KW), ServingEngine(CFG, params, **KW)
    c.start()
    d.start()
    try:
        preamble = PROMPT_A[:32]
        c.generate(preamble + [7, 8, 9], GREEDY, timeout=WAIT)
        router = fleet.FleetRouter(
            [fleet.InProcessReplica("c", c), fleet.InProcessReplica("d", d)],
            refresh_interval_s=3600.0, p2p_threshold=16, lam=256.0)
        router.refresh_all()
        with router._lock:
            other = router._replicas["d"].beacon["load_score"]
            router._replicas["c"].beacon["load_score"] = other + 1.0
        frames = list(router.stream_generate(preamble + [11, 12, 13],
                                             {"max-tokens": 6, "temperature": 0.0}))
        assert frames[-1]["kind"] == "end" and frames[-1]["replica"] == "d", frames[-1]
        assert router.stats()["fleet-p2p-fetch-total"] == 1
        prompt = PROMPT_B
        c.generate(list(prompt), GREEDY, timeout=WAIT)
        fleet.register_local("d", lambda: {}, migrate_bind_fn=lambda fr, t: (
            fleet.engine_migrate_bind(d, fr, t)))
        try:
            ack = fleet.engine_migrate_out(c, {"prompt_tokens": prompt, "dest": "local:d"})
        finally:
            fleet.unregister_local("d")
        assert ack["ok"] and d._prefix_index.deepest_entry(prompt) is not None
    finally:
        c.stop()
        d.stop()
    assert lockorder.deactivate() is REC
    edges = [[a, b, n] for (a, b), n in sorted(REC.edges().items())]
    print(json.dumps({"summary": REC.summary(), "sites": REC.sites(), "edges": edges,
                      "report": REC.report()}))


if __name__ == "__main__":
    main(sys.argv[1])
