"""Rank bodies for the port's multi-process tests (``test_torch_tp.py``,
``test_torch_spmd.py``, ``test_torch_ring.py``): each spawned process joins a gloo process group
over a ``FileStore`` under the test's ``tmp_path``, builds its mesh and
this rank's slices of a weight tree the parent pickled as numpy, and runs
one job; rank 0 pickles its result for the parent. No fixed port, nothing
outside ``tmp_path``."""

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(job: dict, world: int, tmp_path, timeout_s: float = 240.0):
    """Run ``job`` on ``world`` spawned ranks; rank 0's result."""
    return spawn_async(job, world, tmp_path, timeout_s)()


def spawn_async(job: dict, world: int, tmp_path, timeout_s: float = 240.0):
    """Start ``job`` on ``world`` spawned ranks → a call that waits for
    them and returns rank 0's result (the caller works meanwhile)."""
    store = os.path.join(str(tmp_path), f"store-{job['name']}")
    out = os.path.join(str(tmp_path), f"out-{job['name']}.pkl")
    job = dict(job, out=out)
    ctx = mp.start_processes(_rank, args=(world, store, job), nprocs=world, join=False,
                             start_method="spawn")

    def result():
        while not ctx.join(timeout=timeout_s):
            pass
        with open(out, "rb") as f:
            return pickle.load(f)

    return result


def _rank(rank: int, world: int, store: str, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        result = JOBS[job["kind"]](rank, job)
        dist.barrier()
        if rank == 0:
            with open(job["out"], "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


_MESH: dict = {}


def _setup(job: dict):
    from langstream_tpu_torch.models.bridge import params_from_numpy
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.parallel.mesh import build_mesh
    from langstream_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(MODEL_PRESETS[job["model"]], **job.get("overrides", {}))
    with open(job["params"], "rb") as f:
        tree = pickle.load(f)
    params = params_from_numpy(tree, cfg, device="cpu")
    tp = job["axes"].get("model", 1) * job["axes"].get("expert", 1)
    # device groups only where the weights split or a seq ring runs (a
    # data axis needs none); one mesh a process, shared by the jobs of a
    # "multi" run
    key = tuple(sorted(job["axes"].items()))
    if key not in _MESH:
        groups = tp > 1 or job["axes"].get("seq", 1) > 1
        _MESH[key] = build_mesh(job["axes"], "gloo" if groups else None)
    mesh = _MESH[key]
    return cfg, mesh, shard_params(params, mesh, cfg) if tp > 1 else params


def _forward(rank: int, job: dict):
    from langstream_tpu_torch.models.transformer import forward
    from langstream_tpu_torch.parallel.sharding import local_config, tensor_parallel

    cfg, mesh, params = _setup(job)
    tp = tensor_parallel(mesh, cfg)
    logits = forward(params, torch.from_numpy(job["tokens"]), local_config(cfg, mesh), tp=tp)
    return {"logits": logits.numpy(), "coords": mesh.coords,
            "shapes": {k: tuple(v.shape) for k, v in params["layers"].items()
                       if isinstance(v, torch.Tensor)}}


def _sp_forward(rank: int, job: dict):
    """``sequence_parallel_forward`` (``job["pad"]``: an indivisible length
    first, which must raise) → the logits."""
    from langstream_tpu_torch.parallel.sharding import local_config, tensor_parallel
    from langstream_tpu_torch.parallel.sp import sequence_parallel_forward

    cfg, mesh, params = _setup(job)
    tokens = torch.from_numpy(job["tokens"])
    local = local_config(cfg, mesh)
    tp = tensor_parallel(mesh, cfg)
    try:
        sequence_parallel_forward(params, tokens[:, :-1], local, mesh, tp=tp)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"logits": sequence_parallel_forward(params, tokens, local, mesh, tp=tp).numpy(),
            "indivisible": raised}


def _ring_prefill(rank: int, job: dict):
    """``ring_prefill`` of ``job["tokens"]`` → its logits and every layer's
    K/V, the blocks gathered over the seq axis in position order."""
    from langstream_tpu_torch.parallel.ring_attention import seq_ring
    from langstream_tpu_torch.parallel.sharding import local_config, tensor_parallel
    from langstream_tpu_torch.parallel.sp import ring_prefill

    cfg, mesh, params = _setup(job)
    ring = seq_ring(mesh)
    logits, kv = ring_prefill(params, torch.from_numpy(job["tokens"]),
                              torch.from_numpy(job["lengths"]), local_config(cfg, mesh), mesh,
                              tp=tensor_parallel(mesh, cfg))
    out = {"logits": logits.numpy()}
    for name in ("k", "v"):
        blocks = ring.all_gather(kv[name])  # [n, L, B, Hkv, Sl, D]
        out[name] = torch.cat(list(blocks), dim=3).numpy()
    return out


def _probe(rank: int, job: dict):
    """Build (never start) an engine on the mesh → whether it has a ring
    admit."""
    from langstream_tpu_torch.serving.engine import ServingEngine

    cfg, mesh, params = _setup(job)
    return {"ring_admit": ServingEngine(cfg, params, device="cpu", mesh=mesh,
                                        **job["engine"])._ring_admit}


def _device_state(engine, mesh) -> dict:
    """This rank's decode chain and cache as numpy, with its coordinates."""
    from langstream_tpu_torch.serving.pagepool import pool_leaves

    return {"coords": dict(mesh.coords), "positions": engine._positions_dev.numpy().copy(),
            "tokens": engine._tokens_dev.numpy().copy(),
            "cache": [a.numpy().copy() for a in pool_leaves(engine._cache)]}


def _engine(rank: int, job: dict):
    """Rank 0 leads a serving engine with an SPMD channel over the mesh's
    control group, the other ranks follow it; every prompt is submitted
    before ``start()``. → the greedy tokens and the leader's stats
    (``job["gather_state"]``: and every rank's ``_device_state``, gathered
    over the control group once the followers saw STOP; dense only)."""
    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.parallel.spmd_serving import SpmdChannel, follower_loop
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine

    cfg, mesh, params = _setup(job)
    kw = dict(job["engine"])
    channel = SpmdChannel(group=mesh.control_group, src=0, **job["channel"])
    engine = ServingEngine(cfg, params, device="cpu", mesh=mesh, spmd=channel, **kw)
    if rank != 0:
        follower_loop(engine, channel)
        if job.get("gather_state"):
            dist.all_gather_object([None] * mesh.world, _device_state(engine, mesh),
                                   group=mesh.control_group)
        return None
    opts = GenerationOptions(max_new_tokens=job["new_tokens"], temperature=0.0)
    reqs = [engine.submit(GenerationRequest(prompt_tokens=list(p), options=opts))
            for p in job["prompts"]]
    engine.start()
    try:
        tokens = [r.result(timeout=180).tokens for r in reqs]
        stats = engine.stats()
    finally:
        engine.stop()
    state = {"positions": engine._positions_dev.numpy().copy()}
    out = {"tokens": tokens, "stats": stats, "state": state}
    if job.get("gather_state"):
        states = [None] * mesh.world
        dist.all_gather_object(states, _device_state(engine, mesh), group=mesh.control_group)
        out["states"] = states
    return out


def _tiers(rank: int, job: dict):
    """The agentic and host KV tiers on a multi-rank replica: rank 0 leads
    an engine with an SPMD channel (echo on), the others follow; the
    requests (``job["requests"]``: prompt, adapter, grammar, the spill
    pages to wait for first) are served one at a time, or all submitted
    before ``start()`` (``job["batch"]``). Every rank checks each restored
    page against the arena blocks it was uploaded from (verified against
    their spill-time stamps) and reports its restore counters and memory
    plan; ``job["faults"]`` plants a spec on the leader. → the tokens, the
    leader's stats and every rank's report."""
    import time

    from langstream_tpu_torch.models.configs import GenerationOptions
    from langstream_tpu_torch.parallel.spmd_serving import SpmdChannel, follower_loop
    from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
    from langstream_tpu_torch.serving.faultinject import FaultInjector
    from langstream_tpu_torch.serving.pagepool import pool_leaves

    cfg, mesh, params = _setup(job)
    channel = SpmdChannel(group=mesh.control_group, src=0, **job["channel"])
    injector = FaultInjector(job["faults"]) if rank == 0 and job.get("faults") else None
    engine = ServingEngine(cfg, params, device="cpu", mesh=mesh, spmd=channel,
                           fault_injector=injector, **job["engine"])
    restored: list = []
    upload = engine._restore_pages

    def checked_upload(pages, blocks):
        upload(pages, blocks)
        leaves = pool_leaves(engine._pagepool.dev)
        for page, page_blocks in zip(pages, blocks):
            restored.append(all(torch.equal(leaf[:, int(page)], b)
                                for leaf, b in zip(leaves, page_blocks)))

    engine._restore_pages = checked_upload
    if rank != 0:
        follower_loop(engine, channel)
        out = None
    else:
        def options(r):
            return GenerationOptions(max_new_tokens=r.get("new", job["new_tokens"]),
                                     temperature=0.0, adapter=r.get("adapter"),
                                     response_format=r.get("grammar"))

        def request(r):
            return engine.submit(GenerationRequest(prompt_tokens=list(r["prompt"]),
                                                   options=options(r)))

        try:
            if job.get("batch"):
                reqs = [request(r) for r in job["requests"]]
                engine.start()
                tokens = [q.result(timeout=180).tokens for q in reqs]
            else:
                engine.start()
                tokens = []
                for r in job["requests"]:
                    deadline = time.monotonic() + 60
                    while (engine.stats()["spill-pages-total"] < r.get("wait_spilled", 0)
                           and time.monotonic() < deadline):
                        time.sleep(0.01)
                    tokens.append(request(r).result(timeout=180).tokens)
            stats = engine.stats()
            try:
                engine._migrate_rpc("snapshot", {}, 0.1)
                refused = ""
            except Exception as e:  # noqa: BLE001 — the refusal is the result
                refused = str(e)
        finally:
            engine.stop()
        out = {"tokens": tokens, "stats": stats, "migrate_refused": refused,
               "durable_on": engine._durable_on, "bytes": channel.bytes_announced_total,
               "announces": channel.announces_total, "agreements": channel.agreements_total}
    plan = engine.memory_plan
    report = {"coords": dict(mesh.coords), "restored": restored,
              "restore_failures": engine.restore_failures_total,
              "restore_pages": engine.restore_pages_total,
              "adapter_pool_bytes": plan.adapter_pool_bytes,
              "host_spill_bytes": plan.host_spill_bytes,
              "arena_bytes": engine._host_tier.bytes_total if engine._host_tier else 0,
              "grammar_rows": _grammar_rows(engine), "adapter_rows": _adapter_rows(engine)}
    reports = [None] * mesh.world
    dist.all_gather_object(reports, report, group=mesh.control_group)
    return None if out is None else dict(out, ranks=reports)


def _grammar_rows(engine) -> list:
    """The grammar pool's four planes of every swapped-in row, as bytes."""
    reg = engine._constrain_reg
    if reg is None:
        return []
    rows = sorted(reg._row_owner)
    return [(r, [plane[r].numpy().tobytes() for plane in reg.pool]) for r in rows]


def _adapter_rows(engine) -> list:
    """(row, name) of every resident adapter row."""
    reg = engine._adapters
    return [] if reg is None else sorted((r, s.spec.name) for r, s in reg._row_owner.items())


def _multi(rank: int, job: dict):
    """Several jobs on the same ranks, one after the other (one spawn)."""
    return [JOBS[sub["kind"]](rank, {**job, **sub}) for sub in job["jobs"]]


JOBS = {"forward": _forward, "engine": _engine, "multi": _multi, "sp_forward": _sp_forward,
        "ring_prefill": _ring_prefill, "probe": _probe, "tiers": _tiers}
