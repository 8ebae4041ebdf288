"""Tensor parallelism of the port on the CPU: spawned ranks over gloo
(``torch_spmd_worker.py``), each holding its slices of one f32 tiny-test /
tiny-moe-test tree, held against the JAX package's single-device model —
the counterparts of ``tests/test_parallel.py``. Logits within 2e-4 (the
JAX tests' tolerance: the all-reduce sums partial products in another
order); greedy engine tokens equal. Also: ``shard_params`` against the
JAX ``param_specs`` slices, mesh coordinates against the JAX device array,
and the kernels' launch plans at a TP-2 rank of llama-3-8b."""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import forward as jax_forward
from langstream_tpu.models.transformer import init_params as jax_init_params
from torch_spmd_worker import spawn

TOL = 2e-4


def jax_tree(name: str, **over):
    cfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32", **over)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def dump(tmp_path, tree, name="params"):
    path = tmp_path / f"{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tree), f)
    return str(path)


RUNS = {
    # name: (model, axes, overrides, engine layouts run on the same ranks)
    "model2": ("tiny-test", {"model": 2}, {}, ("paged", "dense")),
    # 4 kv heads over 8 ranks: the kv-head fallback
    "model8": ("tiny-test", {"model": 8}, {}, ("paged",)),
    "expert4-model2": ("tiny-moe-test", {"expert": 4, "model": 2},
                       {"moe_capacity_factor": 0.0}, ()),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn a mesh: the forward job and the engine jobs on the same
    ranks, one after the other → name → (forward result, {layout: engine
    result}, JAX params, JAX config, the prompt tokens)."""
    cache = {}

    def get(name):
        if name not in cache:
            model, axes, over, layouts = RUNS[name]
            tmp = tmp_path_factory.mktemp(name)
            jcfg, jp = jax_tree(model, **over)
            tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                                   jcfg.vocab_size), np.int64)
            jobs = [{"kind": "forward", "tokens": tokens}]
            jobs += [_engine_job(layout) for layout in layouts]
            job = {"name": name, "kind": "multi", "model": model, "axes": axes,
                   "overrides": dict(over, dtype="float32"), "params": dump(tmp, jp),
                   "jobs": jobs}
            out = spawn(job, int(np.prod(list(axes.values()))), tmp)
            cache[name] = (out[0], dict(zip(layouts, out[1:])), jp, jcfg, tokens)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_forward_matches_jax_single_device(ranks, name):
    fwd, _, jp, jcfg, tokens = ranks(name)
    want = np.asarray(jax_forward(jp, tokens, jcfg))
    np.testing.assert_allclose(fwd["logits"], want, rtol=TOL, atol=TOL)


def test_shard_params_match_jax_param_specs():
    """Every leaf's slice on every rank of {model: 2} (and the MoE tree's on
    {expert: 4, model: 2}) equals the JAX NamedSharding's shard of it; the
    kv-head fallback at {model: 8} keeps the kv head a rank's queries read."""
    from jax.sharding import Mesh, NamedSharding

    from langstream_tpu.parallel.sharding import param_specs as jax_specs
    from langstream_tpu_torch.models.bridge import params_from_numpy
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh as PortMesh, rank_coords
    from langstream_tpu_torch.parallel.sharding import param_specs, shard_params

    for name, axes in (("tiny-test", {"model": 2}), ("tiny-moe-test", {"expert": 4, "model": 2})):
        jcfg, jp = jax_tree(name)
        cfg = dataclasses.replace(MODEL_PRESETS[name], dtype="float32")
        specs = jax_specs(jcfg)
        assert jax.tree.map(tuple, specs, is_leaf=lambda x: hasattr(x, "_normalized_spec") or
                            type(x).__name__ == "PartitionSpec") == param_specs(cfg)
        sizes = [axes.get(a, 1) for a in AXIS_ORDER]
        world = int(np.prod(sizes))
        jmesh = Mesh(np.array(jax.devices()[:world]).reshape(sizes), AXIS_ORDER)
        tree = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        flat_specs = dict(jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0])
        for rank in range(world):
            mesh = PortMesh(shape=dict(zip(AXIS_ORDER, sizes)), rank=rank, world=world,
                            coords=rank_coords(rank, axes))
            mine = shard_params(tree, mesh, cfg)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
                shard = jax.device_put(leaf, NamedSharding(jmesh, flat_specs[path]))
                dev = jmesh.devices.reshape(-1)[rank]
                want = next(np.asarray(s.data) for s in shard.addressable_shards
                            if s.device == dev)
                node = mine
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(node.numpy(), want, err_msg=f"{name} {path}")
    # the fallback: 8 query heads over 8 ranks read 4 kv heads, two ranks a head
    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    _, jp = jax_tree("tiny-test")
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    hd = cfg.resolved_head_dim
    for rank in range(8):
        mesh = PortMesh(shape={"data": 1, "expert": 1, "seq": 1, "model": 8}, rank=rank,
                        world=8, coords=rank_coords(rank, {"model": 8}))
        wk = shard_params(tree, mesh, cfg)["layers"]["wk"].numpy()
        kv = rank // 2
        np.testing.assert_array_equal(wk, np.asarray(jp["layers"]["wk"])[..., kv * hd:(kv + 1) * hd])


@pytest.mark.parametrize("axes", [{"model": 8}, {"expert": 4, "model": 2}, {"data": 2},
                                  {"data": 2, "expert": 2, "model": 2}],
                         ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_rank_coords_match_jax_device_array(axes):
    """Rank r sits where device r sits in the JAX mesh of the same axes."""
    from langstream_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from langstream_tpu_torch.parallel.mesh import AXIS_ORDER, rank_coords

    jmesh = jax_build_mesh(axes)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(ids.size):
        coords = rank_coords(rank, axes)
        assert ids[tuple(coords[a] for a in AXIS_ORDER)] == jax.devices()[rank].id


def test_serving_cache_specs_match_jax():
    from langstream_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from langstream_tpu.parallel.sharding import page_pool_specs as jax_pool_specs
    from langstream_tpu.parallel.sharding import serving_cache_specs as jax_cache_specs
    from langstream_tpu_torch.parallel.sharding import page_pool_specs, serving_cache_specs

    for axes in ({"model": 2}, {"model": 8}, {"data": 2}):
        jmesh = jax_build_mesh(axes)
        shape = {"data": 1, "expert": 1, "seq": 1, **axes}
        port = type("M", (), {"shape": shape})()
        for hkv in (1, 4, 8):
            want = {k: tuple(v) for k, v in jax_cache_specs(hkv, jmesh).items()}
            assert serving_cache_specs(hkv, port) == want
            assert page_pool_specs(hkv, port) == tuple(jax_pool_specs(hkv, jmesh))


def test_local_config_and_launch_plans_at_tp2_llama_shapes():
    """A TP-2 rank of llama-3-8b runs the attention kernels at H 16, Hkv 4,
    D 128: the decode and segment launch plans take those counts."""
    from langstream_tpu_torch.models.configs import MODEL_PRESETS
    from langstream_tpu_torch.ops.attention import decode_launch_plan, segment_launch_plan
    from langstream_tpu_torch.parallel.sharding import local_config

    cfg = MODEL_PRESETS["llama-3-8b"]
    mesh = type("M", (), {"shape": {"data": 1, "expert": 1, "seq": 1, "model": 2}})()
    local = local_config(cfg, mesh)
    assert (local.n_heads, local.n_kv_heads, local.resolved_head_dim, local.d_ff) == (
        16, 4, 128, 7168)
    h, hkv, d = local.n_heads, local.n_kv_heads, local.resolved_head_dim

    def strides(shape):
        out, acc = [], 1
        for n in reversed(shape):
            out.insert(0, acc)
            acc *= n
        return tuple(out)

    # prefill (the segment kernel at offset 0): S 1024, B 2
    kv = (2, hkv, 1024, d)
    plan = segment_launch_plan((2, 1024, h, d), kv, strides(kv), torch.bfloat16)
    assert plan["work_items"][1] == hkv
    # a segment of S 2048 at offset 6144 of an 8,192-column cache
    kv = (1, hkv, 8192, d)
    plan = segment_launch_plan((1, 2048, h, d), kv, strides(kv), torch.bfloat16)
    assert plan["work_items"][1] == hkv
    # paged decode, B 8, over a pool of 64-token pages
    pool = (4096, hkv, 64, d)
    plan = decode_launch_plan((8, h, d), pool, strides(pool), torch.bfloat16, "paged",
                              table_width=128)
    assert plan["grid"][:2] == (hkv, 8)


def _engine_job(layout):
    return {
        "kind": "engine", "engine": dict(ENGINE_KW, kv_layout=layout),
        "channel": dict(prefill_batch=4, max_width=128, max_batch=4,
                        table_len=(256 // 16) if layout == "paged" else 0,
                        decode_chunk=4, echo=True),
        "prompts": PROMPTS, "new_tokens": NEW,
    }


ENGINE_KW = dict(max_batch=4, max_seq_len=256, decode_chunk=4, prefill_buckets=(32, 64, 128),
                 page_size=16, prefill_batch=4)
_rng = np.random.default_rng(3)
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (5, 19, 44, 70, 150)]
NEW = 8


_JAX_TOKENS: dict = {}


def jax_engine_tokens(jp, jcfg, layout):
    """The JAX single-device engine's greedy tokens (every request submitted
    before ``start()``), once a layout (every mesh serves the same tree)."""
    if layout not in _JAX_TOKENS:
        _JAX_TOKENS[layout] = _jax_engine_tokens(jp, jcfg, layout)
    return _JAX_TOKENS[layout]


def _jax_engine_tokens(jp, jcfg, layout):
    from langstream_tpu.models.configs import GenerationOptions as JaxOptions
    from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
    from langstream_tpu.serving.engine import ServingEngine as JaxEngine

    kw = dict(ENGINE_KW)
    kw.pop("page_size")
    engine = JaxEngine(jcfg, jp, kv_layout=layout, page_size=16, **kw)
    opts = JaxOptions(max_new_tokens=NEW, temperature=0.0)
    reqs = [engine.submit(JaxRequest(prompt_tokens=list(p), options=opts)) for p in PROMPTS]
    engine.start()
    try:
        return [r.result(timeout=300).tokens for r in reqs]
    finally:
        engine.stop()


@pytest.mark.parametrize("name, layout", [
    ("model2", "paged"), ("model2", "dense"), ("model8", "paged"),
], ids=["paged-model2", "dense-model2", "paged-model8"])
def test_tp_engine_greedy_tokens_match_jax(ranks, name, layout):
    """A TP engine on world 2 (both layouts) and world 8 (paged), rank 0
    leading the SPMD wire with echo on: greedy tokens equal the JAX
    single-device engine's on the same weights."""
    _, engines, jp, jcfg, _ = ranks(name)
    got = engines[layout]
    assert got["tokens"] == jax_engine_tokens(jp, jcfg, layout)
    assert got["stats"]["spmd"] and got["stats"]["spmd-announces-total"] > 0
