"""The port's ``local-vector`` store against the JAX package's, on the CPU.

- ``_TorchSimilarity`` against ``_JitSimilarity`` on the same seeded
  matrices: indices equal, scores within 1e-6 (f32 sums in another
  order), masked rows never returned, ties to the lower row (duplicated
  rows score exactly alike in both).
- The store (``LocalVectorDataSource``, device "cpu") against the JAX one
  fed the same operations: upsert, overwrite in place, growth past 16
  rows, ``fetch_data`` with ``?`` parameters, ``topK`` / ``top-k``,
  ``include-vectors`` placed after the metadata, results equal (scores
  within 1e-6); an index saved by the JAX store loads in the port and
  answers alike, and the port's saved files load in the JAX store.
- The device copy: written through on upsert, reallocated only when the
  capacity doubles.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from langstream_tpu.agents.vector import LocalVectorDataSource as JaxStore
from langstream_tpu.agents.vector import _JitSimilarity
from langstream_tpu_torch.agents.vector import LocalVectorDataSource, _TorchSimilarity

# f32 scores: the products sum in another order than XLA's
SCORE_TOL = 1e-6


def _matrix(rows: int, dim: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(rows, dim)).astype(np.float32)


@pytest.mark.parametrize("rows,dim,k,valid_rows", [
    (16, 8, 5, 16), (64, 32, 10, 40), (128, 16, 128, 100), (32, 4, 3, 1),
], ids=["full", "masked", "k-eq-capacity", "one-valid"])
def test_similarity_matches_jax(rows, dim, k, valid_rows):
    m = _matrix(rows, dim, rows + dim)
    q = np.random.default_rng(1).normal(size=dim).astype(np.float32)
    valid = np.zeros(rows, bool)
    valid[:valid_rows] = True
    js, ji = _JitSimilarity()(q, m, valid, k)
    ts, ti = _TorchSimilarity()(torch.from_numpy(q), torch.from_numpy(m),
                                torch.from_numpy(valid), k)
    js, ji = np.asarray(js), np.asarray(ji)
    finite = np.isfinite(js)
    assert np.array_equal(np.isfinite(ts.numpy()), finite)
    np.testing.assert_array_equal(ti.numpy()[finite], ji[finite])
    np.testing.assert_allclose(ts.numpy()[finite], js[finite], rtol=SCORE_TOL, atol=SCORE_TOL)
    # a masked row is never among the finite results
    assert (ti.numpy()[finite] < valid_rows).all()


def test_similarity_ties_go_to_the_lower_row_as_in_jax():
    """Rows 3, 9 and 14 hold the same vector, the best match: both
    searches return them in row order, then the next best."""
    m = _matrix(16, 8, 7)
    q = np.random.default_rng(2).normal(size=8).astype(np.float32)
    for r in (14, 3, 9):
        m[r] = q * 2.0
    valid = np.ones(16, bool)
    js, ji = _JitSimilarity()(q, m, valid, 4)
    ts, ti = _TorchSimilarity()(torch.from_numpy(q), torch.from_numpy(m),
                                torch.from_numpy(valid), 4)
    assert ti.tolist()[:3] == [3, 9, 14] == np.asarray(ji).tolist()[:3]
    assert ti.tolist() == np.asarray(ji).tolist()
    assert ts[0] == ts[1] == ts[2]


def _ops(seed: int = 0):
    """A sequence of store operations: 40 rows (past 16 and 32: growth),
    overwrites of rows 2 and 17, a second index."""
    rng = np.random.default_rng(seed)
    ops = [("docs", f"d{i}", rng.normal(size=12).astype(np.float32).tolist(),
            {"text": f"chunk {i}", "n": i}) for i in range(40)]
    ops += [("docs", "d2", rng.normal(size=12).astype(np.float32).tolist(), {"text": "new 2"}),
            ("docs", "d17", ops[5][2], {"text": "copy of 5", "vector": "stale"}),
            ("other", "x", [1.0, 0.0, 0.0], {"k": "v"})]
    return ops


def _both(ops, path_j=None, path_t=None):
    jax_store = JaxStore({"path": path_j} if path_j else {})
    port = LocalVectorDataSource({"device": "cpu", **({"path": path_t} if path_t else {})})
    for index, id_, vec, meta in ops:
        jax_store.upsert(index, id_, vec, dict(meta))
        port.upsert(index, id_, vec, dict(meta))
    return jax_store, port


def assert_results_equal(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys in the same order
        assert abs(g["similarity"] - w["similarity"]) <= SCORE_TOL
        assert {k: v for k, v in g.items() if k != "similarity"} == {
            k: v for k, v in w.items() if k != "similarity"}


@pytest.mark.parametrize("top_k,include", [(5, False), (3, True), (64, False)])
def test_store_search_matches_jax(top_k, include):
    jax_store, port = _both(_ops())
    idx, jidx = port._indexes["docs"], jax_store._indexes["docs"]
    assert idx["ids"] == jidx["ids"] and idx["meta"] == jidx["meta"]
    np.testing.assert_array_equal(idx["matrix"], jidx["matrix"])
    assert idx["matrix"].shape[0] == 64 and idx["dev"].shape == (64, 12)
    for seed in range(4):
        q = np.random.default_rng(100 + seed).normal(size=12).astype(np.float32).tolist()
        assert_results_equal(port.search("docs", q, top_k, include),
                             jax_store.search("docs", q, top_k, include))
    # the overwritten row 17 holds row 5's vector: a tie, row 5 first in both
    got = port.search("docs", _ops()[5][2], 2, True)
    assert [r["id"] for r in got] == ["d5", "d17"]
    assert got[1]["vector"] == _ops()[5][2]  # after the metadata's stale "vector"


def test_fetch_data_dialect_matches_jax():
    jax_store, port = _both(_ops())
    q = np.random.default_rng(9).normal(size=12).astype(np.float32).tolist()
    queries = [
        (json.dumps({"index": "docs", "vector": "?", "topK": "?"}), [q, 4]),
        (json.dumps({"index": "?", "vector": q, "top-k": 2, "include-vectors": True}), ["docs"]),
        ({"index": "other", "vector": [0.0, 1.0, 0.5]}, []),
    ]
    for query, params in queries:
        want = asyncio.run(jax_store.fetch_data(query, list(params)))
        got = asyncio.run(port.fetch_data(query, list(params)))
        assert_results_equal(got, want)
    with pytest.raises(ValueError, match="requires a 'vector'"):
        asyncio.run(port.fetch_data(json.dumps({"index": "docs"}), []))
    with pytest.raises(ValueError, match="does not exist"):
        port.search("missing", q)
    with pytest.raises(ValueError, match="index dim"):
        port.upsert("docs", "bad", [1.0, 2.0], {})
    port.create_index("empty", 12)
    assert port.search("empty", q) == [] == jax_store.search("docs", q, 0)


def test_jax_saved_index_loads_in_the_port_and_back(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_store, port = _both(_ops(), path_j=jax_dir, path_t=port_dir)
    jax_store.flush()
    port.flush()
    # the files the two stores write hold the same index
    for name in ("docs", "other"):
        a = np.load(f"{jax_dir}/{name}.npz")["matrix"]
        b = np.load(f"{port_dir}/{name}.npz")["matrix"]
        np.testing.assert_array_equal(a, b)
        assert json.loads(open(f"{jax_dir}/{name}.json").read()) == json.loads(
            open(f"{port_dir}/{name}.json").read())
    loaded = LocalVectorDataSource({"device": "cpu", "path": jax_dir})
    back = JaxStore({"path": port_dir})
    for seed in range(3):
        q = np.random.default_rng(200 + seed).normal(size=12).astype(np.float32).tolist()
        want = jax_store.search("docs", q, 6, True)
        assert_results_equal(loaded.search("docs", q, 6, True), want)
        assert_results_equal(back.search("docs", q, 6, True), want)


def test_device_copy_is_written_through_and_grows_by_doubling():
    store = LocalVectorDataSource({"device": "cpu"})
    store.upsert("d", "a", [3.0, 4.0], {})
    dev = store._indexes["d"]["dev"]
    np.testing.assert_allclose(dev[0].numpy(), [0.6, 0.8], rtol=1e-6)
    for i in range(15):
        store.upsert("d", f"r{i}", [float(i), 1.0], {})
    assert store._indexes["d"]["dev"] is dev  # 16 rows: still the first copy
    store.upsert("d", "a", [0.0, 2.0], {})  # overwrite in place
    np.testing.assert_allclose(dev[0].numpy(), [0.0, 1.0], rtol=1e-6)
    store.upsert("d", "r16", [1.0, 1.0], {})
    grown = store._indexes["d"]["dev"]
    assert grown is not dev and grown.shape == (32, 2)
    np.testing.assert_array_equal(grown[:16].numpy(), dev.numpy())
    # a bulk upsert: new ids appended, an existing id overwritten, the last
    # of a repeated id wins
    store.upsert_many("d", ["r16", "n1", "n1"], np.array([[2, 0], [0, 3], [0, -3]], np.float32),
                      [{"x": 1}, {"y": 2}, {"y": 3}])
    idx = store._indexes["d"]
    assert idx["ids"][-2:] == ["r16", "n1"] and idx["meta"][-1] == {"y": 3}
    np.testing.assert_allclose(idx["dev"][len(idx["ids"]) - 1].numpy(), [0.0, -1.0], rtol=1e-6)
    assert store.search("d", [0.0, -1.0], 1)[0]["id"] == "n1"


def test_store_entry_point_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalVectorDataSource({})
