"""The port's lint suite (``langstream_tpu_torch/analysis/``) checked.

- Held against JAX on the same inputs: JAX's fixtures
  (``tests/fixtures/analysis/``) copied into ``tmp_path`` with
  ``langstream_tpu/`` renamed ``langstream_tpu_torch/`` and ``tests/cover.py``
  renamed ``tests/test_torch_cover.py`` (the port's coverage evidence is its
  own tests only). The port's ``locks``, ``redaction``, ``registry-drift``
  and ``threads`` passes on the copy give the ``(path, line, code)``
  multiset JAX's passes give on the original, up to the rename.
  ``compile_bad.py`` seeds JAX's jit rules, which the port's capture-surface
  pass does not have: on the copy it finds nothing. The one stated
  difference, ``asyncio.to_thread(<thread>.join)`` read as a join, has a
  case of its own.
- The capture-surface pass on fixtures this file writes: an unregistered
  ``torch.cuda.graph`` site, a stale registry row, an ``.item()`` two calls
  below a captured body, ``torch.tensor(3, device=...)`` in a body,
  ``self._tokens_dev = ...`` in a body, and a suppressed CPU-only branch
  that stays quiet — each reported by code and line, and nothing else.
- The whole port tree is clean under ``--strict`` with the empty baseline,
  and JAX's ``--strict`` stays clean; the CLI's exit codes 0, 1 and 2.
- The lock-order recorder: JAX's five recorder units, tagging by frame,
  its summary and cost, and a CPU drill in a subprocess with the recorder
  armed before the port is imported.
"""

import collections
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from langstream_tpu.analysis import run_checks as jax_run_checks
from langstream_tpu_torch.analysis import compile_surface, lockorder, run_checks
from langstream_tpu_torch.analysis.core import (
    BASELINE_FILE,
    apply_baseline,
    load_baseline,
    repo_root_from_here,
)
from langstream_tpu_torch.analysis.lockorder import LockOrderRecorder, _TrackedLock

ROOT = Path(__file__).resolve().parents[1]
JAX_FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
SHARED_PASSES = ("locks", "redaction", "registry-drift", "threads")


def renamed_fixtures(dest: Path) -> Path:
    """JAX's fixture tree under ``dest``, renamed for the port."""
    shutil.copytree(JAX_FIXTURES, dest, ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "langstream_tpu").rename(dest / "langstream_tpu_torch")
    (dest / "tests" / "cover.py").rename(dest / "tests" / "test_torch_cover.py")
    return dest


def multiset(findings, rename: bool = False) -> collections.Counter:
    out = collections.Counter()
    for f in findings:
        path = f.path
        if rename and path.startswith("langstream_tpu/"):
            path = "langstream_tpu_torch/" + path[len("langstream_tpu/"):]
        out[(path, f.line, f.code)] += 1
    return out


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    return renamed_fixtures(tmp_path_factory.mktemp("analysis") / "root")


# -- held against JAX on the same inputs -----------------------------------------


@pytest.mark.parametrize("name", SHARED_PASSES)
def test_shared_pass_gives_jax_findings_on_renamed_fixtures(fixture_copy, name):
    _, jax_findings = jax_run_checks(str(JAX_FIXTURES), only=[name])
    _, port_findings = run_checks(str(fixture_copy), only=[name])
    want = multiset(jax_findings, rename=True)
    assert want, f"JAX's {name} pass finds nothing on its fixtures"
    assert multiset(port_findings) == want


def test_fixture_copy_leaves_the_jax_fixtures_untouched(fixture_copy):
    assert (JAX_FIXTURES / "langstream_tpu" / "locks_bad.py").is_file()
    assert (JAX_FIXTURES / "tests" / "cover.py").is_file()
    assert not (JAX_FIXTURES / "langstream_tpu_torch").exists()
    assert sorted(p.name for p in (fixture_copy / "langstream_tpu_torch").rglob("*.py")) == \
        sorted(p.name for p in (JAX_FIXTURES / "langstream_tpu").rglob("*.py"))


def test_jax_jit_fixture_is_not_the_ports_capture_surface(fixture_copy):
    """``compile_bad.py`` seeds ``jax.jit`` rules; the port's pass of that
    name lints CUDA-graph captures and finds nothing there."""
    _, jax_findings = jax_run_checks(str(JAX_FIXTURES), only=["compile-surface"])
    assert {f.code for f in jax_findings} == {"LSA301", "LSA302", "LSA303"}
    _, port_findings = run_checks(str(fixture_copy), only=["compile_surface"])
    assert port_findings == []


TO_THREAD = '''\
import asyncio
import threading


class AsyncServer:
    def __init__(self):
        self._thread = threading.Thread(target=print, daemon=True)

    async def stop(self):
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join)
            self._thread = None


async def scoped():
    t = threading.Thread(target=print, daemon=False)
    t.start()
    await asyncio.to_thread(t.join, 5.0)


class NeverJoined:
    def __init__(self):
        self._thread = threading.Thread(target=print, daemon=True)

    async def stop(self):
        await asyncio.to_thread(print, self._thread)
'''


def test_to_thread_join_is_a_join_for_the_port_only(tmp_path):
    """The one reading wider than JAX's: ``await asyncio.to_thread(t.join)``
    joins ``t``. JAX's pass flags both joined threads; the port's flags only
    the thread no one joins."""
    for pkg in ("langstream_tpu", "langstream_tpu_torch"):
        path = tmp_path / pkg / "fake_rest.py"
        path.parent.mkdir(parents=True)
        path.write_text(TO_THREAD)
    _, jax_findings = jax_run_checks(str(tmp_path), only=["threads"])
    _, port_findings = run_checks(str(tmp_path), only=["threads"])
    assert sorted((f.line, f.code) for f in jax_findings) == [
        (7, "LSA502"), (16, "LSA502"), (23, "LSA502")]
    assert [(f.path, f.line, f.code) for f in port_findings] == [
        ("langstream_tpu_torch/fake_rest.py", 23, "LSA502")]


# -- the capture surface -----------------------------------------------------------

ENGINE = '''\
import torch

from langstream_tpu_torch.serving.helpers import step


class _CudaGraph:
    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, fn):
        with torch.cuda.graph(self.graph, pool=self.pool):
            fn()


class ServingEngine:
    def _alloc_decode_state(self):
        self._tokens_dev = torch.zeros(8, dtype=torch.long, device=self.device)
        self._positions_dev = torch.zeros(8, dtype=torch.long, device=self.device)

    def _decode_chunk(self, samples, filters):
        nxt = step(self._tokens_dev)
        scale = torch.tensor(3, device=self.device)
        self._positions_dev += 1
        self._tokens_dev = nxt * scale
        self._tokens_dev.copy_(self._advance(nxt))

    def _advance(self, tokens):
        if tokens.device.type == "cpu":
            return tokens + tokens.sum().item()  # lstpu: ignore[LSA302] — CPU only
        return tokens + 1
'''
HELPERS = '''\
def step(tokens):
    return _inner(tokens)


def _inner(tokens):
    if tokens.max().item() > 100:
        return tokens * 0
    return tokens
'''
OTHER = '''\
import torch


def warm(fn):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g
'''


def capture_tree(root: Path, other: bool = True) -> Path:
    serving = root / "langstream_tpu_torch" / "serving"
    serving.mkdir(parents=True)
    (serving / "engine.py").write_text(ENGINE)
    (serving / "helpers.py").write_text(HELPERS)
    if other:
        (serving / "other.py").write_text(OTHER)
    return root


def test_capture_surface_reports_each_seeded_fault_and_nothing_else(tmp_path):
    _, findings = run_checks(str(capture_tree(tmp_path)), only=["compile_surface"])
    assert sorted((f.path, f.line, f.code) for f in findings) == [
        # _verify_chunk is registered but gone: a stale row
        ("langstream_tpu_torch/serving/engine.py", 1, "LSA301"),
        ("langstream_tpu_torch/serving/engine.py", 23, "LSA302"),  # torch.tensor(3, ...)
        ("langstream_tpu_torch/serving/engine.py", 25, "LSA303"),  # self._tokens_dev =
        ("langstream_tpu_torch/serving/helpers.py", 6, "LSA302"),  # .item() two calls below
        ("langstream_tpu_torch/serving/other.py", 5, "LSA301"),  # unregistered sites
        ("langstream_tpu_torch/serving/other.py", 6, "LSA301"),
    ]
    by_line = {(f.path.rsplit("/", 1)[-1], f.line): f.message for f in findings}
    assert "_verify_chunk" in by_line[("engine.py", 1)]
    assert "_decode_chunk -> step -> _inner" in by_line[("helpers.py", 6)]
    # the augmented add (line 24) writes in place; the suppressed CPU-only
    # .item() (line 30) stays quiet; _alloc_decode_state binds both buffers


def test_capture_registry_counts_drift_and_stale_modules(tmp_path):
    root = capture_tree(tmp_path, other=False)
    engine = root / "langstream_tpu_torch" / "serving" / "engine.py"
    pool = "        self.pool = pool\n"
    engine.write_text(ENGINE.replace(pool, pool + "        self.g2 = torch.cuda.CUDAGraph()\n"))
    _, findings = run_checks(str(root), only=["compile-surface"])
    drift = [f for f in findings if f.code == "LSA301" and f.line != 1]
    assert [(f.line, "3 CUDA-graph site(s)" in f.message) for f in drift] == [(8, True)]
    engine.write_text("class ServingEngine:\n    pass\n")
    _, findings = run_checks(str(root), only=["compile-surface"])
    assert {(f.line, f.code) for f in findings} == {(1, "LSA301")}
    assert any("owns none" in f.message for f in findings)


def test_capture_surface_follows_the_engine_to_its_kernels():
    """On the real tree the walk from each captured body reaches the attention
    wrappers and the kernel build, and the registry's allocator binds the
    chain and output buffers."""
    from langstream_tpu_torch.analysis.core import Repo

    repo = Repo.load(str(ROOT))
    index = compile_surface._Index(repo)
    mod = "langstream_tpu_torch.serving.engine"
    row = compile_surface.CAPTURE_REGISTRY["langstream_tpu_torch/serving/engine.py"]
    buffers = compile_surface._buffers(index.defs[(mod, row["buffers"])])
    assert {"_tokens_dev", "_positions_dev", "_chunk_out", "_verify_out",
            "_table_dev"} <= buffers
    import ast

    for body in row["bodies"]:
        seen, frontier = {(mod, body)}, [(mod, body)]
        for _ in range(compile_surface.REACH_DEPTH):
            nxt = []
            for key in frontier:
                for node in ast.walk(index.defs[key]):
                    if isinstance(node, ast.Call):
                        for t in index.resolve(key[0], key[1], node):
                            if t not in seen:
                                seen.add(t)
                                nxt.append(t)
            frontier = nxt
        assert frontier == [], f"{body} reaches past REACH_DEPTH"
        names = {q for _, q in seen}
        sampler = "sample" if body.endswith("_decode_chunk") else "speculative_verify"
        assert {"ragged_paged_decode_attention", "ragged_paged_decode_attention_int8",
                "ragged_decode_attention", "library", sampler} <= names, body


# -- the whole tree, the CLI --------------------------------------------------------


def test_whole_port_tree_clean_under_all_passes():
    root = repo_root_from_here()
    assert root == str(ROOT)
    assert json.loads((ROOT / BASELINE_FILE).read_text()) == {}
    _, findings = run_checks(root)
    findings, stale = apply_baseline(findings, load_baseline(root))
    assert not findings, "\n".join(f.render() for f in findings)
    assert not stale, f"stale baseline entries: {sorted(stale)}"


def test_cli_exit_codes(fixture_copy):
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def cli(pkg, *args):
        return subprocess.run([sys.executable, "-m", f"{pkg}.analysis", *args],
                              capture_output=True, text=True, env=env, cwd=ROOT)

    clean = cli("langstream_tpu_torch", "--strict")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "lstpu-check: clean" in clean.stderr
    jax_clean = cli("langstream_tpu", "--strict")
    assert jax_clean.returncode == 0, jax_clean.stdout + jax_clean.stderr
    dirty = cli("langstream_tpu_torch", "--root", str(fixture_copy), "--json")
    assert dirty.returncode == 1
    payload = json.loads(dirty.stdout)
    assert payload["summary"]["total"] == len(payload["findings"]) > 0
    assert {f["path"].split("/")[0] for f in payload["findings"]} == {"langstream_tpu_torch"}
    bad = cli("langstream_tpu_torch", "--only", "no-such-pass")
    assert bad.returncode == 2 and "unknown checker" in bad.stderr
    listed = cli("langstream_tpu_torch", "--list")
    assert listed.returncode == 0
    assert listed.stdout.split() == ["locks", "redaction", "compile-surface", "registry-drift",
                                     "threads"]


def test_stale_baseline_fails_strict(tmp_path):
    """A baseline entry the tree no longer uses fails ``--strict`` (exit 1)
    and passes without it: the baseline only ever shrinks."""
    root = tmp_path
    (root / "langstream_tpu_torch").mkdir()
    (root / "langstream_tpu_torch" / "mod.py").write_text("x = 1\n")
    base = root / BASELINE_FILE
    base.parent.mkdir(parents=True, exist_ok=True)
    base.write_text(json.dumps({"langstream_tpu_torch/serving/gone.py::LSA101": 1}))
    args = [sys.executable, "-m", "langstream_tpu_torch.analysis", "--root", str(root)]
    strict = subprocess.run(args + ["--strict"], capture_output=True, text=True, cwd=ROOT)
    assert strict.returncode == 1 and "stale baseline" in strict.stderr
    loose = subprocess.run(args, capture_output=True, text=True, cwd=ROOT)
    assert loose.returncode == 0, loose.stderr


# -- the lock-order recorder --------------------------------------------------------


def test_lockorder_cycle_detected():
    rec = LockOrderRecorder()
    a = _TrackedLock(rec, "x.py:1")
    b = _TrackedLock(rec, "y.py:2")
    with a:
        with b:
            pass
    with b:
        with a:  # the inversion — single-threaded, still an edge cycle
            pass
    cycles = rec.cycles()
    assert cycles, "A->B then B->A must be reported"
    assert set(cycles[0][:-1]) == {"x.py:1", "y.py:2"}
    assert "lock-order inversion" in rec.report()


def test_lockorder_consistent_order_is_clean():
    rec = LockOrderRecorder()
    a = _TrackedLock(rec, "x.py:1")
    b = _TrackedLock(rec, "y.py:2")
    for _ in range(3):
        with a:
            with b:
                pass
    assert rec.cycles() == []
    assert rec.report() == ""


def test_lockorder_same_site_self_edge_skipped():
    rec = LockOrderRecorder()
    a1 = _TrackedLock(rec, "x.py:1")
    a2 = _TrackedLock(rec, "x.py:1")  # second INSTANCE, same site
    with a1:
        with a2:
            pass
    assert rec.edges() == {}


def test_lockorder_edges_are_per_thread():
    rec = LockOrderRecorder()
    a = _TrackedLock(rec, "x.py:1")
    b = _TrackedLock(rec, "y.py:2")

    def holder_a():
        with a:
            barrier.wait()
            barrier.wait()

    barrier = threading.Barrier(2)
    t = threading.Thread(target=holder_a, daemon=True)
    t.start()
    barrier.wait()  # thread holds a...
    with b:  # ...but THIS thread holds nothing: no a->b edge
        pass
    barrier.wait()
    t.join(timeout=5)
    assert rec.edges() == {}


def test_lockorder_factory_filters_by_caller():
    rec = LockOrderRecorder()
    rec.install()
    try:
        # this test file is not under langstream_tpu_torch/ — untracked
        plain = threading.Lock()
        assert not isinstance(plain, _TrackedLock)
        # a port module creating a lock now IS tracked
        from langstream_tpu_torch.serving import observability

        fr = observability.FlightRecorder(capacity=8)
        assert isinstance(fr._lock, _TrackedLock)
        fr.record({"t": 0.0})  # acquire/release through the wrapper
        assert rec.cycles() == []
        # a JAX package module creating a lock is not
        from langstream_tpu.serving import observability as jax_observability

        assert not isinstance(jax_observability.FlightRecorder(capacity=8)._lock, _TrackedLock)
    finally:
        rec.uninstall()
    assert not isinstance(threading.Lock(), _TrackedLock)


@pytest.mark.parametrize("filename, tagged", [
    ("/ckout/langstream_tpu_torch/serving/engine.py", "langstream_tpu_torch/serving/engine.py:7"),
    ("/ckout/langstream_tpu/serving/engine.py", None),
    ("/ckout/langstream_tpu_torch/analysis/lockorder.py", None),
    ("/usr/lib/python3.12/queue.py", None),
])
def test_lockorder_tags_by_frame(filename, tagged):
    """A lock made in a frame under ``langstream_tpu_torch/`` is tagged with
    its site; one made under ``langstream_tpu/``, under the port's own
    ``analysis/`` or in the stdlib is a real, untracked lock."""
    assert lockorder.site_of(filename.replace("/", os.sep), 7) == tagged
    rec = LockOrderRecorder()
    rec.install()
    try:
        # line 7 of ``filename`` makes the lock
        code = compile("\n" * 6 + "LOCK = threading.Lock()\n", filename, "exec")
        ns = {"threading": threading}
        exec(code, ns)
    finally:
        rec.uninstall()
    assert isinstance(ns["LOCK"], _TrackedLock) == (tagged is not None)
    assert rec.sites() == ([tagged] if tagged else [])


def test_lockorder_condition_over_a_tracked_lock_records_no_edge():
    """``Condition.notify`` asks ``_is_owned``: on a tracked lock that reads
    the real lock and records no edge (a try-acquire would record one from
    every lock held since)."""
    rec = LockOrderRecorder()
    inner = _TrackedLock(rec, "cond.py:1")
    other = _TrackedLock(rec, "other.py:2")
    cond = threading.Condition(inner)
    with cond:
        with other:
            cond.notify_all()
    assert rec.edges() == {("cond.py:1", "other.py:2"): 1}
    assert rec.cycles() == []


def test_lockorder_summary_and_cost():
    rec = LockOrderRecorder()
    a, b = rec.track("x.py:1"), rec.track("y.py:2")
    with a:
        with b:
            pass
    done = []

    def other():
        with b:
            done.append(1)

    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join(timeout=5)
    assert done == [1]
    assert rec.summary() == {"sites": 2, "locks": 2, "edges": 1, "acquisitions": 3,
                             "cycles": 0}
    cost = lockorder.acquire_cost_ns(1000)
    assert cost["n"] == 1000 and cost["tracked_ns"] > 0 and cost["real_ns"] > 0


def test_lockorder_cpu_drill_has_no_cycle(tmp_path):
    """The recorder armed before the port is imported, across a tiny-test
    paged engine with the fetch thread, a host-tier spill and restore, a
    durable hibernate and a restore from disk, an in-process P2P fetch and
    migration, and a flight dump: no cycle, and at least 20 tracked lock
    sites (the engine's, the pool's, the fleet's, the durable store's, the
    kernel counts')."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_lockorder_drill.py"), str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    doc = json.loads(run.stdout.strip().splitlines()[-1])
    assert doc["report"] == "" and doc["summary"]["cycles"] == 0, doc["report"]
    assert doc["summary"]["sites"] >= 20, doc["sites"]
    assert doc["summary"]["acquisitions"] > 100 and doc["summary"]["edges"] >= 1
    # the engine's capture lock, at whatever line its module puts it
    engine_src = (ROOT / "langstream_tpu_torch" / "serving" / "engine.py").read_text()
    capture_lock = engine_src.splitlines().index("_CAPTURE_LOCK = threading.Lock()") + 1
    for site in (f"serving/engine.py:{capture_lock}", "ops/attention.py:63",
                 "serving/durable.py", "serving/fleet.py:465"):
        assert any(site in s for s in doc["sites"]), (site, doc["sites"])
    assert all(s.startswith("langstream_tpu_torch/") and "/analysis/" not in s
               for s in doc["sites"])


def test_analysis_source_is_written_for_the_port():
    """No module of the port's suite names a path of the JAX package as one
    it scans (the JAX package is named only as what the suite does not
    read)."""
    src = ROOT / "langstream_tpu_torch" / "analysis"
    for path in src.glob("*.py"):
        text = path.read_text()
        assert '"langstream_tpu/' not in text, path.name
