"""The port's checkpoint path on the CPU against the JAX package's: the
safetensors reader and writer of ``langstream_tpu_torch/models/loader.py``
(no ``safetensors`` package on the port's side), the eager and streamed
loads of a checkpoint the JAX writer made, the port's checkpoints read back
by the JAX loader and by the ``safetensors`` package, the shape checks,
the HF tokenizer (built offline with ``tokenizers``) and the serving
memory plan against the JAX plan.

Every comparison of weights is bit for bit (``torch.equal`` with the same
dtype): the port runs the same transforms in the same order as the JAX
loader, so any tolerance would hide a real divergence.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models import loader as jloader
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.models import loader
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, ModelConfig
from langstream_tpu_torch.models.streamload import WeightLoadError, load_params_streamed

GEMMA = dict(name="tiny-gemma", vocab_size=256, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=1, d_ff=64, activation="gelu", tie_embeddings=True,
             embedding_scale=True)
CONFIGS = {
    "tiny-test": (JAX_PRESETS["tiny-test"], MODEL_PRESETS["tiny-test"]),
    "tiny-gemma": (JaxModelConfig(**GEMMA), ModelConfig(**GEMMA)),
    "tiny-moe-test": (JAX_PRESETS["tiny-moe-test"], MODEL_PRESETS["tiny-moe-test"]),
}
# small enough that every tiny config splits into several shards
MULTI_SHARD = 20_000


def configs(name: str, dtype: str):
    jcfg, tcfg = CONFIGS[name]
    return dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype)


def leaves(tree, path="params"):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from leaves(value, f"{path}.{key}")
    else:
        yield path, tree


def assert_bit_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype, f"{path}: {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{path}: {tuple(g.shape)} != {tuple(w.shape)}"
        assert torch.equal(g, w), f"{path}: values differ"


def jax_checkpoint(jcfg, path, max_shard_bytes):
    """A checkpoint the JAX writer made from a seeded tree, and that tree."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jloader.save_params_hf(params, jcfg, path, max_shard_bytes=max_shard_bytes)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("load", ["eager", "streamed"])
@pytest.mark.parametrize("shard_bytes", [None, MULTI_SHARD], ids=["single-file", "multi-shard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_checkpoint_loads_bit_equal(name, dtype, shard_bytes, load, tmp_path):
    """A checkpoint the JAX writer made loads, eager and streamed, into the
    exact tree the bridge makes of the JAX params."""
    jcfg, tcfg = configs(name, dtype)
    tree = jax_checkpoint(jcfg, tmp_path, shard_bytes)
    files = sorted(tmp_path.glob("*.safetensors"))
    assert len(files) == 1 if shard_bytes is None else len(files) > 1
    if load == "eager":
        got = loader.load_params(tmp_path, tcfg, device="cpu")
    else:
        got, report = load_params_streamed(tmp_path, tcfg, workers=3, device="cpu")
        assert report.streamed and report.blocked and report.shards == len(files)
        assert report.bytes_read > 0 and report.total_s > 0
    assert_bit_equal(got, params_from_numpy(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("shard_bytes", [None, MULTI_SHARD], ids=["single-file", "multi-shard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_checkpoint_reads_in_jax_and_safetensors(name, dtype, shard_bytes, tmp_path):
    """The port's writer: the JAX loader reads its checkpoint back into the
    tree it came from, and the ``safetensors`` package reads each of its
    files into the same tensors the JAX writer's files hold."""
    from safetensors import numpy as st_numpy

    jcfg, tcfg = configs(name, dtype)
    tree = jax_checkpoint(jcfg, tmp_path / "jax", shard_bytes)
    loader.save_params_hf(params_from_numpy(tree, tcfg, device="cpu"), tcfg, tmp_path / "port",
                          max_shard_bytes=shard_bytes)
    back = jax.tree.map(np.asarray, jloader.load_params(tmp_path / "port", jcfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = [p.name for p in sorted((tmp_path / "jax").iterdir())]
    assert names == [p.name for p in sorted((tmp_path / "port").iterdir())]
    for fname in names:
        if not fname.endswith(".safetensors"):
            continue
        ours = st_numpy.load_file(str(tmp_path / "port" / fname))
        theirs = st_numpy.load_file(str(tmp_path / "jax" / fname))
        assert set(ours) == set(theirs)
        for key, value in theirs.items():
            assert ours[key].dtype == value.dtype and np.array_equal(ours[key], value), key


def test_writer_pads_the_header_as_safetensors_does(tmp_path):
    """The header is JSON padded with spaces to a multiple of 8 bytes, and
    the data section holds exactly the tensors' bytes."""
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    y = torch.ones(3, dtype=torch.float32)
    items = [("x", x.dtype, tuple(x.shape), lambda: x), ("y", y.dtype, (3,), lambda: y)]
    n = loader.write_safetensors(tmp_path / "a.safetensors", items)
    data = (tmp_path / "a.safetensors").read_bytes()
    assert n == len(data)
    header_len = int.from_bytes(data[:8], "little")
    assert header_len % 8 == 0 and data[8:8 + header_len].rstrip(b" ").endswith(b"}")
    assert len(data) == 8 + header_len + x.numel() * 2 + y.numel() * 4
    raw = loader.load_raw_tensors(tmp_path / "a.safetensors")
    assert torch.equal(raw["x"], x) and torch.equal(raw["y"], y)


@pytest.mark.parametrize("load", ["eager", "streamed"])
def test_shape_mismatch_rejected(load, tmp_path):
    jcfg, tcfg = configs("tiny-test", "float32")
    jax_checkpoint(jcfg, tmp_path, None)
    wrong = dataclasses.replace(tcfg, d_ff=256)
    with pytest.raises(ValueError, match="does not match config"):
        if load == "eager":
            loader.load_params(tmp_path, wrong, device="cpu")
        else:
            load_params_streamed(tmp_path, wrong, device="cpu")


@pytest.mark.parametrize("load", ["eager", "streamed"])
def test_missing_tensor_named(load, tmp_path):
    """A config deeper than the checkpoint: eager raises KeyError (as the
    JAX eager loader), streamed WeightLoadError (as the JAX streamed one),
    both naming the first missing layer's tensor."""
    jcfg, tcfg = configs("tiny-test", "float32")
    jax_checkpoint(jcfg, tmp_path, MULTI_SHARD)
    deeper = dataclasses.replace(tcfg, n_layers=4)
    if load == "eager":
        with pytest.raises(KeyError, match="layers.2"):
            loader.load_params(tmp_path, deeper, device="cpu")
    else:
        with pytest.raises(WeightLoadError, match="layers.2"):
            load_params_streamed(tmp_path, deeper, device="cpu")


def test_no_safetensors_or_ml_dtypes_needed(monkeypatch, tmp_path):
    """The port writes and loads (eager, streamed, int8 on load) with both
    packages made unimportable."""
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    from langstream_tpu_torch.models.bridge import init_params

    _, tcfg = configs("tiny-test", "bfloat16")
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    loader.save_params_hf(params, tcfg, tmp_path, max_shard_bytes=MULTI_SHARD)
    assert_bit_equal(loader.load_params(tmp_path, tcfg, device="cpu"), params)
    streamed, _ = load_params_streamed(tmp_path, tcfg, workers=2, device="cpu")
    assert_bit_equal(streamed, params)
    q, _ = load_params_streamed(tmp_path, tcfg, quantize=True, device="cpu")
    assert q["layers"]["wq"]["q"].dtype == torch.int8


# -- the HF tokenizer ---------------------------------------------------------

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "streaming gen-ai pipelines", "héllo wörld ✓"]


@pytest.fixture(scope="module")
def hf_tokenizer_dir(tmp_path_factory):
    """A byte-level BPE tokenizer trained on a few lines and saved with
    ``PreTrainedTokenizerFast.save_pretrained``: nothing is downloaded."""
    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(TEXTS * 4, vocab_size=300, min_frequency=1,
                            special_tokens=["<s>", "</s>"])
    fast = PreTrainedTokenizerFast(tokenizer_object=bpe._tokenizer, bos_token="<s>",
                                   eos_token="</s>")
    path = tmp_path_factory.mktemp("hf-tokenizer")
    fast.save_pretrained(str(path))
    return path


def test_hf_tokenizer_round_trips_text(hf_tokenizer_dir):
    from langstream_tpu.serving.tokenizer import get_tokenizer as jax_get_tokenizer
    from langstream_tpu_torch.serving.tokenizer import HFTokenizer, get_tokenizer

    tok = get_tokenizer(f"hf:{hf_tokenizer_dir}")
    ref = jax_get_tokenizer(f"hf:{hf_tokenizer_dir}")
    assert isinstance(tok, HFTokenizer)
    assert tok.eos_token_id == ref.eos_token_id is not None
    assert tok.vocab_size == ref.vocab_size <= 300
    for text in TEXTS + ["unseen words: zebra 42"]:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == text
        assert tok.decode_stream_prefix(ids) == text


def test_hf_tokenizer_without_transformers_raises(monkeypatch, hf_tokenizer_dir):
    from langstream_tpu_torch.serving.tokenizer import get_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        get_tokenizer(f"hf:{hf_tokenizer_dir}")
    with pytest.raises(ValueError, match="hf:<path>"):
        get_tokenizer("sentencepiece")


# -- the serving memory plan --------------------------------------------------

PLAN_CASES = {
    "tiny-paged": ("tiny-test", dict(max_batch=4, max_seq_len=256, kv_layout="paged",
                                     page_size=16, kv_pages=70)),
    "tiny-paged-spec-int8kv": ("tiny-test", dict(max_batch=4, max_seq_len=256,
                                                 kv_layout="paged", page_size=16,
                                                 speculation_tokens=4, int8_kv=True)),
    "tiny-dense": ("tiny-test", dict(max_batch=4, max_seq_len=256, kv_layout="dense")),
    "moe-dense-int8w": ("tiny-moe-test", dict(max_batch=2, max_seq_len=128,
                                              kv_layout="dense", quantized_weights=True)),
    "llama-paged": ("llama-3-8b", dict(max_batch=8, max_seq_len=2048, kv_layout="paged",
                                       page_size=64, speculation_tokens=4)),
    "llama-dense-int8": ("llama-3-8b", dict(max_batch=8, max_seq_len=8192, kv_layout="dense",
                                            quantized_weights=True, int8_kv=True)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_memory_plan_matches_jax_on_shared_terms(case):
    """Weights, the admit group's local cache and the verify chunk equal the
    JAX plan's; the port's pool is the JAX pool of one more page (the sink
    page), its dense cache the JAX cache of one more column (the sink
    column). Shapes only: nothing is allocated."""
    from langstream_tpu.serving.memory import plan_serving_memory as jax_plan
    from langstream_tpu_torch.serving.memory import plan_serving_memory
    from langstream_tpu_torch.serving.pagepool import pages_for_fraction

    name, kw = PLAN_CASES[case]
    kw = dict(kw)
    int8_kv = kw.pop("int8_kv", False)
    jcfg, tcfg = JAX_PRESETS[name], MODEL_PRESETS[name]
    if int8_kv:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    common = dict(kw, prefill_batch=8, prefill_bucket=128)
    ours = plan_serving_memory(tcfg, **common)
    b, t = kw["max_batch"], kw["max_seq_len"]
    if kw["kv_layout"] == "paged":
        pages = kw.get("kv_pages") or pages_for_fraction(b, t, kw["page_size"])
        ref = jax_plan(jcfg, **dict(common, kv_pages=pages + 1))
        assert ours.page_pool_bytes == ref.page_pool_bytes > 0
        assert ours.cache_bytes == ours.long_cache_bytes == 0
    else:
        ref = jax_plan(jcfg, **dict(common, max_seq_len=t + 1))
        assert ours.cache_bytes == ref.cache_bytes > 0
        assert ours.page_pool_bytes == 0
        long_ref = jax_plan(jcfg, **common)  # the local caches are max_seq_len wide
        assert ours.long_cache_bytes == long_ref.long_cache_bytes
    same = jax_plan(jcfg, **common)
    assert ours.weights_bytes == same.weights_bytes > 0
    assert ours.fused_prefill_bytes == same.fused_prefill_bytes > 0
    assert ours.verify_chunk_bytes == same.verify_chunk_bytes
    assert (ours.verify_chunk_bytes > 0) == ("speculation_tokens" in kw)
    assert ours.total_bytes > ours.weights_bytes


def test_memory_plan_counts_the_real_tree_and_staging():
    """Given the tree itself, the weights term is its bytes; the load's
    staging peak shows in the summary and stays out of the device total."""
    from langstream_tpu_torch.models.bridge import init_params
    from langstream_tpu_torch.serving.memory import max_context_single_chip, plan_serving_memory

    cfg = dataclasses.replace(MODEL_PRESETS["tiny-test"], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    plan = plan_serving_memory(cfg, 2, 64, params=params, workspace_bytes=0)
    assert plan.weights_bytes == sum(x.numel() * 4 for _, x in leaves(params))
    staged = plan_serving_memory(cfg, 2, 64, params=params, workspace_bytes=0,
                                 weight_load_staging=12345)
    assert staged.total_bytes == plan.total_bytes
    assert "weight-load staging" in staged.summary()
    llama = dataclasses.replace(MODEL_PRESETS["llama-3.1-8b"], kv_cache_dtype="int8")
    assert max_context_single_chip(llama, 1, 80 * 10**9) >= 32768
    assert max_context_single_chip(llama, 1, 4 * 1024**3) == 0  # int8 weights alone: ~8 GiB
