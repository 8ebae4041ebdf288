"""The port's streamed load (``langstream_tpu_torch/models/streamload.py``)
and its serving path on the CPU against the JAX package: int8 on load bit
for bit against the port's ``quantize_params`` and JAX's streamed int8,
the host staging bound, loud failures (truncated shards, headers that lie,
the ``weight-load`` fault site through the provider, bad provider keys
with JAX's messages), and the port's provider and engine served from a
checkpoint, token for token against the JAX engine served from the same
directory, with the ``weight-load-*`` stats.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models import loader as jloader
from langstream_tpu.models import streamload as jstream
from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models import streamload
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions, ModelConfig
from langstream_tpu_torch.models.loader import load_params
from langstream_tpu_torch.models.quant import quantize_params
from langstream_tpu_torch.models.streamload import WeightLoadError, load_params_streamed
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from langstream_tpu_torch.serving.faultinject import FaultInjector

torch.backends.cuda.matmul.allow_tf32 = False

GEMMA = dict(name="tiny-gemma", vocab_size=256, d_model=32, n_layers=2, n_heads=4,
             n_kv_heads=1, d_ff=64, activation="gelu", tie_embeddings=True,
             embedding_scale=True)
CONFIGS = {
    "tiny-test": (JAX_PRESETS["tiny-test"], MODEL_PRESETS["tiny-test"]),
    "tiny-gemma": (JaxModelConfig(**GEMMA), ModelConfig(**GEMMA)),
    "tiny-moe-test": (JAX_PRESETS["tiny-moe-test"], MODEL_PRESETS["tiny-moe-test"]),
}
MULTI_SHARD = 20_000


def configs(preset: str, dtype: str = "float32", **fields):
    jcfg, tcfg = CONFIGS[preset]
    return (dataclasses.replace(jcfg, dtype=dtype, **fields),
            dataclasses.replace(tcfg, dtype=dtype, **fields))


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
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), f"{path}: values differ"


def checkpoint(jcfg, path, max_shard_bytes=MULTI_SHARD):
    """A JAX-written checkpoint of a seeded tree; returns the tree (numpy)."""
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jloader.save_params_hf(params, jcfg, path, max_shard_bytes=max_shard_bytes)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantize_on_load_bit_equal(name, dtype, sliced, tmp_path, monkeypatch):
    """int8 on load equals the port's load-then-quantize and JAX's streamed
    int8, scales included: per-layer amax over axis -2 is the stacked one,
    and both cast to the model dtype before quantizing. ``sliced``: every
    quantize and singleton upload in slices of 40 elements' worth of
    rows or columns, as the card slices llama-3-8b's."""
    if sliced:
        monkeypatch.setattr(streamload, "_CHUNK_ELEMS", 40)
    jcfg, tcfg = configs(name)
    checkpoint(jcfg, tmp_path)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    got, report = load_params_streamed(tmp_path, tcfg, workers=3, quantize=True, device="cpu")
    assert report.quantize_on_load
    assert_bit_equal(got, quantize_params(load_params(tmp_path, tcfg, device="cpu"), tcfg))
    ref, _ = jstream.load_params_streamed(tmp_path, dataclasses.replace(jcfg, dtype=dtype),
                                          workers=3, quantize=True)
    assert_bit_equal(got, params_from_numpy(jax.tree.map(np.asarray, ref), tcfg, device="cpu"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sliced_singleton_uploads_bit_equal(name, tmp_path, monkeypatch):
    """The embedding, final norm and head uploaded in slices of HF rows
    land as the eager load places them."""
    monkeypatch.setattr(streamload, "_CHUNK_ELEMS", 40)
    jcfg, tcfg = configs(name, "bfloat16")
    checkpoint(jcfg, tmp_path)
    got, _ = load_params_streamed(tmp_path, tcfg, workers=2, device="cpu")
    assert_bit_equal(got, load_params(tmp_path, tcfg, device="cpu"))


def test_staging_peak_bounded_below_half_of_checkpoint(tmp_path):
    """Host staging holds the readahead window (workers + 1 layers) and one
    singleton buffer, never the tree."""
    jcfg, tcfg = configs("tiny-test", n_layers=8, name="tiny-deep")
    checkpoint(jcfg, tmp_path)
    _, report = load_params_streamed(tmp_path, tcfg, workers=2, device="cpu")
    assert 0 < report.staging_peak_bytes < report.bytes_read / 2


def _truncate_last(path, n):
    victim = sorted(path.glob("*.safetensors"))[-1]
    victim.write_bytes(victim.read_bytes()[:-n])
    return victim


def _rewrite_header(victim, edit):
    data = victim.read_bytes()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    blob = edit(header, data[8 + n:])
    victim.write_bytes(len(blob).to_bytes(8, "little") + blob + data[8 + n:])


def _lie_span(path):
    victim = sorted(path.glob("*.safetensors"))[0]

    def edit(header, _):
        name = next(k for k in header if k != "__metadata__")
        header[name]["shape"] = [d * 2 for d in header[name]["shape"]]
        return json.dumps(header).encode()

    _rewrite_header(victim, edit)
    return victim


def _lie_length(path):
    victim = sorted(path.glob("*.safetensors"))[0]
    data = victim.read_bytes()
    victim.write_bytes((len(data) * 2).to_bytes(8, "little") + data[8:])
    return victim


def _corrupt_json(path):
    victim = sorted(path.glob("*.safetensors"))[-1]
    _rewrite_header(victim, lambda header, _: b"{not json" + b" " * 7)
    return victim


LOUD = {
    "truncated-64-bytes": (lambda p: _truncate_last(p, 64), "truncated"),
    "truncated-one-byte": (lambda p: _truncate_last(p, 1), "truncated"),
    "header-length-lies": (_lie_length, "header claims"),
    "tensor-span-lies": (_lie_span, "spans"),
    "header-not-json": (_corrupt_json, "corrupt"),
}


@pytest.mark.parametrize("case", list(LOUD))
def test_broken_shard_raises_at_index_time(case, tmp_path, monkeypatch):
    """A broken shard raises WeightLoadError naming the shard (and the
    tensor where one is implicated) when the index is built: no tensor is
    read, nothing is uploaded."""
    jcfg, tcfg = configs("tiny-test")
    checkpoint(jcfg, tmp_path)
    damage, words = LOUD[case]
    victim = damage(tmp_path)
    reads = []
    monkeypatch.setattr(streamload._ShardReader, "read_into",
                        lambda self, name, out: reads.append(name))
    with pytest.raises(WeightLoadError, match=words) as exc:
        load_params_streamed(tmp_path, tcfg, workers=2, device="cpu")
    assert victim.name in str(exc.value)
    if case.startswith("truncated") or case == "tensor-span-lies":
        assert "tensor '" in str(exc.value)
    assert reads == []


def test_weight_load_fault_fires_once_and_never_retries(tmp_path):
    jcfg, tcfg = configs("tiny-test")
    checkpoint(jcfg, tmp_path)
    inj = FaultInjector("weight-load@1", seed=0)
    with pytest.raises(WeightLoadError, match="injected weight-load fault") as exc:
        load_params_streamed(tmp_path, tcfg, workers=3, fault_injector=inj, device="cpu")
    assert ".safetensors" in str(exc.value)
    assert inj.stats() == {"weight-load": 1}


# -- through the provider -----------------------------------------------------

PROVIDER = {"model": "tiny-test", "device": "cpu", "max-batch": 4, "max-seq-len": 256,
            "prefill-buckets": [32, 64, 128], "decode-chunk": 4, "page-size": 16}


@pytest.fixture
def f32_presets(monkeypatch):
    """The provider serves presets by name: make tiny-test and
    tiny-moe-test f32 in both packages for token-exact comparisons."""
    for presets in (MODEL_PRESETS, JAX_PRESETS):
        for name in ("tiny-test", "tiny-moe-test"):
            monkeypatch.setitem(presets, name, dataclasses.replace(presets[name],
                                                                   dtype="float32"))


def test_provider_weight_load_fault_leaves_nothing(tmp_path, f32_presets):
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    checkpoint(JAX_PRESETS["tiny-test"], tmp_path)
    svc = TorchCompletionsService({**PROVIDER, "weights": str(tmp_path),
                                   "fault-injection": "weight-load@1", "fault-seed": 0})
    with pytest.raises(WeightLoadError, match="injected weight-load fault") as exc:
        svc.engine()
    assert ".safetensors" in str(exc.value)
    assert svc._engine is None and svc._params is None and svc._weight_load_report is None
    assert svc._fault_injector().stats() == {"weight-load": 1}


BAD_KNOBS = {
    "weight-streaming": "sometimes",
    "weight-load-workers": 0,
    "quantize-on-load": "maybe",
}


@pytest.mark.parametrize("key", list(BAD_KNOBS))
def test_provider_refuses_bad_knobs_with_jax_messages(key):
    from langstream_tpu.ai.tpu_serving import _EngineHolder
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    resource = {"model": "tiny-test", "weights": "random", key: BAD_KNOBS[key]}
    with pytest.raises(ValueError) as jax_error:
        _EngineHolder(resource).params()
    with pytest.raises(ValueError) as ours:
        TorchCompletionsService({**resource, "device": "cpu"})
    assert str(ours.value) == str(jax_error.value)


@pytest.mark.parametrize("key", ["weight-streaming", "quantize-on-load"])
def test_provider_refuses_what_it_does_not_serve(key, tmp_path):
    """The provider always streams, quantizing on load: "off" is refused
    when the service is built, not served by another load path."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    checkpoint(JAX_PRESETS["tiny-test"], tmp_path)
    with pytest.raises(NotImplementedError, match=f"{key}: off is not served"):
        TorchCompletionsService({**PROVIDER, "weights": str(tmp_path), key: "off"})


def test_provider_refuses_a_path_without_shards(tmp_path):
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    with pytest.raises(FileNotFoundError, match="safetensors"):
        TorchCompletionsService({**PROVIDER, "weights": str(tmp_path)})


NEW_TOKENS = 12
PROMPT_LENS = (3, 17, 40, 63, 100)


def prompts(vocab=512):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


def jax_tokens(jcfg, path, quantize=False, submit_first=False):
    """The JAX engine served from the checkpoint directory (its streamed
    load, as its provider loads by default), greedy."""
    params, rep = jstream.load_params_streamed(path, jcfg, workers=2, quantize=quantize)
    engine = JaxEngine(jcfg, params, max_batch=4, max_seq_len=256, decode_chunk=4,
                       prefill_buckets=(32, 64, 128), page_size=16,
                       weight_load_report=rep.as_dict())
    opts = JaxOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
    if not submit_first:
        engine.start()
    reqs = [engine.submit(JaxRequest(prompt_tokens=p, options=opts)) for p in prompts()]
    if submit_first:
        engine.start()
    try:
        return [r.result(timeout=300).tokens for r in reqs]
    finally:
        engine.stop()


def _serve(engine, submit_first=False):
    opts = GenerationOptions(max_new_tokens=NEW_TOKENS, temperature=0.0)
    if not submit_first:
        engine.start()
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=opts)) for p in prompts()]
    if submit_first:
        engine.start()
    try:
        results = [r.result(timeout=300) for r in reqs]
        return [r.tokens for r in results], engine.stats()
    finally:
        engine.stop()


SERVED = {
    # (resource keys beyond PROVIDER, the JAX side's KV dtype / impl)
    "streamed-f32kv": {},
    "streamed-int8kv": {"kv-cache-quantization": "int8", "_impl": "jnp"},
    "streamed-int8-weights": {"quantization": "int8"},
}


@pytest.mark.parametrize("case", list(SERVED))
def test_provider_serves_checkpoint_token_exact_against_jax(case, tmp_path, f32_presets,
                                                           monkeypatch):
    """The provider with ``weights: <dir>`` against the JAX engine loaded
    from the same directory (paged, greedy): the same tokens, and the
    ``weight-load-*`` stats of the load the engine came from."""
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    keys = dict(SERVED[case])
    impl = keys.pop("_impl", "auto")
    for presets in (MODEL_PRESETS, JAX_PRESETS):
        monkeypatch.setitem(presets, "tiny-test",
                            dataclasses.replace(presets["tiny-test"], attention_impl=impl))
    jcfg = JAX_PRESETS["tiny-test"]
    checkpoint(jcfg, tmp_path)
    if keys.get("kv-cache-quantization") == "int8":
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    quantize = keys.get("quantization") == "int8"
    ref = jax_tokens(jcfg, tmp_path, quantize=quantize)
    svc = TorchCompletionsService({**PROVIDER, "weights": str(tmp_path),
                                   "weight-load-workers": 3, **keys})
    try:
        tokens, stats = _serve(svc.engine())
    finally:
        svc.close()
    assert tokens == ref
    assert stats["weight-load-streamed"] is True
    assert stats["weight-load-s"] > 0 and stats["weight-load-bytes-total"] > 0
    assert stats["weight-load-shards"] > 1 and stats["weight-load-workers"] == 3
    assert stats["weight-load-staging-peak-bytes"] > 0
    for key in ("weight-load-read-s", "weight-load-transform-s", "weight-load-transfer-s"):
        assert stats[key] >= 0
    want = load_params(tmp_path, svc.model_config, device="cpu")
    assert_bit_equal(svc.params(), quantize_params(want, svc.model_config) if quantize else want)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_moe_engine_served_from_checkpoint_token_exact(kv, tmp_path):
    """tiny-moe-test streamed from the checkpoint into the port's engine,
    every request submitted before start() on both engines (MoE rows share
    the experts' capacity), against the JAX engine over the same dir."""
    impl = "jnp" if kv == "int8" else "auto"
    jcfg, tcfg = configs("tiny-moe-test", kv_cache_dtype=kv, attention_impl=impl)
    checkpoint(jcfg, tmp_path)
    ref = jax_tokens(jcfg, tmp_path, submit_first=True)
    params, report = load_params_streamed(tmp_path, tcfg, workers=2, block=False, device="cpu")
    engine = ServingEngine(tcfg, params, device="cpu", max_batch=4, max_seq_len=256,
                           decode_chunk=4, prefill_buckets=(32, 64, 128), page_size=16,
                           weight_load_report=report)
    tokens, stats = _serve(engine, submit_first=True)
    assert tokens == ref
    assert stats["weight-load-streamed"] is True and stats["weight-load-workers"] == 2
    assert engine.memory_plan.weights_bytes == sum(
        x.numel() * x.element_size() for _, x in leaves(params))
    assert engine.memory_plan.page_pool_bytes == engine._pagepool.bytes_total


def test_provider_with_hf_tokenizer_serves_text(tmp_path, f32_presets):
    """A checkpoint and an HF tokenizer directory, both local: a chat
    completion streams text back through the port's provider."""
    import asyncio

    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    from langstream_tpu_torch.ai.provider import ChatMessage
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(["user: hello there", "assistant: hi"] * 4, vocab_size=280,
                            min_frequency=1, special_tokens=["<s>", "</s>"])
    PreTrainedTokenizerFast(tokenizer_object=bpe._tokenizer, bos_token="<s>",
                            eos_token="</s>").save_pretrained(str(tmp_path / "tok"))
    checkpoint(JAX_PRESETS["tiny-test"], tmp_path / "ckpt")
    svc = TorchCompletionsService({**PROVIDER, "weights": str(tmp_path / "ckpt"),
                                   "tokenizer": f"hf:{tmp_path / 'tok'}"})
    chunks = []
    try:
        result = asyncio.run(svc.get_chat_completions(
            [ChatMessage(role="user", content="hello")], {"max-tokens": 6}, chunks.append))
    finally:
        svc.close()
    assert result.completion_tokens <= 6 and result.finish_reason in ("length", "stop")
    assert chunks and chunks[-1].last
    assert "".join(c.content for c in chunks) == result.content
