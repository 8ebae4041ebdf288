"""The embedding model and the embeddings service of the port against the JAX
package, on the CPU.

- ``encode`` within 1e-5 of JAX ``encode`` on the same weights (through
  ``bridge``) and the same seeded tokens: tiny-test in f32, tiny-test with
  int8 weights (``quantize_params`` of the same tree), tiny-moe-test; rows
  of every length from 1 to the padded width.
- The provider: ``TorchServingProvider``'s embeddings service against
  ``TpuServingProvider``'s on the same f32 weights: vectors within 1e-5 of
  JAX's with truncation at ``max-text-tokens``, an empty text, identical
  texts giving the same vector and unit norms (``test_genai.py``'s
  ``test_tpu_embeddings``); the batch's width bucketing; one weight tree
  shared by the completions and the embeddings service; an embedding run
  while the engine of the same provider serves gives the idle vectors.
"""

import asyncio
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ai.tpu_serving import TpuServingProvider
from langstream_tpu.models import quant as jquant
from langstream_tpu.models import transformer as jtf
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu_torch.ai.provider import ChatMessage
from langstream_tpu_torch.ai.torch_serving import TorchEmbeddingsService, TorchServingProvider
from langstream_tpu_torch.models import transformer as ttf
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS

# f32 embeddings: unit vectors, sums in another order than XLA's
EMBED_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def setup(preset: str = "tiny-test", quantized: bool = False):
    """(JAX config, port config, JAX params, port params) in f32."""
    jcfg = dataclasses.replace(JAX_PRESETS[preset], dtype="float32")
    tcfg = dataclasses.replace(MODEL_PRESETS[preset], dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if quantized:
        jp = jquant.quantize_params(jp, jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(seed: int, rows: int = 6, width: int = 16, vocab: int = 512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (rows, width)).astype(np.int32)
    lengths = np.array([1, width, 5, width - 1, 9, 2][:rows], np.int32)
    for i, n in enumerate(lengths):
        tokens[i, n:] = 0
    return tokens, lengths


@pytest.mark.parametrize("preset,quantized", [
    ("tiny-test", False), ("tiny-test", True), ("tiny-moe-test", False),
], ids=["f32", "int8-weights", "moe"])
def test_encode_matches_jax(preset, quantized):
    jcfg, tcfg, jp, tp = setup(preset, quantized)
    for seed, width in ((0, 16), (1, 32)):
        tokens, lengths = _batch(seed, width=width)
        want = np.asarray(jtf.encode(jp, jnp.asarray(tokens), jnp.asarray(lengths), jcfg))
        got = ttf.encode(tp, torch.from_numpy(tokens), torch.from_numpy(lengths), tcfg)
        assert got.dtype == torch.float32 and got.shape == (len(lengths), tcfg.d_model)
        np.testing.assert_allclose(got.numpy(), want, rtol=EMBED_TOL, atol=EMBED_TOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_encode_ignores_padding_and_is_bidirectional():
    """A row's vector depends only on its real tokens (padding of another
    width or value gives the same vector), and the first token sees the
    last (a causal model's first position would not)."""
    _, tcfg, _, tp = setup()
    tokens, lengths = _batch(3, rows=2)
    a = ttf.encode(tp, torch.from_numpy(tokens), torch.from_numpy(lengths), tcfg)
    wide = np.full((2, 32), 7, np.int32)
    wide[:, :16] = tokens
    b = ttf.encode(tp, torch.from_numpy(wide), torch.from_numpy(lengths), tcfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    changed = tokens.copy()
    changed[1, lengths[1] - 1] += 1  # the last real token of row 1
    c = ttf.encode(tp, torch.from_numpy(changed), torch.from_numpy(lengths), tcfg)
    assert not np.allclose(c[1].numpy(), a[1].numpy())


TEXTS = [
    "hello world", "hello world", "different", "",
    "a long text that is cut at the max-text-tokens limit of the step",
    "a long text that is cut at the max-text-tokens limit but ends elsewhere",
]


def _providers(max_text_tokens: int = 24):
    """The JAX and the port provider over the same f32 tiny-test weights,
    and their embeddings services."""
    jcfg, tcfg, jp, tp = setup()
    resource = {"model": "tiny-test", "tokenizer": "byte", "max-seq-len": 64}
    jprov = TpuServingProvider(dict(resource))
    jprov.holder._model_config, jprov.holder._params = jcfg, jp
    tprov = TorchServingProvider({**resource, "device": "cpu", "max-batch": 2,
                                  "decode-chunk": 4})
    tprov.holder.model_config, tprov.holder._params = tcfg, tp
    step = {"max-text-tokens": max_text_tokens}
    return jprov, tprov, jprov.get_embeddings_service(step), tprov.get_embeddings_service(step)


def test_provider_embeddings_match_jax():
    jprov, tprov, jsvc, tsvc = _providers()

    async def both():
        want = await jsvc.compute_embeddings(TEXTS)
        got = await tsvc.compute_embeddings(TEXTS)
        await jprov.close()
        await tprov.close()
        return np.asarray(want), np.asarray(got)

    want, got = asyncio.run(both())
    assert got.shape == (len(TEXTS), 64)
    np.testing.assert_allclose(got, want, rtol=EMBED_TOL, atol=EMBED_TOL)
    np.testing.assert_array_equal(got[0], got[1])  # identical texts
    assert not np.allclose(got[0], got[2])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # both long texts share their first 24 bytes: cut there, the same vector
    np.testing.assert_array_equal(got[4], got[5])


def test_batch_bucketing_and_lengths():
    _, _, _, tsvc = _providers(max_text_tokens=40)
    bos = tsvc.holder.tokenizer.encode("")  # the byte tokenizer's BOS, if any
    tokens, lengths = tsvc.batch(["", "abc", "x" * 17])
    n = len(bos)
    assert tokens.shape == (3, 32) and lengths.tolist() == [max(1, n), 3 + n, 17 + n]
    assert tokens[1, : 3 + n].tolist() == bos + list(b"abc") and not tokens[1, 3 + n:].any()
    tokens, lengths = tsvc.batch(["y" * 100])
    assert tokens.shape == (1, 64) and lengths.tolist() == [40]
    tokens, _ = tsvc.batch(["z"])
    assert tokens.shape == (1, 16)


def test_one_weight_tree_serves_both_services():
    """The completions service and the embeddings service of one provider
    read the same tree: the engine serves the object ``params()`` returned
    to the embeddings, drawn once."""
    prov = TorchServingProvider({"model": "tiny-test", "device": "cpu", "max-seq-len": 64,
                                 "max-batch": 2, "decode-chunk": 4})
    comp = prov.get_completions_service({})
    emb = prov.get_embeddings_service({})
    assert isinstance(emb, TorchEmbeddingsService) and emb.holder is comp
    vectors = asyncio.run(emb.compute_embeddings(["one tree"]))
    tree = comp._params
    res = asyncio.run(comp.get_chat_completions([ChatMessage("user", "hi")], {"max-tokens": 4}))
    assert comp.engine().params is tree and comp.params() is tree
    assert res.completion_tokens > 0 and len(vectors[0]) == MODEL_PRESETS["tiny-test"].d_model
    asyncio.run(prov.close())


def test_embedding_while_the_engine_serves_gives_the_idle_vectors():
    """A batch embedded on another thread while the provider's engine serves
    a burst equals the same batch embedded with the engine idle; the
    completions are the ones served without the concurrent embedding."""
    _, tprov, _, tsvc = _providers()
    comp = tprov.get_completions_service({})
    idle = tsvc.embed(TEXTS)
    prompts = [[ChatMessage("user", f"question {i}")] for i in range(4)]

    async def burst():
        return [r.content for r in await asyncio.gather(*(
            comp.get_chat_completions(p, {"max-tokens": 12}) for p in prompts))]

    alone = asyncio.run(burst())
    out: dict = {}

    def embed_many():
        out["vectors"] = [tsvc.embed(TEXTS) for _ in range(3)]

    t = threading.Thread(target=embed_many)
    t.start()
    served = asyncio.run(burst())
    t.join(timeout=120)
    asyncio.run(tprov.close())
    assert served == alone
    for v in out["vectors"]:
        np.testing.assert_array_equal(v, idle)
