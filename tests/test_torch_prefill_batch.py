"""The admit-group size (``prefill_batch``) of the port's engine against the
JAX engine's: with ``prefill_batch=4`` six short prompts of one bucket
split into groups of 4 and 2 rows — an MoE model's groups padded to 4 rows
(the experts' capacity is shared across the rows, so the padding decides
the logits), a dense model's unpadded (its rows are independent). Every
request is submitted before ``start()`` on both engines, so the groups are
the same. tiny-test and tiny-moe-test in f32, both layouts: greedy tokens
equal. The provider serves the ``prefill-batch`` key."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import GenerationOptions as JaxOptions
from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu.serving.engine import GenerationRequest as JaxRequest
from langstream_tpu.serving.engine import ServingEngine as JaxEngine
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS, GenerationOptions
from langstream_tpu_torch.serving.engine import GenerationRequest, ServingEngine

torch.backends.cuda.matmul.allow_tf32 = False

ENGINE_KW = dict(max_batch=8, max_seq_len=256, decode_chunk=4, prefill_buckets=(32, 64, 128),
                 prefill_batch=4)
# six prompts of the 32 bucket (groups of 4 + 2) and one of the 64 bucket
PROMPT_LENS = (3, 9, 14, 20, 26, 31, 50)
NEW_TOKENS = 8


def prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(1, 512, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("model", ["tiny-test", "tiny-moe-test"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prefill_batch_tokens_equal_jax(model, layout):
    jcfg = dataclasses.replace(JAX_PRESETS[model], dtype="float32")
    cfg = dataclasses.replace(MODEL_PRESETS[model], dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jengine = JaxEngine(jcfg, jp, kv_layout=layout, **ENGINE_KW)
    jreqs = [jengine.submit(JaxRequest(prompt_tokens=p, options=JaxOptions(
        max_new_tokens=NEW_TOKENS, temperature=0.0))) for p in prompts()]
    jengine.start()
    try:
        want = [r.result(timeout=300).tokens for r in jreqs]
    finally:
        jengine.stop()
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    engine = ServingEngine(cfg, params, device="cpu", kv_layout=layout, **ENGINE_KW)
    assert engine.prefill_batch == 4
    seen = []
    real = engine._dev_prefill

    def spy(tokens, *args, **kw):
        seen.append(tokens.shape[0])
        return real(tokens, *args, **kw)

    engine._dev_prefill = spy
    reqs = [engine.submit(GenerationRequest(prompt_tokens=p, options=GenerationOptions(
        max_new_tokens=NEW_TOKENS, temperature=0.0))) for p in prompts()]
    engine.start()
    try:
        got = [r.result(timeout=300).tokens for r in reqs]
    finally:
        engine.stop()
    assert got == want
    # the groups: 4 + 2 rows of the 32 bucket and 1 of the 64 bucket, an
    # MoE model's each padded to prefill_batch rows
    assert seen == ([4, 4, 4] if cfg.is_moe else [4, 2, 1])


def test_provider_serves_prefill_batch():
    from langstream_tpu_torch.ai.torch_serving import TorchCompletionsService

    svc = TorchCompletionsService({"model": "tiny-test", "device": "cpu", "prefill-batch": 4,
                                   "max-seq-len": 128, "prefill-buckets": [32, 64]})
    try:
        assert svc.engine().prefill_batch == 4
        assert svc.engine().memory_plan is not None
    finally:
        svc.close()
    with pytest.raises(ValueError, match="prefill-batch"):
        TorchCompletionsService({"model": "tiny-test", "device": "cpu", "prefill-batch": 0})
