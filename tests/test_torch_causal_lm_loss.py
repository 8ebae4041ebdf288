"""The port's ``causal_lm_loss`` against the JAX package's: next-token
cross-entropy over a ``[B, S]`` batch with pad id 0 masked, on tiny-test
and tiny-moe-test (f32, the same seeded weights through
``models/bridge.py``), within 1e-5; and a finite gradient through
``torch.autograd`` to every leaf of the tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import MODEL_PRESETS as JAX_PRESETS
from langstream_tpu.models.transformer import causal_lm_loss as jax_causal_lm_loss
from langstream_tpu.models.transformer import init_params as jax_init_params
from langstream_tpu_torch.models.bridge import params_from_numpy
from langstream_tpu_torch.models.configs import MODEL_PRESETS
from langstream_tpu_torch.models.transformer import causal_lm_loss

torch.backends.cuda.matmul.allow_tf32 = False


def _batch(seed: int) -> np.ndarray:
    """Three rows of 12 tokens; rows 1 and 2 padded with 0 from 8 and 5."""
    tokens = np.random.default_rng(seed).integers(1, 512, (3, 12)).astype(np.int32)
    tokens[1, 8:] = 0
    tokens[2, 5:] = 0
    return tokens


def _trees(name: str):
    jcfg = dataclasses.replace(JAX_PRESETS[name], dtype="float32")
    cfg = dataclasses.replace(MODEL_PRESETS[name], dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.mark.parametrize("name", ["tiny-test", "tiny-moe-test"])
def test_causal_lm_loss_matches_jax_with_padded_rows(name):
    jcfg, jp, cfg, params = _trees(name)
    for seed in (0, 1):
        tokens = _batch(seed)
        want = float(jax_causal_lm_loss(jp, jnp.asarray(tokens), jcfg))
        got = causal_lm_loss(params, torch.from_numpy(tokens), cfg)
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-5, (float(got), want)


@pytest.mark.parametrize("name", ["tiny-test", "tiny-moe-test"])
def test_causal_lm_loss_gradient_is_finite(name):
    """``loss.backward()`` reaches every leaf the forward reads (the MoE
    router too) with finite values, and a descent step along it lowers the
    loss."""
    _, _, cfg, params = _trees(name)
    tokens = torch.from_numpy(_batch(0))
    leaves = [t for t in jax.tree.leaves(params) if isinstance(t, torch.Tensor)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = causal_lm_loss(params, tokens, cfg)
    loss.backward()
    assert all(leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
               for leaf in leaves)
    assert sum(float(leaf.grad.abs().sum()) for leaf in leaves) > 0
    with torch.no_grad():
        for leaf in leaves:
            leaf -= 1e-2 * leaf.grad
        assert float(causal_lm_loss(params, tokens, cfg)) < float(loss)


def test_causal_lm_loss_all_padding_is_zero():
    """A batch whose targets are all padding divides by max(mask, 1): 0."""
    _, _, cfg, params = _trees("tiny-test")
    tokens = torch.zeros((2, 6), dtype=torch.long)
    tokens[:, 0] = 5
    assert float(causal_lm_loss(params, tokens, cfg)) == 0.0
