"""The port's sampler against the JAX package's: greedy first-index ties
(exact), ragged vocabs, the -1 NaN sentinel, and the top-k / top-p masks.
Sampled draws come from different generators (torch vs jax.random), so
they are compared in distribution only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.serving import sampling as jsampling
from langstream_tpu_torch.serving import sampling as tsampling


def both_greedy(logits: np.ndarray):
    ref = np.asarray(jsampling._greedy_argmax(jnp.asarray(logits)))
    out = tsampling._greedy_argmax(torch.from_numpy(logits)).numpy()
    return ref, out


def test_greedy_ties_take_the_first_index():
    logits = np.zeros((4, 512), np.float32)
    logits[0, [5, 300, 511]] = 2.0  # tie across groups
    logits[1, [130, 131]] = 3.0  # tie inside one group
    logits[2, :] = 1.0  # everything ties
    logits[3, [127, 128]] = 4.0  # tie across a group boundary
    ref, out = both_greedy(logits)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, [5, 130, 0, 127])


@pytest.mark.parametrize("vocab", [50257, 300, 129, 128])
def test_greedy_ragged_vocab(vocab):
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((6, vocab)).astype(np.float32)
    logits[1, :] = -np.inf  # an all -inf row resolves to index 0
    logits[2, -1] = 100.0  # the last real column wins
    ref, out = both_greedy(logits)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.argmax(logits, axis=-1))


def _params(b, temp, top_k=0, top_p=1.0):
    return (
        np.full(b, temp, np.float32),
        np.full(b, top_k, np.int32),
        np.full(b, top_p, np.float32),
    )


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_nan_sentinel(temp):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 256)).astype(np.float32)
    logits[1, 17] = np.nan
    logits[2, 3] = np.inf
    t, k, p = _params(4, temp, top_k=8)
    ref = np.asarray(jsampling.sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)
    ))
    out = tsampling.sample(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p),
    ).numpy()
    assert out[1] == out[2] == ref[1] == ref[2] == -1
    assert out[0] >= 0 and out[3] >= 0
    if temp == 0.0:
        np.testing.assert_array_equal(out, ref)


def test_filters_match_jax():
    rng = np.random.default_rng(2)
    b, v = 6, 300
    s = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    top_k = np.array([0, 1, 5, 0, 40, 300], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 0.5, 0.2, 0.999], np.float32)
    ref = np.asarray(jsampling._apply_filters(jnp.asarray(s), jnp.asarray(top_k), jnp.asarray(top_p)))
    out = tsampling._apply_filters(
        torch.from_numpy(s), torch.from_numpy(top_k), torch.from_numpy(top_p)
    ).numpy()
    # the masks agree except where a token's exclusive cumulative
    # probability sits within 1e-5 of top_p, where f32 cumsum rounding
    # decides: JAX drops a top_p = 1.0 row's last tokens when their
    # exclusive mass rounds up to 1.0; the port keeps every token there
    differ = np.isinf(out) != np.isinf(ref)
    for r, c in zip(*np.nonzero(differ)):
        row = s[r][np.argsort(-s[r], kind="stable")].astype(np.float64)
        p = np.exp(row - row.max())
        p /= p.sum()
        rank = int(np.nonzero(row == s[r, c])[0][0])
        assert abs(p[:rank].sum() - top_p[r]) < 1e-5, (r, c)
    same = ~differ & ~np.isinf(out)
    np.testing.assert_array_equal(out[same], ref[same])
    kept = (~np.isinf(out)).sum(axis=-1)
    assert kept[0] == v and kept[1] == 1 and kept[2] <= 5 and kept[4] <= 40


def test_greedy_rows_stay_greedy_in_a_sampled_batch():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 128)).astype(np.float32)
    temp = np.array([0.0, 1.0, 0.0, 0.7], np.float32)
    out = tsampling.sample(
        torch.from_numpy(logits), torch.Generator().manual_seed(1), torch.from_numpy(temp),
        torch.zeros(4, dtype=torch.long), torch.ones(4),
    ).numpy()
    greedy = np.argmax(logits, axis=-1)
    assert out[0] == greedy[0] and out[2] == greedy[2]


def test_host_predicates_match_tensor_predicates():
    """Passing any_sample / any_filter from the host gives the same draw as
    reading them off the tensors."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    temp = torch.tensor([0.0, 0.9, 0.5])
    top_k = torch.tensor([0, 4, 0])
    top_p = torch.tensor([1.0, 1.0, 0.8])
    a = tsampling.sample(logits, torch.Generator().manual_seed(9), temp, top_k, top_p)
    b = tsampling.sample(logits, torch.Generator().manual_seed(9), temp, top_k, top_p, True, True)
    assert torch.equal(a, b)


def test_sampled_distribution_matches_softmax_of_top_k():
    """Temperature 1, top-k 3: draws follow softmax over the 3 best logits
    (4000 draws, each frequency within 0.03 of its probability)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 1.5]])
    n = 4000
    gen = torch.Generator().manual_seed(5)
    draws = [
        int(tsampling.sample(
            logits, gen, torch.ones(1), torch.tensor([3]), torch.ones(1), True, True
        )[0])
        for _ in range(n)
    ]
    freq = np.bincount(draws, minlength=6) / n
    top = np.array([2.0, 1.0, 1.5])
    probs = np.exp(top - top.max()) / np.exp(top - top.max()).sum()
    np.testing.assert_allclose(freq[[0, 1, 5]], probs, atol=0.03)
    assert freq[[2, 3, 4]].sum() == 0
