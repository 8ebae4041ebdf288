"""``fused_segment_decode_attention`` of the port against the JAX package's
on the same numpy inputs: the three configs of
``tests/test_pallas_ops.py``'s fused test (no cap, a decode ``kv_bound``
of 32, a soft cap), over a float and an int8 cache. The JAX side runs its
segment kernel in interpret mode (``attention_impl="pallas"``,
``interpret=True``) and the port's gate takes the segment kernel's plain
version on the CPU; with ``attention_impl="jnp"`` both take the masked
reference read. f32, held to 1e-5 (the kernel and its plain version sum in
different orders). Each half is also held to its standalone path in the
port: the segment half bit-equal to a direct ``flash_segment_attention``
(``_int8``) call on the gathered rows, the decode half to the masked read
over the sliced rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.configs import ModelConfig as JaxModelConfig
from langstream_tpu.models.transformer import _quantize_kv as jax_quantize_kv
from langstream_tpu.ops import attention as jax_attn
from langstream_tpu_torch.models.configs import ModelConfig
from langstream_tpu_torch.models.transformer import _quantize_kv, attention
from langstream_tpu_torch.ops import attention as port_attn

FIELDS = dict(name="k", vocab_size=128, d_model=64, n_layers=1, n_heads=8, n_kv_heads=4,
              d_ff=64, dtype="float32")
TOL = 1e-5
B, S, T, H, HKV, D = 4, 16, 64, 8, 4, 8
# (soft cap, decode kv_bound): tests/test_pallas_ops.py's three configs
CONFIGS = [(None, None), (None, 32), (30.0, None)]


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def inputs(int8: bool):
    rng = np.random.default_rng(7)
    k, v = rand(rng, B, HKV, T, D), rand(rng, B, HKV, T, D)
    q_seg, q_dec = rand(rng, 2, S, H, D), rand(rng, 2, H, D)
    # rows 1 and 3 are mid-prefill segments at offsets 0 and 32; rows 0 and 2
    # decode at lengths 7 and 29
    ints = dict(seg_rows=np.array([1, 3], np.int32), seg_offsets=np.array([0, 32], np.int32),
                dec_rows=np.array([0, 2], np.int32), dec_lengths=np.array([7, 29], np.int32))
    jax_kv = [jnp.asarray(k), jnp.asarray(v)]
    port_kv = [torch.from_numpy(k), torch.from_numpy(v)]
    if int8:
        jax_kv = [dict(zip("qs", jax_quantize_kv(a))) for a in jax_kv]
        port_kv = [dict(zip("qs", _quantize_kv(a))) for a in port_kv]
        for j, p in zip(jax_kv, port_kv):  # one quantization, bit-equal in both
            assert np.array_equal(np.asarray(j["q"]), p["q"].numpy())
    return q_seg, q_dec, ints, jax_kv, port_kv


def run_both(impl: str, softcap, kv_bound, int8: bool):
    q_seg, q_dec, ints, jax_kv, port_kv = inputs(int8)
    jcfg = JaxModelConfig(**FIELDS, attn_logit_softcap=softcap, attention_impl=impl)
    pcfg = ModelConfig(**FIELDS, attn_logit_softcap=softcap,
                       attention_impl="auto" if impl == "pallas" else impl)
    want = jax_attn.fused_segment_decode_attention(
        jnp.asarray(q_seg), jnp.asarray(ints["seg_offsets"]), jnp.asarray(q_dec), *jax_kv,
        jnp.asarray(ints["seg_rows"]), jnp.asarray(ints["dec_rows"]),
        jnp.asarray(ints["dec_lengths"]), jcfg, kv_bound=kv_bound, interpret=True,
    )
    tens = {n: torch.from_numpy(a) for n, a in ints.items()}
    got = port_attn.fused_segment_decode_attention(
        torch.from_numpy(q_seg), tens["seg_offsets"], torch.from_numpy(q_dec), *port_kv,
        tens["seg_rows"], tens["dec_rows"], tens["dec_lengths"], pcfg, kv_bound=kv_bound,
    )
    return want, got, (q_seg, q_dec, tens, port_kv, pcfg)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("softcap, kv_bound", CONFIGS, ids=["plain", "kv_bound32", "softcap"])
def test_fused_routing_matches_jax(softcap, kv_bound, impl, int8):
    before = port_attn.kernel_counts()
    want, got, _ = run_both(impl, softcap, kv_bound, int8)
    after = port_attn.kernel_counts()
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    # the kernel path took the segment kernel (its plain version on the CPU)
    name = "flash_segment_int8" if int8 else "flash_segment"
    calls = after[name]["cpu_calls"] - before[name]["cpu_calls"]
    assert calls == (1 if impl == "pallas" else 0)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("softcap, kv_bound", CONFIGS, ids=["plain", "kv_bound32", "softcap"])
def test_fused_routing_halves_equal_their_standalone_paths(softcap, kv_bound, int8):
    _, (seg_out, dec_out), (q_seg, q_dec, tens, (k, v), cfg) = run_both(
        "pallas", softcap, kv_bound, int8)

    def rows(entry, index, cols=T):
        if isinstance(entry, dict):
            return {n: a[index.long(), :, :cols] for n, a in entry.items()}
        return entry[index.long(), :, :cols]

    seg = port_attn.flash_segment_attention_int8 if int8 else port_attn.flash_segment_attention
    direct = seg(torch.from_numpy(q_seg), rows(k, tens["seg_rows"]), rows(v, tens["seg_rows"]),
                 tens["seg_offsets"], cfg)
    assert torch.equal(seg_out, direct)
    tb = kv_bound or T
    mask = torch.arange(tb)[None, None, :] < tens["dec_lengths"].long()[:, None, None]
    read = attention(torch.from_numpy(q_dec)[:, None], rows(k, tens["dec_rows"], tb),
                     rows(v, tens["dec_rows"], tb), mask, cfg)[:, 0]
    assert torch.equal(dec_out, read)
