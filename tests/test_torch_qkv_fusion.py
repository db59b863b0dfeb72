"""The port's ops/qkv_fusion.py against the JAX package's on the CPU: the five
split + per-head RMSNorm + RoPE functions, neox and interleaved. The same
seeded numpy inputs go to both packages; the JAX functions run eagerly.

Tolerance: a few f32 ulps of each output (rtol 2e-6 plus 1e-6 of its
largest value): the per-head rstd is the port's float64 rule where XLA's CPU
rsqrt approximates (ROADMAP Queue 3), and the RoPE products are the same f32
steps. Outputs in bf16 are held within one bf16 ulp, since a value an f32
ulp apart can round to either side; the v and gate slices pass through
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import qkv_fusion as jf
from sgl_kernel_npu_tpu_torch.ops import qkv_fusion as tf

B, NQ, NKV, D, RD = 5, 4, 2, 32, 16


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


def _close(got, want, name=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6 * np.abs(want).max(),
                               err_msg=name)


def _bf16_close(got, want, name=""):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-30), name


def _tables(rng, rd):
    ang = rng.random((B, rd // 2)).astype(np.float32) * 3
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
    return sin, cos


def _weights(rng, n):
    return (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
def test_split_qkv_rmsnorm_rope_matches_jax(neox, norm):
    """x [5, (4 + 2 * 2) * 32] f32, RoPE on the first 16 dims of each head,
    the per-head RMSNorm with weights and biases (or none)."""
    rng = np.random.default_rng(1 + 2 * neox + norm)
    x = rng.standard_normal((B, (NQ + 2 * NKV) * D)).astype(np.float32)
    sin, cos = _tables(rng, RD)
    qw, kw, qb, kb = _weights(rng, D), _weights(rng, D), _weights(rng, D) - 1, _weights(rng, D) - 1
    nkw = dict(eps=1e-6, q_weight=qw, k_weight=kw, q_bias=qb, k_bias=kb) if norm else {}
    want = jf.split_qkv_rmsnorm_rope(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos), NQ * D,
                                     NKV * D, D, is_neox_style=neox,
                                     **{k: v if k == "eps" else jnp.asarray(v)
                                        for k, v in nkw.items()})
    got = tf.split_qkv_rmsnorm_rope(_t(x), _t(sin), _t(cos), NQ * D, NKV * D, D,
                                    is_neox_style=neox,
                                    **{k: v if k == "eps" else _t(v) for k, v in nkw.items()})
    for name, g, w in zip("qkv", got, want):
        _close(g, w, name)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
def test_split_qkv_rmsnorm_rope_pos_cache_matches_jax(neox):
    """bf16 x from positions into a [64, 16] cos | sin half-table cache (the
    port's make_cos_sin_cache on the CPU), normed: q and k within one bf16
    ulp, v exact."""
    rng = np.random.default_rng(7 + neox)
    from sgl_kernel_npu_tpu_torch.ops.rope import make_cos_sin_cache
    cache = make_cos_sin_cache(64, RD, device="cpu").numpy()
    x = jnp.asarray(rng.standard_normal((B, (NQ + 2 * NKV) * D)), jnp.bfloat16)
    pos = rng.integers(0, 64, B).astype(np.int32)
    qw, kw = _weights(rng, D), _weights(rng, D)
    want = jf.split_qkv_rmsnorm_rope_pos_cache(x, jnp.asarray(pos), jnp.asarray(cache), NQ * D,
                                               NKV * D, D, 1e-6, jnp.asarray(qw),
                                               jnp.asarray(kw), is_neox_style=neox)
    got = tf.split_qkv_rmsnorm_rope_pos_cache(_t(x).to(torch.bfloat16), torch.from_numpy(pos),
                                              torch.from_numpy(cache), NQ * D, NKV * D, D, 1e-6,
                                              _t(qw), _t(kw), is_neox_style=neox)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _bf16_close(got[0], want[0], "q")
    _bf16_close(got[1], want[1], "k")
    assert np.array_equal(got[2].float().numpy(), np.asarray(want[2], np.float32))


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
def test_split_qkv_tp_rmsnorm_rope_matches_jax(neox):
    """Rank 1 of tp 2: x holds (4 + 2 * 2) / 2 heads of 32."""
    rng = np.random.default_rng(11 + neox)
    x = rng.standard_normal((B, (NQ + 2 * NKV) // 2 * D)).astype(np.float32)
    sin, cos = _tables(rng, RD)
    qw, kw = _weights(rng, D), _weights(rng, D)
    want = jf.split_qkv_tp_rmsnorm_rope(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos), NQ,
                                        NKV, D, tp_rank=1, tp_size=2, eps=1e-6,
                                        q_weight=jnp.asarray(qw), k_weight=jnp.asarray(kw),
                                        is_neox_style=neox)
    got = tf.split_qkv_tp_rmsnorm_rope(_t(x), _t(sin), _t(cos), NQ, NKV, D, tp_rank=1,
                                       tp_size=2, eps=1e-6, q_weight=_t(qw), k_weight=_t(kw),
                                       is_neox_style=neox)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, name)


def test_fused_split_qk_norm_matches_jax():
    """The MLA split at q_lora 48, kv_lora 32, rope 8, with norm biases."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, 48 + 32 + 8)).astype(np.float32)
    qw, kw, qb, kb = _weights(rng, 48), _weights(rng, 32), _weights(rng, 48), _weights(rng, 32)
    want = jf.fused_split_qk_norm(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(kw), 48, 32, 8,
                                  q_norm_bias=jnp.asarray(qb), kv_norm_bias=jnp.asarray(kb))
    got = tf.fused_split_qk_norm(_t(x), _t(qw), _t(kw), 48, 32, 8, q_norm_bias=_t(qb),
                                 kv_norm_bias=_t(kb))
    assert [tuple(g.shape) for g in got] == [(B, 48), (B, 1, 32), (B, 1, 8)]
    for name, g, w in zip(("q", "k_nope", "k_pe"), got, want):
        _close(g, w, name)


def test_split_qkvgate_gemma_rmsnorm_rope_matches_jax():
    """Qwen3-Next's attention split ([q | gate] per head, the Gemma (1 + w)
    norms, neox RoPE on the first quarter of each head) at 4 query and 2 kv
    heads of 32."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((B, 2 * NQ * D + 2 * NKV * D)).astype(np.float32)
    sin, cos = _tables(rng, D // 4)
    qw, kw = 0.1 * _weights(rng, D), 0.1 * _weights(rng, D)
    want = jf.split_qkvgate_gemma_rmsnorm_rope(jnp.asarray(x), jnp.asarray(sin),
                                               jnp.asarray(cos), NQ * D, NKV * D, D, D // 4,
                                               1e-6, jnp.asarray(qw), jnp.asarray(kw))
    got = tf.split_qkvgate_gemma_rmsnorm_rope(_t(x), _t(sin), _t(cos), NQ * D, NKV * D, D,
                                              D // 4, 1e-6, _t(qw), _t(kw))
    for name, g, w in zip(("q", "k", "v", "gate"), got, want):
        _close(g, w, name)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
