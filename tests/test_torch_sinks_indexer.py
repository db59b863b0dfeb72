"""The port's attention with sinks (ops/attention/sinks.py) and lightning
indexer (ops/attention/lightning_indexer.py) against the JAX package's on
the CPU: the same seeded numpy inputs, the JAX functions eagerly, the port's
on CPU tensors. Both are plain in both packages.

Tolerances. Sinks: the same f32 softmax and products in another summation
order; f32 inputs within 2e-6 of max|out|; bf16 inputs within one bf16 ulp
of the JAX value plus 1e-5 of max|out| (a sum an f32 ulp apart may round to
the next bf16). Indexer: scores within 1e-5 of max|score| (f32 sums of
ReLU'd products); the top-k selections compared as sets after ties are
removed: every position whose score clears the k-th score by more than the
score tolerance is in both selections, the rest of each selection scores
within that tolerance of the k-th (jax.lax.top_k puts the lower index first
on a tie, torch.topk in no promised order), and -1 pads agree in number.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops.attention import lightning_indexer as jli
from sgl_kernel_npu_tpu.ops.attention import sinks as jsk
from sgl_kernel_npu_tpu_torch.ops.attention import lightning_indexer as tli
from sgl_kernel_npu_tpu_torch.ops.attention import sinks as tsk

F32_SHARE = 2e-6
BF16_SHARE = 1e-5
SCORE_SHARE = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, share, bf16=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = share * np.abs(want).max() + (2.0 ** -7 * np.abs(want) if bf16 else 0.0)
    err = np.abs(got - want)
    assert (err <= bound).all(), (float(err.max()), float(np.abs(want).max()))


def _as(a, bf16):
    """(JAX array, port tensor) of a, in bf16 or f32."""
    if bf16:
        j = jnp.asarray(a, jnp.bfloat16)
        return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(a), _t(a)


# ------------------------------------------------------------------ sinks


@pytest.mark.parametrize("window", [-1, 20])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_attention_with_sinks_matches_jax(window, bf16):
    """B 3 over head-major pages of 16 (4 a sequence, shuffled), 8 query and
    2 kv heads of 32; lengths 1, 37 and 64 (a window of 20 cuts the last
    two)."""
    rng = np.random.default_rng(11 + bf16)
    b, hq, hkv, d, ps, mp = 3, 8, 2, 32, 16, 4
    pages = b * mp + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc = rng.standard_normal((hkv, pages, ps, d)).astype(np.float32)
    vc = rng.standard_normal((hkv, pages, ps, d)).astype(np.float32)
    sinks = rng.standard_normal(hq).astype(np.float32) * 2
    bt = (rng.permutation(b * mp) + 1).reshape(b, mp).astype(np.int32)
    lens = np.array([1, 37, 64], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = _as(q, bf16), _as(kc, bf16), _as(vc, bf16)
    want = jsk.decode_attention_with_sinks(jq, jk, jv, jnp.asarray(sinks), jnp.asarray(lens),
                                           jnp.asarray(bt), d ** -0.5, ps, window)
    got = tsk.decode_attention_with_sinks(tq, tk, tv, _t(sinks), _t(lens), _t(bt), d ** -0.5,
                                          ps, window)
    assert got.dtype == tq.dtype and got.shape == (b, hq, d)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           BF16_SHARE if bf16 else F32_SHARE, bf16)


@pytest.mark.parametrize("window", [-1, 7])
@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_attention_with_sinks_matches_jax(window, bf16):
    """Three sequences of 5, 1 and 18 tokens laid end to end, 4 query and 2
    kv heads of 16."""
    rng = np.random.default_rng(21 + bf16)
    hq, hkv, d = 4, 2, 16
    cu = np.array([0, 5, 6, 24], np.int32)
    t = int(cu[-1])
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    k = rng.standard_normal((t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    sinks = rng.standard_normal(hq).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _as(q, bf16), _as(k, bf16), _as(v, bf16)
    want = jsk.prefill_attention_with_sinks(jq, jk, jv, jnp.asarray(sinks), jnp.asarray(cu),
                                            0.25, window)
    got = tsk.prefill_attention_with_sinks(tq, tk, tv, _t(sinks), _t(cu), 0.25, window)
    assert got.dtype == tq.dtype and got.shape == (t, hq, d)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           BF16_SHARE if bf16 else F32_SHARE, bf16)


def test_sinks_join_the_denominator_only():
    """A sink of -inf-like weight gives plain softmax attention; a large one
    takes the mass and drives the output to 0."""
    rng = np.random.default_rng(5)
    t, h, d = 6, 2, 8
    q, k, v = (_t(rng.standard_normal((t, h, d)).astype(np.float32)) for _ in range(3))
    cu = torch.tensor([0, t])
    plain = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), is_causal=True).transpose(0, 1)
    low = tsk.prefill_attention_with_sinks(q, k, v, torch.full((h,), -1e4), cu, d ** -0.5)
    high = tsk.prefill_attention_with_sinks(q, k, v, torch.full((h,), 1e4), cu, d ** -0.5)
    torch.testing.assert_close(low, plain, rtol=1e-5, atol=1e-6)
    assert high.abs().max() == 0


# -------------------------------------------------------------- indexer


def _same_topk(got, want, score, k_tol):
    """got, want [R, K] ids (-1 pads); score [R, N] f32 over the ids. Equal
    after ties (within k_tol of the K-th valid score) are removed."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for r in range(got.shape[0]):
        g, w = got[r][got[r] >= 0], want[r][want[r] >= 0]
        assert g.size == w.size, r
        if not g.size:
            continue
        kth = score[r][w].min()
        assert len(set(g.tolist())) == g.size, r
        clear_g = set(g[score[r][g] > kth + k_tol].tolist())
        clear_w = set(w[score[r][w] > kth + k_tol].tolist())
        assert clear_g == clear_w, r
        assert (np.abs(score[r][g] - kth)[score[r][g] <= kth + k_tol] <= k_tol).all(), r


def _indexer_inputs(rng, b, sq, sk, g=4, d=32):
    return (rng.standard_normal((b, sq, g, d)).astype(np.float32),
            rng.standard_normal((b, sk, d)).astype(np.float32),
            rng.random((b, sq, g)).astype(np.float32))


def test_lightning_indexer_scores_match_jax():
    q, k, w = _indexer_inputs(np.random.default_rng(31), 2, 5, 40)
    want = np.asarray(jli.lightning_indexer_scores(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(w)))
    got = tli.lightning_indexer_scores(_t(q), _t(k), _t(w)).numpy()
    _close(got, want, SCORE_SHARE)


@pytest.mark.parametrize("causal,lens,qpos,count", [
    (True, None, None, 8),
    (True, [40, 13], None, 16),
    (False, [40, 13], None, 16),
    (True, None, [[30, 31, 32, 33, 34, 35], [0, 1, 2, 3, 4, 39]], 8),
    (False, None, None, 64),          # more than Sk: min(count, Sk) columns
], ids=["causal", "lens", "lens-not-causal", "positions", "count-past-sk"])
def test_lightning_indexer_matches_jax(causal, lens, qpos, count):
    rng = np.random.default_rng(41)
    b, sq, sk = 2, 6, 40
    q, k, w = _indexer_inputs(rng, b, sq, sk)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens)
    jp = None if qpos is None else jnp.asarray(qpos, jnp.int32)
    tp = None if qpos is None else torch.tensor(qpos)
    jidx, jsc = jli.lightning_indexer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(w), count,
                                      jl, causal, jp)
    tidx, tsc = tli.lightning_indexer(_t(q), _t(k), _t(w), count, tl, causal, tp)
    assert tidx.dtype == torch.int32 and tuple(tidx.shape) == jidx.shape
    jsc = np.asarray(jsc)
    valid = jsc > -1e29
    assert np.array_equal(tsc.numpy() > -1e29, valid)
    _close(np.where(valid, tsc.numpy(), 0), np.where(valid, jsc, 0), SCORE_SHARE)
    tol = SCORE_SHARE * np.abs(np.where(valid, jsc, 0)).max()
    _same_topk(tidx.reshape(-1, tidx.shape[-1]), np.asarray(jidx).reshape(-1, jidx.shape[-1]),
               jsc.reshape(-1, sk), tol)


@pytest.mark.parametrize("count", [16, 200])
def test_lightning_indexer_paged_matches_jax(count):
    """B 3 over pages of 8 (6 a sequence, shuffled), lengths 1, 20 and 48;
    the selections are slot ids (page * ps + offset)."""
    rng = np.random.default_rng(51)
    b, g, d, ps, mp = 3, 4, 32, 8, 6
    pages = b * mp + 2
    q = rng.standard_normal((b, g, d)).astype(np.float32)
    kc = rng.standard_normal((pages, ps, d)).astype(np.float32)
    w = rng.random((b, g)).astype(np.float32)
    bt = (rng.permutation(b * mp) + 2).reshape(b, mp).astype(np.int32)
    lens = np.array([1, 20, 48], np.int32)
    want = np.asarray(jli.lightning_indexer_paged(jnp.asarray(q), jnp.asarray(kc),
                                                  jnp.asarray(w), jnp.asarray(bt),
                                                  jnp.asarray(lens), count))
    got = tli.lightning_indexer_paged(_t(q), _t(kc), _t(w), _t(bt), _t(lens), count)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    # scores over slot ids (f64 of the same formula), -inf where not valid
    score = np.full((b, pages * ps), -np.inf)
    for r in range(b):
        slots = (bt[r][:, None] * ps + np.arange(ps)).reshape(-1)[: lens[r]]
        s = np.maximum(np.einsum("gd,kd->gk", q[r].astype(np.float64),
                                 kc.reshape(-1, d)[slots]), 0)
        score[r, slots] = w[r] @ s
    _same_topk(got.numpy(), want, score, SCORE_SHARE * np.abs(score[np.isfinite(score)]).max())


@pytest.mark.parametrize("causal", [True, False])
def test_lightning_indexer_varlen_matches_jax(causal):
    """Three sequences: 4 queries over 10 keys, 1 over 1, 7 over 25 (prefix
    sums [4, 5, 12] and [10, 11, 36]); local key positions come back."""
    rng = np.random.default_rng(61)
    g, d = 4, 16
    cu_q, cu_k = [4, 5, 12], [10, 11, 36]
    q = rng.standard_normal((12, g, d)).astype(np.float32)
    k = rng.standard_normal((36, d)).astype(np.float32)
    w = rng.random((12, g)).astype(np.float32)
    jidx, jsc = jli.lightning_indexer_varlen(jnp.asarray(q), jnp.asarray(k), jnp.asarray(w),
                                             cu_q, cu_k, 6, causal)
    tidx, tsc = tli.lightning_indexer_varlen(_t(q), _t(k), _t(w), cu_q, cu_k, 6, causal)
    jsc = np.asarray(jsc)
    valid = jsc > -1e29
    assert np.array_equal(tsc.numpy() > -1e29, valid)
    _close(np.where(valid, tsc.numpy(), 0), np.where(valid, jsc, 0), SCORE_SHARE)
    # local positions -> global key ids for the tie-aware comparison
    start_k = np.array([0, 10, 11])
    seg = np.searchsorted(np.array(cu_q), np.arange(12), side="right")
    glob = lambda idx: np.where(idx >= 0, idx + start_k[seg][:, None], -1)  # noqa: E731
    _same_topk(glob(tidx.numpy()), glob(np.asarray(jidx)), jsc,
               SCORE_SHARE * np.abs(np.where(valid, jsc, 0)).max())
