"""The port's sampling and grammar ops (ops/sampling.py, ops/grammar.py)
against the JAX package's on the CPU.

The same seeded numpy f32 logits go to both; the JAX functions run eagerly
(op by op, as their callers outside a jit do). The masks, the temperature
and the penalties must match bit for bit, except top_p's keep sets, which
may differ only at a token whose exclusive cumulative probability lies
within 1e-6 of p (the two cumulative sums add in their own orders).
`sample` draws by Gumbel-max from an explicit torch.Generator, so it is
held to its distribution, not to JAX's random stream: top_k 1 is the
argmax, a masked token is never drawn, a generator seed repeats its draws,
and the frequencies pass a chi-square test against the softmax of the
masked logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sgl_kernel_npu_tpu.ops import grammar as jgrammar
from sgl_kernel_npu_tpu.ops import sampling as jsampling
from sgl_kernel_npu_tpu_torch.ops import grammar as tgrammar
from sgl_kernel_npu_tpu_torch.ops import sampling as tsampling

B, V = 6, 300          # V not a multiple of 32


def _logits(seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3.0
    if ties:            # quarter steps: many exact ties, also at the k-th value
        x = np.round(x * 4.0).astype(np.float32) / 4.0
    return x


def _same(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2, 37, V - 1, V, V + 5])
def test_top_k_mask_matches_jax(k, ties):
    x = _logits(k + 100, ties)
    _same(jsampling.top_k_mask(jnp.asarray(x), k), tsampling.top_k_mask(torch.from_numpy(x), k))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p", [1.0, 1.5, 0.95, 0.5, 0.05, 1e-4])
def test_top_p_mask_matches_jax(p, ties):
    x = _logits(int(p * 1000) + 7, ties)
    j = np.asarray(jsampling.top_p_mask(jnp.asarray(x), p))
    t = tsampling.top_p_mask(torch.from_numpy(x), p).numpy()
    jkeep, tkeep = j > -1e29, t > -1e29
    assert tkeep.any(axis=-1).all(), "the top token always survives"
    np.testing.assert_array_equal(t[tkeep], x[tkeep])
    # exclusive cumulative probability of each token in the stable order
    order = np.argsort(-x, axis=-1, kind="stable")
    srt = np.take_along_axis(x.astype(np.float64), order, -1)
    prob = np.exp(srt - srt.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    cum = np.empty_like(prob)
    np.put_along_axis(cum, order, np.cumsum(prob, -1) - prob, -1)
    differ = jkeep != tkeep
    assert np.all(np.abs(cum[differ] - p) < 1e-6), cum[differ]


@pytest.mark.parametrize("min_p", [0.0, 0.05, 0.5, 1.0])
def test_min_p_mask_matches_jax(min_p):
    x = _logits(11)
    _same(jsampling.min_p_mask(jnp.asarray(x), min_p),
          tsampling.min_p_mask(torch.from_numpy(x), min_p))


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0, 2.5, "rows"])
def test_apply_temperature_matches_jax(temperature):
    x = _logits(13)
    if temperature == "rows":
        temperature = np.array([0.0, 0.3, 1.0, 1.7, 1e-7, 4.0], np.float32)
        jt, tt = jnp.asarray(temperature), torch.from_numpy(temperature)
    else:
        jt = tt = temperature
    _same(jsampling.apply_temperature(jnp.asarray(x), jt),
          tsampling.apply_temperature(torch.from_numpy(x), tt))


@pytest.mark.parametrize("presence,frequency,repetition", [
    (0.0, 0.0, 1.0), (0.5, 0.0, 1.0), (0.0, 0.3, 1.0), (0.0, 0.0, 1.3),
    (0.4, 0.2, 0.8), (1.0, 1.0, 2.0)])
def test_apply_penalties_matches_jax(presence, frequency, repetition):
    rng = np.random.default_rng(17)
    x = _logits(17)
    t = 12
    ids = rng.integers(0, 20, (B, t)).astype(np.int32)      # repeats within a row
    lens = np.array([0, 1, 5, 12, 7, 3], np.int32)
    j = jsampling.apply_penalties(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(lens),
                                  presence, frequency, repetition)
    tt = tsampling.apply_penalties(torch.from_numpy(x), torch.from_numpy(ids),
                                   torch.from_numpy(lens), presence, frequency, repetition)
    assert tt.dtype == torch.float32
    _same(j, tt)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.3])
def test_sample_top_k_1_is_the_argmax(temperature):
    x = torch.from_numpy(_logits(21))
    want = x.argmax(-1).to(torch.int32)
    for seed in range(5):
        got = tsampling.sample(x, _gen(seed), temperature=temperature, top_k=1)
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("top_k,top_p,min_p", [(5, 1.0, 0.0), (0, 0.3, 0.0), (0, 1.0, 0.4),
                                               (40, 0.8, 0.05)])
def test_sample_never_picks_a_masked_token(top_k, top_p, min_p):
    x = torch.from_numpy(_logits(23))
    t = 0.9
    masked = tsampling.apply_temperature(x, t)
    masked = tsampling.min_p_mask(tsampling.top_p_mask(tsampling.top_k_mask(masked, top_k),
                                                       top_p), min_p)
    allowed = masked > -1e29
    gen = _gen(3)
    for _ in range(50):
        got = tsampling.sample(x, gen, temperature=t, top_k=top_k, top_p=top_p, min_p=min_p)
        assert allowed[torch.arange(B), got.long()].all()


def test_sample_is_deterministic_per_generator():
    """Two generators of one seed draw the same tokens, call after call;
    another seed draws others."""
    x = torch.from_numpy(_logits(29))
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    runs = []
    for seed in (7, 7, 8):
        gen = _gen(seed)
        runs.append(torch.stack([tsampling.sample(x, gen, **kw) for _ in range(8)]))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 6), (1.5, 4)])
def test_sample_frequencies_match_the_masked_softmax(temperature, top_k):
    """40,000 draws of one row of 10 logits: a chi-square test (p > 1e-4)
    of the counts against softmax(top_k_mask(logits / temperature))."""
    row = np.array([1.2, 0.3, -0.5, 2.0, 0.9, -1.4, 0.0, 1.7, -0.2, 0.6], np.float32)
    n = 40000
    x = torch.from_numpy(np.tile(row, (n, 1)))
    got = tsampling.sample(x, _gen(11), temperature=temperature, top_k=top_k).numpy()
    z = row.astype(np.float64) / temperature
    keep = np.ones_like(z, bool) if top_k == 0 else z >= np.sort(z)[-top_k]
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    counts = np.bincount(got, minlength=row.size)
    assert counts[~keep].sum() == 0
    chi2 = (((counts - n * p)[keep] ** 2) / (n * p[keep])).sum()
    assert stats.chi2.sf(chi2, keep.sum() - 1) > 1e-4, (chi2, counts, n * p)


def _bitmask(rng, rows, v):
    """Random int32 words; the sign bit set in about half of them."""
    words = (v + 31) // 32
    return rng.integers(-2 ** 31, 2 ** 31, (rows, words), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("v", [32, 300, 513])
def test_apply_token_bitmask_matches_jax(v):
    rng = np.random.default_rng(v)
    x = rng.standard_normal((B, v)).astype(np.float32)
    bm = _bitmask(rng, B, v)
    j = np.asarray(jgrammar.apply_token_bitmask(jnp.asarray(x), jnp.asarray(bm)))
    t = tgrammar.apply_token_bitmask(torch.from_numpy(x), torch.from_numpy(bm)).numpy()
    np.testing.assert_array_equal(j, t)
    # bit b of word w guards column 32 w + b; bit 31 is the sign bit
    cols = np.arange(v)
    allowed = (bm[:, cols // 32].astype(np.int64) >> (cols % 32)) & 1
    np.testing.assert_array_equal(np.isfinite(t), allowed.astype(bool))


@pytest.mark.parametrize("indices", [[0, 2, 5], [4, 1], [-1, 3], [6, 0, 9]])
def test_apply_token_bitmask_with_indices_matches_jax(indices):
    """Row indices[i] takes bitmask row i; -1 and indices past B drop
    their row; untargeted rows stay unmasked."""
    rng = np.random.default_rng(len(indices))
    v = 300
    x = rng.standard_normal((B, v)).astype(np.float32)
    bm = _bitmask(rng, len(indices), v)
    idx = np.array(indices, np.int32)
    j = np.asarray(jgrammar.apply_token_bitmask(jnp.asarray(x), jnp.asarray(bm),
                                                jnp.asarray(idx)))
    t = tgrammar.apply_token_bitmask(torch.from_numpy(x), torch.from_numpy(bm),
                                     torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(j, t)
    untouched = sorted(set(range(B)) - set(i for i in indices if 0 <= i < B))
    np.testing.assert_array_equal(t[untouched], x[untouched])
