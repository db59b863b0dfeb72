"""The port's GDN surface beyond the decode step against the JAX package on
the CPU: the triangular inverse, the chunked gated delta rule (dense and
varlen) and its per-chunk cumsum, the recurrent rule over token sequences
(MTP), and fused_gdn_gating_without_sigmoid. The same seeded numpy inputs go
to both packages; the JAX functions run eagerly (plain jnp, no Pallas
kernel), the port's with device="cpu" tensors.

Tolerances, each with its reason:
  * fused_gdn_gating_without_sigmoid: exact where the arithmetic is the same
    (b passed through), g within a few f32 ulps (XLA's CPU exp and log1p
    approximate);
  * the cumsum: within 1e-6 of max|ref| (XLA's CPU cumsum is an
    associative scan, which adds in another order than a running sum);
  * tri_inv: within 1e-6 of max|ref| (f32 matmuls of up to 64 terms, summed
    in another order by torch's CPU GEMM than by XLA's);
  * the chunked rule: within 2e-6 of max|ref| (output and final state; 3.3e-7
    when this was measured): the WY products and the inverse compound the
    f32 order differences over the chunks, and l2norm's rstd is the port's
    float64 rule where XLA's CPU rsqrt approximates (ROADMAP Queue 3);
  * the recurrent rule: within 1e-5 of max|ref| (f32 contractions of 16-32
    terms in another order, and l2norm's rstd as above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import gdn as jgdn
from sgl_kernel_npu_tpu_torch.ops import gdn as tgdn

ULPS = 2e-6


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, want, share, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= share * np.abs(want).max(), (name, err, np.abs(want).max())


# ------------------------------------------------------------------ tri_inv


@pytest.mark.parametrize("n", [16, 32, 64])
def test_tri_inv_matches_jax(n):
    """inv_unit_lower, tri_inv_col_sweep and solve_tril at n 16, 32 and 64
    on a batch of strictly lower-triangular matrices of the chunked rule's
    scale; each also inverts (I - A) to within 1e-5."""
    rng = np.random.default_rng(n)
    a = np.tril(rng.standard_normal((3, n, n)) * 0.3, -1).astype(np.float32)
    m = (np.eye(n, dtype=np.float32) - a).astype(np.float32)
    full = (a + np.triu(rng.standard_normal((n, n)).astype(np.float32))).astype(np.float32)
    for jfn, tfn, arg in ((jgdn.inv_unit_lower, tgdn.inv_unit_lower, a),
                          (jgdn.tri_inv_col_sweep, tgdn.tri_inv_col_sweep, m),
                          (jgdn.solve_tril, tgdn.solve_tril, full)):
        want = np.asarray(jfn(jnp.asarray(arg)))
        got = tfn(_t(arg)).numpy()
        _close(got, want, 1e-6, tfn.__name__)
        ident = np.matmul(np.eye(n) - np.tril(arg if tfn is not tgdn.tri_inv_col_sweep
                                              else a, -1), got.astype(np.float64))
        assert np.abs(ident - np.eye(n)).max() < 1e-5, tfn.__name__


# ------------------------------------------------------------------ chunked


@pytest.mark.parametrize("reverse", [False, True])
def test_chunk_local_cumsum_matches_jax(reverse):
    """Forward and reverse, T 37 over chunks of 16 (a partial last chunk)."""
    g = np.random.default_rng(3).standard_normal((2, 37, 3)).astype(np.float32)
    want = np.asarray(jgdn.chunk_local_cumsum(jnp.asarray(g), 16, reverse=reverse))
    got = tgdn.chunk_local_cumsum(_t(g), 16, reverse=reverse)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6)


def _chunk_inputs(rng, b, t, h, dk, dv):
    q = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, t, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    g = (-np.abs(rng.standard_normal((b, t, h))) * 0.3).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((b, t, h))))).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dv)) * 0.1).astype(np.float32)
    return q, k, v, g, beta, s0


@pytest.mark.parametrize("l2,init", [(True, True), (False, False), (True, False)],
                         ids=["l2-init", "plain", "l2"])
def test_chunk_gated_delta_rule_matches_jax(l2, init):
    """B 2, T 41 (not a multiple of the chunk of 16), 3 heads of 32 / 16,
    with and without initial_state and the qk l2norm; output and final
    state within 2e-6 of max|ref| (module docstring). Without the l2norm the
    keys are scaled down so the recurrence stays contractive."""
    rng = np.random.default_rng(5 + 2 * l2 + init)
    q, k, v, g, beta, s0 = _chunk_inputs(rng, 2, 41, 3, 32, 16)
    if not l2:
        q, k = q * np.float32(0.15), k * np.float32(0.15)
    kw = dict(chunk_size=16, output_final_state=True, use_qk_l2norm_in_kernel=l2)
    jo, js = jgdn.chunk_gated_delta_rule(*(jnp.asarray(x) for x in (q, k, v, g, beta)),
                                         initial_state=jnp.asarray(s0) if init else None, **kw)
    to, ts = tgdn.chunk_gated_delta_rule(*(_t(x) for x in (q, k, v, g, beta)),
                                         initial_state=_t(s0) if init else None, **kw)
    assert to.dtype == torch.float32 and ts.dtype == torch.float32
    _close(to.numpy(), jo, 2e-6, "out")
    _close(ts.numpy(), js, 2e-6, "state")
    assert tgdn.chunk_gated_delta_rule(*(_t(x) for x in (q, k, v, g, beta)),
                                       chunk_size=16)[1] is None


def test_chunk_gated_delta_rule_varlen_matches_jax():
    """Uneven cu_seqlens (0, 5, 21, 22, 50: lengths 5, 16, 1, 28) over flat
    [1, 50] inputs, 2 qk heads repeated to 4 v heads, chunks of 8, initial
    states, max_seq_len 32; padding positions are frozen (decay 0)."""
    rng = np.random.default_rng(9)
    total, hq, hv, dk, dv = 50, 2, 4, 16, 16
    q = rng.standard_normal((1, total, hq, dk)).astype(np.float32)
    k = rng.standard_normal((1, total, hq, dk)).astype(np.float32)
    v = rng.standard_normal((1, total, hv, dv)).astype(np.float32)
    g = (-np.abs(rng.standard_normal((1, total, hv))) * 0.3).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((1, total, hv))))).astype(np.float32)
    cu = np.array([0, 5, 21, 22, 50], np.int32)
    s0 = (rng.standard_normal((4, hv, dk, dv)) * 0.1).astype(np.float32)
    jo, js = jgdn.chunk_gated_delta_rule_varlen(
        *(jnp.asarray(x) for x in (q, k, v, g, beta, cu, s0)), max_seq_len=32, chunk_size=8)
    to, ts = tgdn.chunk_gated_delta_rule_varlen(*(_t(x) for x in (q, k, v, g, beta, cu, s0)),
                                                max_seq_len=32, chunk_size=8)
    assert to.shape == (1, total, hv, dv) and ts.shape == (4, hv, dk, dv)
    _close(to.numpy(), jo, 2e-6, "out")
    _close(ts.numpy(), js, 2e-6, "state")


# ---------------------------------------------------------------- recurrent


def _recurrent_inputs(rng, t, nk, nv, dk, dv, slots):
    mix = rng.standard_normal((t, 2 * nk * dk + nv * dv)).astype(np.float32)
    state = (rng.standard_normal((slots, nv, dv, dk)) * 0.1).astype(np.float32)
    beta = rng.standard_normal((t, nv)).astype(np.float32)
    g = (-np.abs(rng.standard_normal((t, nv))) * 0.3).astype(np.float32)
    return mix, state, beta, g


@pytest.mark.parametrize("case", ["plain", "accepted", "intermediate"])
def test_recurrent_gated_delta_rule_matches_jax(case):
    """Three sequences of 3, 1 and 4 tokens, 2 qk heads over 4 v heads of 16
    (plain: each token its own slot of 12; accepted: num_accepted_tokens 2,
    1, 3 pick each sequence's start; intermediate: a [4 lines, 4 steps]
    cache seeded at step 0 from the recurrent state, slots that repeat
    within a sequence, so a later step wins). Output and new state within
    1e-5 of max|ref|; the inputs unchanged."""
    rng = np.random.default_rng({"plain": 1, "accepted": 2, "intermediate": 3}[case])
    nk, nv, dk, dv = 2, 4, 16, 16
    lens = np.array([3, 1, 4], np.int32)
    t = int(lens.sum())
    mix, state, beta, g = _recurrent_inputs(rng, t, nk, nv, dk, dv, 12)
    idx = np.array([0, 5, 7, 3, 9, 2, 11, 4], np.int32)
    kw, jkw = {}, {}
    if case == "accepted":
        acc = np.array([2, 1, 3], np.int32)
        kw["num_accepted_tokens"], jkw["num_accepted_tokens"] = _t(acc), jnp.asarray(acc)
    if case == "intermediate":
        inter = (rng.standard_normal((4, 4, nv, dv, dk)) * 0.1).astype(np.float32)
        ci = np.array([1, 3, 0], np.int32)
        idx = np.array([4, 5, 5, 12, 0, 1, 1, 2], np.int32)     # line * 4 + step
        kw.update(intermediate_state=_t(inter), cache_indices=_t(ci))
        jkw.update(intermediate_state=jnp.asarray(inter), cache_indices=jnp.asarray(ci))
    args = (mix, state, beta, None, lens, idx)
    jo, js = jgdn.recurrent_gated_delta_rule(*(None if a is None else jnp.asarray(a)
                                               for a in args), nk, nv, g=jnp.asarray(g), **jkw)
    targs = [None if a is None else _t(a) for a in args]
    before = [a.clone() for a in targs if a is not None]
    to, ts = tgdn.recurrent_gated_delta_rule(*targs, nk, nv, g=_t(g), **kw)
    assert all(torch.equal(a, b) for a, b in zip([a for a in targs if a is not None], before))
    assert to.shape == (t, nv, dv) and tuple(ts.shape) == np.asarray(js).shape
    _close(to.numpy(), jo, 1e-5, "out")
    _close(ts.numpy(), js, 1e-5, "state")


# ------------------------------------------------------------------- gating


def test_fused_gdn_gating_without_sigmoid_matches_jax():
    """g within a few f32 ulps (XLA's CPU exp and log1p), b passed through
    bit-equal and unchanged in dtype, a above the softplus threshold taken
    as it is."""
    rng = np.random.default_rng(17)
    a_log = (rng.standard_normal(6) * 0.2).astype(np.float32)
    a = (rng.standard_normal((5, 6)) * 10).astype(np.float32)
    a[0, 0] = 40.0
    b = rng.standard_normal((5, 6)).astype(np.float32)
    dt = (rng.standard_normal(6) * 0.2).astype(np.float32)
    jg, jb = jgdn.fused_gdn_gating_without_sigmoid(*(jnp.asarray(x) for x in (a_log, a, b, dt)))
    tb_in = _t(b).to(torch.bfloat16)
    tg, tb = tgdn.fused_gdn_gating_without_sigmoid(_t(a_log), _t(a), tb_in, _t(dt))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=ULPS, atol=1e-7)
    assert tb is tb_in
    assert np.array_equal(tgdn.fused_gdn_gating_without_sigmoid(
        _t(a_log), _t(a), _t(b), _t(dt))[1].numpy(), np.asarray(jb))
