"""The port's conv ops (ops/mamba.py) beyond the single-token decode update
against the JAX package on the CPU: causal_conv1d_fn with initial states and
seqlens, the varlen prefill, the [B, dim, S] speculative update with its
intermediate windows, conv_state_rollback and move_intermediate_cache. The
same seeded numpy inputs go to both packages; the JAX functions run eagerly,
the port's with device="cpu" tensors, updating their states in place.

Tolerances: states, windows, the rollback and the cache move are copies,
exact. The conv outputs sum the width taps in the same order in f32 on both
sides and are exact without an activation; with silu they are within a few
f32 ulps (rtol 2e-6), XLA's CPU logistic approximating otherwise than
torch.sigmoid, and so is the speculative update's, which the JAX package
also sums as a jnp.sum over the taps (XLA's reduce, another order than the
port's running sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import mamba as jm
from sgl_kernel_npu_tpu_torch.ops import mamba as tm

ULPS = 2e-6


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _conv_params(rng, dim, w):
    return (rng.standard_normal((dim, w)).astype(np.float32),
            rng.standard_normal(dim).astype(np.float32))


@pytest.mark.parametrize("init,final", [(True, True), (False, True), (False, False)],
                         ids=["init-final", "final", "plain"])
def test_causal_conv1d_fn_matches_jax(init, final):
    """x [3, 24, 11], width 4, silu, with and without initial states, final
    states at seqlens 11, 5 and 1 (the last from the initial state); bf16
    inputs without an activation too (exact), for the output's cast."""
    rng = np.random.default_rng(3 + init + 2 * final)
    b, dim, t, w = 3, 24, 11, 4
    x = rng.standard_normal((b, dim, t)).astype(np.float32)
    wt, bias = _conv_params(rng, dim, w)
    st = rng.standard_normal((b, dim, w - 1)).astype(np.float32) if init else None
    seq = np.array([11, 5, 1], np.int32)
    jy, jf = jm.causal_conv1d_fn(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                 None if st is None else jnp.asarray(st),
                                 return_final_states=final, seqlens=jnp.asarray(seq))
    ty, tf = tm.causal_conv1d_fn(_t(x), _t(wt), _t(bias), None if st is None else _t(st),
                                 return_final_states=final, seqlens=_t(seq))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ULPS, atol=1e-7)
    if final:
        assert np.array_equal(tf.numpy(), np.asarray(jf))
    else:
        assert tf is None
    xb = jnp.asarray(x, jnp.bfloat16)
    jyb, _ = jm.causal_conv1d_fn(xb, jnp.asarray(wt), None, activation=None)
    tyb, _ = tm.causal_conv1d_fn(_t(np.asarray(xb, np.float32)).to(torch.bfloat16), _t(wt),
                                 None, activation=None)
    assert tyb.dtype == torch.bfloat16
    assert np.array_equal(tyb.float().numpy(), np.asarray(jyb, np.float32))


@pytest.mark.parametrize("states", [True, False], ids=["initial-states", "zeros"])
def test_causal_conv1d_varlen_matches_jax(states):
    """Four sequences of 7, 1, 12 and 3 tokens over flat [20, 23] inputs,
    max_seq_len 16, conv states from lines 4, 0, 2, 5 of 6 with
    has_initial_state 1, 0, 1, 1: output (silu) within a few f32 ulps, final
    states exact."""
    rng = np.random.default_rng(7 + states)
    dim, w = 20, 4
    qsl = np.array([0, 7, 8, 20, 23], np.int32)
    x = rng.standard_normal((dim, int(qsl[-1]))).astype(np.float32)
    wt, bias = _conv_params(rng, dim, w)
    kw, jkw = {}, {}
    if states:
        cs = rng.standard_normal((6, dim, w - 1)).astype(np.float32)
        ci = np.array([4, 0, 2, 5], np.int32)
        hi = np.array([True, False, True, True])
        kw = dict(conv_states=_t(cs), cache_indices=_t(ci), has_initial_state=_t(hi))
        jkw = dict(conv_states=jnp.asarray(cs), cache_indices=jnp.asarray(ci),
                   has_initial_state=jnp.asarray(hi))
    jy, jf = jm.causal_conv1d_varlen(jnp.asarray(x), jnp.asarray(qsl), jnp.asarray(wt),
                                     jnp.asarray(bias), max_seq_len=16, **jkw)
    ty, tf = tm.causal_conv1d_varlen(_t(x), _t(qsl), _t(wt), _t(bias), max_seq_len=16, **kw)
    assert ty.shape == (dim, 23) and tf.shape == (4, dim, w - 1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ULPS, atol=1e-7)
    assert np.array_equal(tf.numpy(), np.asarray(jf))


def test_causal_conv1d_update_speculative_matches_jax():
    """The [B, dim, S] form: 5 rows of 3 draft tokens each over 7 cache
    lines of state_len 5 (wider than width - 1), one row at pad_slot_id
    (its line keeps its state), intermediate windows returned in the
    buffer's dtype: output within a few f32 ulps, the state (in place) and
    the windows exact; the decode form of the same rows' first token equals
    the speculative form's first step."""
    rng = np.random.default_rng(11)
    b, dim, s, lines, sl, w = 5, 16, 3, 7, 5, 4
    x = rng.standard_normal((b, dim, s)).astype(np.float32)
    st = rng.standard_normal((lines, dim, sl)).astype(np.float32)
    wt, bias = _conv_params(rng, dim, w)
    ci = np.array([6, 2, -1, 0, 4], np.int32)
    buf = np.zeros((b, s, dim, sl), np.float32)
    jy, jst, jint = jm.causal_conv1d_update(
        jnp.asarray(x), jnp.asarray(st), jnp.asarray(wt), jnp.asarray(bias), activation="silu",
        conv_state_indices=jnp.asarray(ci), intermediate_conv_window=jnp.asarray(buf))
    tst = _t(st)
    ty, tst2, tint = tm.causal_conv1d_update(_t(x), tst, _t(wt), _t(bias), activation="silu",
                                             conv_state_indices=_t(ci),
                                             intermediate_conv_window=_t(buf))
    assert tst2 is tst and ty.shape == (b, dim, s) and tint.shape == (b, s, dim, sl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ULPS, atol=1e-7)
    assert np.array_equal(tst.numpy(), np.asarray(jst))
    assert np.array_equal(tst.numpy()[[1, 3, 5]], st[[1, 3, 5]])
    assert np.array_equal(tint.numpy(), np.asarray(jint))
    one = _t(st)
    y1, _ = tm.causal_conv1d_update(_t(x[..., 0]), one, _t(wt), _t(bias), activation="silu",
                                    conv_state_indices=_t(ci))
    assert torch.equal(y1, ty[..., 0])


@pytest.mark.parametrize("draft", [4, 2])
def test_conv_state_rollback_matches_jax(draft):
    """[2 layers, 6 lines, window 5, dims 8]: requests on lines 1, 4, 0, 3
    at steps 0, draft - 1 (no shift), -1 (skipped) and 1; in place, exact."""
    rng = np.random.default_rng(13 + draft)
    cs = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    si = np.array([1, 4, 0, 3], np.int32)
    steps = np.array([0, draft - 1, -1, 1], np.int32)
    want = np.asarray(jm.conv_state_rollback(jnp.asarray(cs), jnp.asarray(si),
                                             jnp.asarray(steps), draft))
    tcs = _t(cs)
    got = tm.conv_state_rollback(tcs, _t(si), _t(steps), draft)
    assert got is tcs and np.array_equal(tcs.numpy(), want)
    assert np.array_equal(tcs.numpy()[:, [0, 2, 4, 5]], cs[:, [0, 2, 4, 5]])


def test_move_intermediate_cache_matches_jax():
    """ssm_states [2, 5, 2, 4, 3] take intermediate_state_cache [2, 4, 3,
    2, 4, 3] rows (src 3, 0, 2 at last steps 2, 0, 1) into lines 4, 1, 0;
    in place, exact, the other lines untouched."""
    rng = np.random.default_rng(19)
    ssm = rng.standard_normal((2, 5, 2, 4, 3)).astype(np.float32)
    cache = rng.standard_normal((2, 4, 3, 2, 4, 3)).astype(np.float32)
    dst, src, last = (np.array(a, np.int32) for a in ([4, 1, 0], [3, 0, 2], [2, 0, 1]))
    want = np.asarray(jm.move_intermediate_cache(*(jnp.asarray(a)
                                                   for a in (ssm, cache, dst, src, last))))
    tssm = _t(ssm)
    got = tm.move_intermediate_cache(tssm, *(_t(a) for a in (cache, dst, src, last)))
    assert got is tssm and np.array_equal(tssm.numpy(), want)
    assert np.array_equal(tssm.numpy()[:, [2, 3]], ssm[:, [2, 3]])
