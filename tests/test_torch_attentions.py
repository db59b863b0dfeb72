"""The port's `attentions` surface against the JAX package on the CPU: laser
attention and the varlen prefill (prefill.py, kernel K17's plain version),
the sparse-block estimator (sparse.py, K18's), block-sparse attention, the
top-k sparse decodes (K19's) and the block-sparse paged prefill
(paged_prefill.py, on K15).

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas); the port runs its plain PyTorch
versions (CPU tensors); chip_smoke.py holds the CUDA kernels against those
on the card.

Tolerances, each with its reason:
  * the estimator's masks and counts, block_mask_to_page_lists: exact (the
    scores differ in f32 rounding only, and no score of these inputs lies
    that close to its row's threshold);
  * laser, varlen, block-sparse and the top-k decodes on f32 inputs: 1e-5 of
    max|JAX| (the same f32 math, the sums in another order; the JAX wrapper
    and the port's blocked version differ also in block order);
  * on bf16 outputs (the paged prefill): one bf16 ulp of the JAX value plus
    1e-4 of max|JAX| (tests/test_torch_hm.py's bar for K15).
Two faults of the reference are asserted: the TPU laser kernel gives NaN
when T is not a multiple of its block, and the TPU top-k block kernel gives
a row whose ids are all -1 the mean of block 0's V rows (not 0).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sgl_kernel_npu_tpu.ops.attention import paged_prefill as jpp
from sgl_kernel_npu_tpu.ops.attention import prefill as jpf
from sgl_kernel_npu_tpu.ops.attention import sparse as jsp
from sgl_kernel_npu_tpu_torch import _build
from sgl_kernel_npu_tpu_torch.ops.attention import paged_prefill as tpp
from sgl_kernel_npu_tpu_torch.ops.attention import prefill as tpf
from sgl_kernel_npu_tpu_torch.ops.attention import sparse as tsp

from .test_torch_mla import assert_bf16_close

F32_SHARE = 1e-5
BF16_SHARE = 1e-4


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, name="", share=F32_SHARE):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=share * np.abs(w).max(), err_msg=name)


def _randn(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ laser


@pytest.mark.parametrize("causal", [True, False])
def test_laser_blocked_matches_jax_kernel(rng, causal):
    """K17's plain version against the interpreted TPU kernel at the JAX
    test's shape (T 64, blocks of 32)."""
    b, h, t, d = 2, 4, 64, 32
    q, k, v = (_randn(rng, (b, h, t, d)) for _ in range(3))
    want = jpf.laser_attention_pallas(*(jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v)),
                                      0.17, causal, block_q=32, block_k=32)
    got = tpf.laser_attention_blocked_ref(_t(q), _t(k), _t(v), 0.17, causal, block=32)
    _close(got.reshape(b * h, t, d), want, f"causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_laser_wrapper_gqa_at_the_gate(rng, causal):
    """Through both wrappers at T 512 (the JAX kernel's gate) with GQA 4 / 2:
    the JAX one repeats K and V and runs its kernel, the port's runs the
    blocked plain version on the kv heads where they are."""
    b, hq, hkv, t, d = 1, 4, 2, 512, 32
    q = _randn(rng, (b, hq, t, d))
    k, v = _randn(rng, (b, hkv, t, d)), _randn(rng, (b, hkv, t, d))
    want = jpf.laser_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.2, causal)
    got = tpf.laser_attention(_t(q), _t(k), _t(v), 0.2, causal)
    _close(got, want, f"causal={causal}")
    _close(got, tpf.laser_attention_ref(_t(q), _t(k), _t(v), 0.2, causal), "vs one softmax")


def test_laser_below_the_gate_is_the_reference(rng):
    """Below T 512 both wrappers run laser_attention_ref."""
    q, k, v = (_randn(rng, (2, 2, 64, 16)) for _ in range(3))
    want = jpf.laser_attention(*(jnp.asarray(x) for x in (q, k, v)), 0.25)
    got = tpf.laser_attention(_t(q), _t(k), _t(v), 0.25)
    _close(got, want)
    _close(got, jpf.laser_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), 0.25))


@pytest.mark.parametrize("causal", [True, False])
def test_laser_blocked_ragged_t_matches_jax_reference(rng, causal):
    """K17's plain version at a T that is not a multiple of its block (T 1000,
    blocks of 256: a last block of 232 columns, ragged also against K17's
    128-row tiles) with GQA 4 / 2, against the JAX package's one-softmax
    laser_attention_ref (its kernel gives NaN there)."""
    b, hq, hkv, t, d = 1, 4, 2, 1000, 32
    q = _randn(rng, (b, hq, t, d))
    k, v = _randn(rng, (b, hkv, t, d)), _randn(rng, (b, hkv, t, d))
    got = tpf.laser_attention_blocked_ref(_t(q), _t(k), _t(v), 0.2, causal, block=256)
    want = jpf.laser_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), 0.2, causal)
    _close(got, want, f"causal={causal}")


@pytest.mark.parametrize("causal", [True, False])
def test_laser_tpu_kernel_nan_when_t_is_not_a_block_multiple(rng, causal):
    """The reference's fault: at T 96 with blocks of 64 the TPU kernel reads
    the rows past T into its last block and returns NaN; the port masks
    columns >= T and equals laser_attention_ref."""
    b, h, t, d = 1, 2, 96, 32
    q, k, v = (_randn(rng, (b, h, t, d)) for _ in range(3))
    jax_kernel = jpf.laser_attention_pallas(
        *(jnp.asarray(x.reshape(b * h, t, d)) for x in (q, k, v)), 0.2, causal,
        block_q=64, block_k=64)
    assert np.isnan(np.asarray(jax_kernel)).any()
    got = tpf.laser_attention_blocked_ref(_t(q), _t(k), _t(v), 0.2, causal, block=64)
    assert torch.isfinite(got).all()
    want = jpf.laser_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), 0.2, causal)
    _close(got, want, f"causal={causal}")


def test_prefill_attention_varlen(rng):
    t, hq, hkv, d = 24, 4, 2, 16
    cu = np.array([0, 10, 24], np.int32)
    q = _randn(rng, (t, hq, d))
    k, v = _randn(rng, (t, hkv, d)), _randn(rng, (t, hkv, d))
    want = jpf.prefill_attention_varlen(*(jnp.asarray(x) for x in (q, k, v, cu)), 0.25)
    got = tpf.prefill_attention_varlen(_t(q), _t(k), _t(v), _t(cu), 0.25)
    _close(got, want)


# -------------------------------------------------------------- estimator


def _estimator_inputs(rng, b=2, h=2, t=256, d=128):
    return _randn(rng, (b, h, t, d)), _randn(rng, (b, h, t, d))


def _jax_block_scores(q, k, bs, causal):
    """The interpreted TPU kernel's block scores of q [BH, NQ*bs, 128], k
    [BH, NK*bs, 128]."""
    bh, nq, nk = q.shape[0], q.shape[1] // bs, k.shape[1] // bs
    return pl.pallas_call(
        partial(jsp._estimate_kernel, block_size=bs, nq=nq, nk=nk, causal=causal),
        grid=(bh,),
        in_specs=[pl.BlockSpec((1, nq * bs, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, nk * bs, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, nq, nk), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, nq, nk), jnp.float32),
        interpret=True)(jnp.asarray(q), jnp.asarray(k))


@pytest.mark.parametrize("keep_ratio", [0.25, 1.0])
def test_estimate_fused_matches_jax_kernel(rng, keep_ratio):
    """K18's tier against sparse_block_estimate_pallas (interpreted): masks
    and counts equal; keep 1.0 gives the full causal mask."""
    q, k = _estimator_inputs(rng)
    jm, jc = jsp.sparse_block_estimate_pallas(jnp.asarray(q), jnp.asarray(k), 64,
                                              keep_ratio=keep_ratio)
    tm, tc = tsp.sparse_block_estimate_fused(_t(q), _t(k), 64, keep_ratio=keep_ratio)
    assert tm.dtype == torch.bool and tc.dtype == torch.int32
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    if keep_ratio == 1.0:
        assert torch.equal(tm, torch.ones(4, 4, dtype=torch.bool).tril().expand_as(tm))


def test_block_scores_match_the_jax_kernel(rng):
    """K18's plain scores against the interpreted kernel's (not causal, so
    every score is compared): f32 order only."""
    q, k = _estimator_inputs(rng, b=1, h=3)
    want = _jax_block_scores(q[0], k[0], 64, False)
    got = tsp.block_scores_ref(_t(q[0]), _t(k[0]), 64, causal=False)
    _close(got, want)


def _scores_close(got, want):
    """Block scores: the causal -1e30 entries equal, the others within
    F32_SHARE of the largest |score| (f32 sums in another order)."""
    g, w = _np(got), _np(want)
    live = w > -1e29
    assert np.array_equal(g[~live], w[~live])
    np.testing.assert_allclose(g[live], w[live], rtol=0,
                               atol=F32_SHARE * np.abs(w[live]).max())


def _masks_agree(got, want, scores, keep):
    """Masks equal, except entries whose score lies within F32_SHARE of the
    row's largest |score| from its row's threshold (chip_smoke.py's
    _mask_flips bar)."""
    got, want, scores = np.asarray(got), np.asarray(want), _np(scores)
    thresh = np.sort(scores, axis=-1)[..., -keep][..., None]
    top = np.where(scores < -1e29, 0, np.abs(scores)).max(-1, keepdims=True)
    near = np.abs(scores - thresh) <= F32_SHARE * top
    assert not ((got != want) & ~near).any()


@pytest.mark.parametrize("causal", [True, False])
def test_estimate_above_the_old_cap_matches_jax_kernel(rng, causal):
    """[1, 2, 3200, 128] in blocks of 16: NQ + NK = 400, past the 384 pooled
    rows K18 once kept in shared memory. The plain scores against the
    interpreted kernel's, and the fused tier's mask and counts against
    sparse_block_estimate_pallas's (interpreted)."""
    bs, t = 16, 3200
    q, k = _estimator_inputs(rng, b=1, h=2, t=t)
    want = _jax_block_scores(q[0], k[0], bs, causal)
    _scores_close(tsp.block_scores_ref(_t(q[0]), _t(k[0]), bs, causal=causal), want)
    jm, jc = jsp.sparse_block_estimate_pallas(jnp.asarray(q), jnp.asarray(k), bs,
                                              causal=causal)
    tm, tc = tsp.sparse_block_estimate_fused(_t(q), _t(k), bs, causal=causal)
    n = t // bs
    _masks_agree(tm.numpy(), np.asarray(jm), np.asarray(want).reshape(1, 2, n, n),
                 max(1, int(n * 0.25)))
    assert np.array_equal(tc.numpy(), tm.numpy().sum(-1))


@pytest.mark.parametrize("bh,nq,nk,tile", [
    (8, 64, 64, 32),        # [1, 8, 8192] in blocks of 128: 8 tiles of 64
    (64, 32, 32, 32),       # [4, 16, 4096]: 64
    (8, 256, 256, 64),      # [1, 8, 32768]: 128
    (8, 256, 64, 32),       # T 32768 against 8192
    (2, 200, 200, 32)])
def test_estimate_plan(bh, nq, nk, tile):
    """K18's plan on a card of 132 SMs: tiles of 64 where they alone give
    half the SMs one, the workspace one pooled f32 row per block."""
    assert tsp.estimate_plan(bh, nq, nk, 132) == (tile, (bh, nq + nk, 128))


def _k18_tiles(q, k, bs, causal, tile):
    """K18's two kernels in PyTorch, block by block: the pooled rows into the
    workspace, then each tile's scores, the tiles wholly above the
    diagonal written -1e30 without a product."""
    bh, nq, nk = q.shape[0], q.shape[1] // bs, k.shape[1] // bs
    ws = torch.cat([q.float().reshape(bh, nq, bs, 128).sum(2),
                    k.float().reshape(bh, nk, bs, 128).sum(2)], dim=1)
    out = torch.full((bh, nq, nk), float("nan"))
    inv = np.float32(1.0) / np.float32(bs * bs)
    for z in range(bh):
        for i0 in range(0, nq, tile):
            for j0 in range(0, nk, tile):
                i = torch.arange(i0, min(i0 + tile, nq))[:, None]
                j = torch.arange(j0, min(j0 + tile, nk))[None, :]
                if causal and j0 > i0 + tile - 1:
                    out[z, i, j] = -1e30
                    continue
                qs = ws[z, i0:min(i0 + tile, nq)]
                ks = ws[z, nq + j0:nq + min(j0 + tile, nk)]
                sc = qs @ ks.T * float(inv)
                out[z, i, j] = torch.where(causal & (j > i), -1e30, sc)
    return out


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_k18_tiles_cover_every_score(rng, causal, tile):
    """K18's tiling (ragged tiles at both ends, tq != tk, the causal skip)
    writes every score once and matches the plain version."""
    bs = 4
    q, k = (torch.from_numpy(_randn(rng, (3, n * bs, 128))) for n in (100, 70))
    got = _k18_tiles(q, k, bs, causal, tile)
    assert not got.isnan().any()
    _scores_close(got, tsp.block_scores_ref(q, k, bs, causal=causal))


@pytest.mark.parametrize("case", ["kernel gate", "ragged", "causal off"])
def test_estimate_plain_and_dispatch_match_jax(rng, case):
    """The plain estimator (block means) and the dispatch, on shapes on
    both sides of the kernel gate (256 rows in blocks of 64; 200 rows: the
    last block padded), causal and not."""
    t = 200 if case == "ragged" else 256
    causal = case != "causal off"
    q, k = _estimator_inputs(rng, t=t)
    for jfn, tfn in ((jsp.sparse_block_estimate, tsp.sparse_block_estimate),
                     (jsp.sparse_block_estimate_dispatch, tsp.sparse_block_estimate_dispatch)):
        jm, jc = jfn(jnp.asarray(q), jnp.asarray(k), 64, keep_ratio=0.5, causal=causal)
        tm, tc = tfn(_t(q), _t(k), 64, keep_ratio=0.5, causal=causal)
        assert np.array_equal(np.asarray(jm), tm.numpy()), (case, jfn.__name__)
        assert np.array_equal(np.asarray(jc), tc.numpy()), (case, jfn.__name__)


@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_attention(rng, causal):
    """The dense reference tier with the estimator's mask; a query block
    with nothing selected gives 0."""
    b, h, t, d, bs = 1, 2, 64, 16, 16
    q, k, v = (_randn(rng, (b, h, t, d)) for _ in range(3))
    mask, _ = jsp.sparse_block_estimate(jnp.asarray(q), jnp.asarray(k), bs, keep_ratio=0.5)
    mask = np.array(mask)
    mask[0, 1, 2] = False                          # block row 2 of head 1: nothing
    want = jsp.block_sparse_attention(*(jnp.asarray(x) for x in (q, k, v, mask)), 0.3, bs,
                                      causal)
    got = tsp.block_sparse_attention(_t(q), _t(k), _t(v), _t(mask), 0.3, bs, causal)
    _close(got, want, f"causal={causal}")
    assert float(got[0, 1, 2 * bs:3 * bs].abs().max()) == 0.0


# ------------------------------------------------------------ top-k decode


def _topk_inputs(rng, b=4, h=8, d=128, dv=128, ps=128, pages=16, kb=24):
    q = _randn(rng, (b, h, d))
    kc, vc = _randn(rng, (pages, ps, d)), _randn(rng, (pages, ps, dv))
    nblocks = pages * ps // 8
    bids = np.stack([rng.choice(nblocks, kb, replace=False) for _ in range(b)]).astype(np.int32)
    bids[1, 10:] = -1                              # a row partly unused
    bids[3, :] = -1                                # a row with nothing selected
    tok = np.where(bids[..., None] >= 0, bids[..., None] * 8 + np.arange(8),
                   -1).reshape(b, kb * 8).astype(np.int32)
    return q, kc, vc, bids, tok


def test_topk_sparse_attention_and_dispatch(rng):
    q, kc, vc, _, tok = _topk_inputs(rng)
    seq = np.full((4,), 16 * 128, np.int32)
    args = (q, kc, vc, tok, seq)
    for jfn, tfn in ((jsp.topk_sparse_attention, tsp.topk_sparse_attention),
                     (jsp.topk_sparse_attention_dispatch, tsp.topk_sparse_attention_dispatch)):
        want = jfn(*(jnp.asarray(x) for x in args), 0.11, 128)
        got = tfn(*(_t(x) for x in args), 0.11, 128)
        _close(got, want, jfn.__name__)


@pytest.mark.parametrize("chunk", [8, 64])
def test_topk_block_sparse_matches_jax_kernel(rng, chunk):
    """K19's plain version against the interpreted TPU kernel (chunks of 8:
    three chunks, the partly unused row's last two all -1; 64: one chunk of
    24), and against the token-granular function over the same blocks
    expanded to tokens (rows with something selected)."""
    q, kc, vc, bids, tok = _topk_inputs(rng)
    want = jsp.topk_block_sparse_attention_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, bids)), 0.11, 128, chunk=chunk, nbuf=2)
    got = tsp.topk_block_sparse_attention(_t(q), _t(kc), _t(vc), _t(bids), 0.11, 128,
                                          chunk=chunk)
    _close(got, want, f"chunk={chunk}")
    token = tsp.topk_sparse_attention(_t(q), _t(kc), _t(vc), _t(tok), None, 0.11, 128)
    _close(got[:3], token[:3], "vs token-granular")


def test_topk_block_kernel_all_unused_row_is_block_zero_mean(rng):
    """The reference's fault, kept as the kernel's contract: a row whose ids
    are all -1 scores -1e30 everywhere, so p = 1 on every row of the chunk
    (each read from block 0) and the output is the mean of block 0's eight
    V rows, not 0; the token-granular function returns V of slot 0."""
    q, kc, vc, bids, tok = _topk_inputs(rng)
    want = np.asarray(jsp.topk_block_sparse_attention_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, bids)), 0.11, 128, chunk=8, nbuf=2))
    got = tsp.topk_block_sparse_attention(_t(q), _t(kc), _t(vc), _t(bids), 0.11, 128, chunk=8)
    mean0 = np.broadcast_to(vc[0, :8].mean(axis=0), want[3].shape)
    _close(want[3], mean0, "JAX kernel vs the mean")
    _close(got[3], want[3], "port vs JAX kernel")
    assert np.abs(want[3]).max() > 0.1
    token = tsp.topk_sparse_attention(_t(q), _t(kc), _t(vc), _t(tok), None, 0.11, 128)
    _close(token[3], np.broadcast_to(vc[0, 0], (8, 128)), "token-granular: slot 0")


# ---------------------------------------------------- block-sparse paged


def test_block_mask_to_page_lists_exact(rng):
    mask = rng.random((3, 5, 7)) < 0.4
    mask[1, 2] = False
    for m, max_sel in ((mask, 7), (mask, 3), (mask[0], 7)):
        jsel, jcnt = jpp.block_mask_to_page_lists(jnp.asarray(m), max_sel)
        tsel, tcnt = tpp.block_mask_to_page_lists(torch.from_numpy(m), max_sel)
        assert tsel.dtype == tcnt.dtype == torch.int32
        assert np.array_equal(np.asarray(jsel), tsel.numpy())
        assert np.array_equal(np.asarray(jcnt), tcnt.numpy())


@pytest.mark.parametrize("keep_ratio", [0.5, 1.0])
def test_block_sparse_paged_attention_with_estimator_mask(rng, keep_ratio):
    """bf16 hm pages of 16, T 64 at prefix 0, Llama's head ratio 4 / 1 per kv
    head: the estimator's mask per kv head drives K15's page lists. At keep
    1.0 the mask is full causal and the result is dense causal attention."""
    t, hq, hkv, d, ps = 64, 8, 2, 128, 16
    sm = d ** -0.5
    q = jnp.asarray(_randn(rng, (t, hq, d)), jnp.bfloat16)
    k = jnp.asarray(_randn(rng, (1, hkv, t, d)), jnp.bfloat16)
    v = jnp.asarray(_randn(rng, (1, hkv, t, d)), jnp.bfloat16)
    q8 = jnp.asarray(_randn(rng, (1, hkv, t, d)), jnp.bfloat16)
    jm, _ = jsp.sparse_block_estimate_pallas(q8, k, ps, keep_ratio=keep_ratio)
    tm, _ = tsp.sparse_block_estimate_dispatch(_t(q8), _t(k), ps, keep_ratio=keep_ratio)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    npages = t // ps
    perm = rng.permutation(npages + 1)[:npages].astype(np.int32)
    bt = jnp.asarray(perm)
    pages = [jnp.zeros((npages + 1, hkv, ps, d), jnp.bfloat16) for _ in range(2)]
    pages = [p.at[perm].set(x[0].reshape(hkv, npages, ps, d).transpose(1, 0, 2, 3))
             for p, x in zip(pages, (k, v))]
    want = jpp.block_sparse_paged_attention(q, tuple(pages), bt, jm[0], 0, sm, ps)
    got = tpp.block_sparse_paged_attention(_t(q), tuple(_t(p) for p in pages), _t(bt),
                                           tm[0], 0, sm, ps)
    assert got.dtype == torch.bfloat16 and got.shape == (t, hq, d)
    assert_bf16_close(_np(got), _np(want), BF16_SHARE, f"keep={keep_ratio}")
    if keep_ratio == 1.0:
        dense = tpf.laser_attention_ref(_t(q).permute(1, 0, 2)[None], _t(k), _t(v), sm)
        assert_bf16_close(_np(got), _np(dense[0].permute(1, 0, 2)), BF16_SHARE, "vs dense")


def test_cpu_tensors_launch_nothing(rng):
    """On CPU tensors every wrapper of this slice runs its plain version: no
    launch counter moves."""
    before = dict(_build.launches)
    q, k, v = (torch.from_numpy(_randn(rng, (1, 2, 512, 128))) for _ in range(3))
    tpf.laser_attention(q, k, v, 0.1)
    tsp.sparse_block_estimate_dispatch(q, k, 128)
    qd, kc, vc, bids, _ = _topk_inputs(rng)
    tsp.topk_block_sparse_attention(_t(qd), _t(kc), _t(vc), _t(bids), 0.1, 128)
    assert _build.launches == before
    for name in ("laser_attention", "sparse_estimate", "topk_block_sparse",
                 "add_rmsnorm_quant"):
        assert name in _build.KERNELS and _build.launches[name] == before[name]
