"""The `attentions` surface at the head dims and dtypes the TPU kernels take,
on the CPU: laser attention (K17's plain versions) at (D, Dv) (192, 128),
(256, 256), (64, 64), (96, 96), (32, 32) and (80, 80), K17's split-TF32
arithmetic emulated and held to its plain version, the sparse-block estimator
(K18's) at D 64, 192 and 256, the top-k block-sparse decode (K19's) at 4
and 71 heads of 64 and 256, each against the JAX package's kernel in
interpret mode (SKT_IMPL=pallas) on the same seeded numpy inputs; and the
routes the wrappers take on the card (prefill.laser_route and laser_tile,
K18's and K19's checks) at every width of their tables, with their refusals.

Bars, each with its reason:
  * f32 outputs: within 2e-5 of max|JAX| (the same f32 steps, the sums in
    another order, blocks in another order);
  * bf16 and fp16 outputs: one ulp of the output type (2^-7, 2^-10 of the
    JAX value) plus 1e-4 of max|JAX| (two f32 results a summation order
    apart round to neighbouring values);
  * the estimator's scores within 1e-5 of the largest |score| (f32 sums in
    another order); its masks equal, or flipped only where a score lies
    within that of its row's threshold; counts the masks' row sums.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sgl_kernel_npu_tpu.ops.attention import prefill as jpf
from sgl_kernel_npu_tpu.ops.attention import sparse as jsp
from sgl_kernel_npu_tpu_torch import _build
from sgl_kernel_npu_tpu_torch.ops.attention import prefill as tpf
from sgl_kernel_npu_tpu_torch.ops.attention import sparse as tsp

F32_SHARE = 2e-5
HALF_SHARE = 1e-4
SCORE_SHARE = 1e-5
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
LASER_WIDTHS = ((192, 128), (256, 256), (64, 64), (96, 96), (32, 32), (80, 80))
DTYPES = ("bfloat16", "float16", "float32")


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _both(x, dtype):
    """The f32 numpy array x in `dtype` for JAX and for the port (both round
    to nearest even)."""
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a, jnp.float32)).astype(np.float64)


def _close(got, want, dtype, name=""):
    """got against want by the bar of `dtype` (module docstring)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert np.isfinite(g).all(), name
    top = np.abs(w).max()
    if dtype == "float32":
        bound = F32_SHARE * top
    else:
        bound = ULP[dtype] * np.abs(w) + HALF_SHARE * top
    err = np.abs(g - w)
    assert (err <= bound).all(), (name, float(err.max()), float(np.max(err / bound)))


# ------------------------------------------------------------------ K17


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,dv", LASER_WIDTHS)
def test_laser_widths_match_jax_kernel(rng, d, dv, dtype, causal):
    """K17's plain version against the interpreted TPU kernel, both in blocks
    of 32, at T 64 over 2 heads (the TPU kernel takes K and V expanded to
    the query heads), Dv = D and not."""
    bh, t = 2, 64
    sm = d ** -0.5
    (jq, tq), (jk, tk), (jv, tv) = (_both(_randn(rng, (bh, t, w)), dtype)
                                    for w in (d, d, dv))
    want = jpf.laser_attention_pallas(jq, jk, jv, sm, causal, block_q=32, block_k=32)
    got = tpf.laser_attention_blocked_ref(tq[None], tk[None], tv[None], sm, causal, block=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, bh, t, dv)
    _close(got[0], want, dtype, f"D {d} Dv {dv} {dtype} causal={causal}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,dv", LASER_WIDTHS)
def test_laser_wrapper_gqa_ragged_matches_jax(rng, d, dv, dtype):
    """laser_attention with GQA 4 / 2 at T 100 (below the wrappers' gate:
    both run their one-softmax reference) against the JAX wrapper, and the
    blocked plain version at blocks of 32 (a last block of 4 columns)
    against the same; causal (the kernel test above holds both modes)."""
    b, hq, hkv, t, causal = 1, 4, 2, 100, True
    sm = 0.7 * d ** -0.5
    (jq, tq), (jk, tk), (jv, tv) = (_both(_randn(rng, shape), dtype) for shape in
                                    ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, dv)))
    want = jpf.laser_attention(jq, jk, jv, sm, causal)
    got = tpf.laser_attention(tq, tk, tv, sm, causal)
    assert got.shape == (b, hq, t, dv) and got.dtype == tq.dtype
    _close(got, want, dtype, "wrapper")
    blocked = tpf.laser_attention_blocked_ref(tq, tk, tv, sm, causal, block=32)
    _close(blocked, want, dtype, "blocked, ragged")


# bf16 / fp16 widths the laser_attention kernel takes on a larger tile (Phi-3,
# Phi-2, ...), and widths only the split-TF32 kernel takes
PADDED = ((96, 96), (32, 32), (80, 80), (128, 64), (256, 128), (200, 256), (8, 8), (136, 64))
GENERAL_ONLY = ((1, 1), (255, 255), (95, 95), (20, 36), (96, 90), (255, 250))
TC_TABLE = [(d, dv, dt) for d, dv in tpf.TENSOR_CORE_WIDTHS + PADDED
            for dt in ("bfloat16", "float16")]
GENERAL_TABLE = ([(d, dv, "float32") for d, dv in tpf.TENSOR_CORE_WIDTHS + PADDED + GENERAL_ONLY]
                 + [(d, dv, dt) for d, dv in GENERAL_ONLY for dt in ("bfloat16", "float16")])


@pytest.mark.parametrize("d,dv,dtype", TC_TABLE + GENERAL_TABLE)
def test_laser_route(d, dv, dtype):
    """The bf16 / fp16 kernel at its four widths and, padded, at every other
    pair of multiples of 8 up to 256; the split-TF32 kernel for f32 and for
    bf16 / fp16 at the other widths up to 256."""
    want = "laser_attention" if (d, dv, dtype) in TC_TABLE else "laser_attention_general"
    assert tpf.laser_route(d, dv, getattr(torch, dtype)) == want
    assert want in _build.KERNELS and want in _build.launches


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_laser_tile(d):
    """Every (d, dv) in multiples of 8 up to 256 runs on a member of
    TENSOR_CORE_WIDTHS that holds both, with the least Dp + Dvp of those
    that do; the four are their own tiles."""
    for dv in range(8, 257, 8):
        tile = tpf.laser_tile(d, dv)
        holds = [w for w in tpf.TENSOR_CORE_WIDTHS if w[0] >= d and w[1] >= dv]
        assert tile in holds, (d, dv, tile)
        assert all(sum(tile) <= sum(w) for w in holds), (d, dv, tile)
        if (d, dv) in tpf.TENSOR_CORE_WIDTHS:
            assert tile == (d, dv)


def test_laser_tile_named_widths():
    """Phi-3's 96 and Phi-2's 80 on (128, 128), as the card's phase 21 runs
    them; the widths of chip_smoke.py's LASER_EDGES on theirs."""
    want = {(96, 96): (128, 128), (80, 80): (128, 128), (128, 64): (128, 128),
            (8, 8): (64, 64), (64, 32): (64, 64), (136, 64): (192, 128), (192, 8): (192, 128),
            (200, 40): (256, 256), (64, 136): (256, 256), (256, 256): (256, 256)}
    for (d, dv), tile in want.items():
        assert tpf.laser_tile(d, dv) == tile, (d, dv)


@pytest.mark.parametrize("d,dv", [(d, 64) for d in (0, 1, 7, 12, 95, 100, 255, 257, 264, 512)]
                         + [(64, dv) for dv in (0, 4, 90, 250, 264)] + [(-8, 64)])
def test_laser_tile_other_widths(d, dv):
    """No tile where d or dv is not a multiple of 8 in 8..256."""
    assert tpf.laser_tile(d, dv) is None


@pytest.mark.parametrize("d,dv", [(257, 64), (64, 300), (512, 512), (0, 64), (576, 512)])
def test_laser_route_refuses_wider_than_both(d, dv):
    with pytest.raises(ValueError, match=r"\(64, 64\).*256"):
        tpf.laser_route(d, dv, torch.bfloat16)


def test_laser_route_refuses_other_dtypes():
    for dt in (torch.float64, torch.int8):
        with pytest.raises(TypeError, match="bf16, fp16 and f32"):
            tpf.laser_route(128, 128, dt)


def _tf32(x):
    """f32 rounded to TF32's 10 mantissa bits, to nearest, ties away from
    zero (the card's cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a, b, split=True):
    """a @ b in split TF32: hi = tf32(x), lo = tf32(x - hi), the three
    products hi . hi + hi . lo + lo . hi summed in f32 (lo . lo dropped);
    split=False: plain TF32, hi . hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def _split_tf32_laser(q, k, v, sm, causal, split=True):
    """K17's split-TF32 route (csrc/laser_attention_general.cu) emulated in
    f32 on the CPU: kv tiles of its BN (64 at padded width 32, else 32),
    base-2 scores, the online softmax, both products in split TF32 (p split
    too), out = acc / max(l, 1e-37). q [B, Hq, T, D], k, v [B, Hkv, T, D]."""
    b, hq, t, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = hq // hkv
    bn = 64 if max(d, dv) <= 32 else 32
    scale2 = float(np.float32(sm * 1.4426950408889634))
    qf = q.float().reshape(b, hkv, g, t, d)
    rows = torch.arange(t)[:, None]
    m = torch.full((b, hkv, g, t, 1), -1e30)
    l = torch.zeros((b, hkv, g, t, 1))
    acc = torch.zeros((b, hkv, g, t, dv))
    for c0 in range(0, t, bn):
        kb, vb = k[:, :, c0:c0 + bn].float(), v[:, :, c0:c0 + bn].float()
        s = _split_mm(qf, kb[:, :, None].transpose(-1, -2), split) * scale2
        cols = c0 + torch.arange(kb.shape[2])[None, :]
        keep = (rows >= cols) if causal else torch.ones_like(rows >= cols)
        s = torch.where(keep, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_mm(p, vb[:, :, None], split)
        m = m_new
    return (acc / l.clamp_min(1e-37)).reshape(b, hq, t, dv)


@pytest.mark.parametrize("scale", [1.0, 1e3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [96, 32])
def test_split_tf32_laser_within_f32_bar(rng, d, causal, scale):
    """The split-TF32 route's arithmetic, emulated, against the plain version
    (laser_attention_blocked_ref, all f32) within F32_SHARE of max|plain|,
    the bar chip_smoke.py's phase 21 holds the card's f32 rows to: 2 heads,
    T 256, randn inputs and inputs scaled by 1e3. Plain TF32 (hi . hi only)
    misses the bar on the randn inputs, so the bar tells the two apart."""
    t = 256
    q, k, v = (torch.from_numpy(scale * _randn(rng, (1, 2, t, d))) for _ in range(3))
    sm = d ** -0.5
    want = tpf.laser_attention_blocked_ref(q, k, v, sm, causal)
    got = _split_tf32_laser(q, k, v, sm, causal)
    _close(got, want, "float32", f"split TF32 D {d} causal={causal} x {scale:g}")
    if scale == 1.0:
        plain_tf32 = _split_tf32_laser(q, k, v, sm, causal, split=False)
        assert (plain_tf32 - want).abs().max() > F32_SHARE * want.abs().max()


# ------------------------------------------------------------------ K18


def _padded(x, bs):
    n = -(-x.shape[2] // bs)
    return np.pad(x, ((0, 0), (0, 0), (0, n * bs - x.shape[2]), (0, 0)))


def _jax_block_scores(q, k, bs, causal):
    """The interpreted TPU kernel's block scores of q [BH, NQ*bs, D], k
    [BH, NK*bs, D] at any D."""
    bh, d = q.shape[0], q.shape[2]
    nq, nk = q.shape[1] // bs, k.shape[1] // bs
    return pl.pallas_call(
        partial(jsp._estimate_kernel, block_size=bs, nq=nq, nk=nk, causal=causal),
        grid=(bh,),
        in_specs=[pl.BlockSpec((1, nq * bs, d), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, nk * bs, d), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, nq, nk), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, nq, nk), jnp.float32),
        interpret=True)(q, k)


def _masks_agree(got, want, scores, keep):
    """Masks equal, but for entries whose score lies within SCORE_SHARE of
    the row's largest |score| from its row's threshold."""
    got, want, scores = np.asarray(got), np.asarray(want), _np(scores)
    thresh = np.sort(scores, axis=-1)[..., -keep][..., None]
    top = np.where(scores < -1e29, 0, np.abs(scores)).max(-1, keepdims=True)
    near = np.abs(scores - thresh) <= SCORE_SHARE * top
    assert not ((got != want) & ~near).any()


@pytest.mark.parametrize("dtype", ("float16", "float32"))
@pytest.mark.parametrize("d", (64, 192, 256))
def test_estimate_widths_match_jax_kernel(rng, d, dtype):
    """K18's tier (the plain block scores on the CPU) against
    sparse_block_estimate_pallas (interpreted) at [1, 2, 200, D] in blocks of
    32 (both pad the last block): scores, masks and counts; causal in fp16,
    not causal in f32."""
    bs, t, causal = 32, 200, dtype == "float16"
    q, k = _randn(rng, (1, 2, t, d)), _randn(rng, (1, 2, t, d))
    (jq, tq), (jk, tk) = _both(q, dtype), _both(k, dtype)
    jm, jc = jsp.sparse_block_estimate_pallas(jq, jk, bs, causal=causal)
    tm, tc = tsp.sparse_block_estimate_fused(tq, tk, bs, causal=causal)
    n = -(-t // bs)
    qp, kp = (_both(_padded(x, bs), dtype) for x in (q, k))
    want = _jax_block_scores(qp[0].reshape(2, n * bs, d), kp[0].reshape(2, n * bs, d), bs,
                             causal)
    scores = tsp.block_scores_ref(qp[1].reshape(2, n * bs, d), kp[1].reshape(2, n * bs, d), bs,
                                  causal)
    g, w = _np(scores), _np(want)
    live = w > -1e29
    assert np.array_equal(g[~live], w[~live])
    assert np.abs(g[live] - w[live]).max() <= SCORE_SHARE * np.abs(w[live]).max()
    _masks_agree(tm.numpy(), np.asarray(jm), w.reshape(1, 2, n, n), max(1, int(n * 0.25)))
    assert np.array_equal(tc.numpy(), tm.numpy().sum(-1))


@pytest.mark.parametrize("d", (1, 3, 32, 64, 96, 130, 192, 256, 576, 1000))
@pytest.mark.parametrize("dtype", DTYPES)
def test_estimate_check_takes_every_width(d, dtype):
    """K18's check takes any D in bf16, fp16 and f32; its plan rounds the
    workspace's rows up to 4 floats."""
    q = torch.zeros((2, 64, d), dtype=getattr(torch, dtype))
    tsp.check_block_scores(q, q, 16)
    tile, ws = tsp.estimate_plan(2, 4, 4, 132, d)
    assert tile == 32 and ws == (2, 8, -(-d // 4) * 4)


def test_estimate_check_refusals():
    q = torch.zeros((2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16, fp16 or f32"):
        tsp.check_block_scores(q.double(), q.double(), 16)
    with pytest.raises(TypeError, match="one dtype"):
        tsp.check_block_scores(q, q.half(), 16)
    with pytest.raises(ValueError, match="multiples of the block"):
        tsp.check_block_scores(q, q, 24)
    with pytest.raises(ValueError, match="any D"):
        tsp.check_block_scores(q, q[..., :32], 16)


# ------------------------------------------------------------------ K19


def _topk_inputs(rng, b, h, d, dv, ps, pages, kb):
    q = _randn(rng, (b, h, d))
    kc, vc = _randn(rng, (pages, ps, d)), _randn(rng, (pages, ps, dv))
    nblocks = pages * ps // 8
    bids = np.stack([rng.choice(nblocks, kb, replace=False) for _ in range(b)]).astype(np.int32)
    bids[1, kb // 2:] = -1                         # a row partly unused
    bids[2, :] = -1                                # a row with nothing selected
    return q, kc, vc, bids


@pytest.mark.parametrize("d", (64, 256))
@pytest.mark.parametrize("h", (4, 71))
def test_topk_widths_fp16_match_jax_kernel(rng, h, d):
    """K19's plain version against the interpreted TPU kernel in fp16 at
    Gemma-3's 4 heads and Falcon-7B's 71 (past a multiple of 8 or 16) over
    one shared kv head, chunks of 8 (two chunks of 12 blocks a row); the
    row with nothing selected is the mean of block 0's V rows."""
    q, kc, vc, bids = _topk_inputs(rng, 3, h, d, d, 16, 16, 12)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float16") for x in (q, kc, vc))
    sm = d ** -0.5
    want = jsp.topk_block_sparse_attention_pallas(jq, jk, jv, jnp.asarray(bids), sm, 16,
                                                  chunk=8, nbuf=2)
    got = tsp.topk_block_sparse_attention(tq, tk, tv, torch.from_numpy(bids), sm, 16, chunk=8)
    assert got.dtype == torch.float16 and got.shape == (3, h, d)
    _close(got, want, "float16", f"H {h} D {d}")
    mean0 = _np(tv[0, :8]).mean(0)
    _close(got[2], np.broadcast_to(mean0, (h, d)).astype(np.float32), "float16", "block 0's mean")


@pytest.mark.parametrize("h", (1, 4, 71, 128))
@pytest.mark.parametrize("dtype", ("bfloat16", "float16"))
@pytest.mark.parametrize("d,dv", tsp.TOPK_DIMS)
def test_topk_check_table(d, dv, dtype, h):
    """K19's check takes its four widths in bf16 and fp16 at any head count."""
    dt = getattr(torch, dtype)
    q = torch.zeros((2, h, d), dtype=dt)
    tsp.check_topk(q, torch.zeros((2, 16, d), dtype=dt), torch.zeros((2, 16, dv), dtype=dt),
                   16, 64)


@pytest.mark.parametrize("d,dv", [(96, 96), (128, 64), (192, 128), (512, 512)])
def test_topk_check_refuses_other_widths(d, dv):
    q = torch.zeros((2, 4, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(576, 512\)"):
        tsp.check_topk(q, torch.zeros((2, 16, d), dtype=q.dtype),
                       torch.zeros((2, 16, dv), dtype=q.dtype), 16, 64)


def test_topk_check_refuses_f32():
    q = torch.zeros((2, 4, 64))
    with pytest.raises(TypeError, match="bf16 or fp16"):
        tsp.check_topk(q, torch.zeros((2, 16, 64)), torch.zeros((2, 16, 64)), 16, 64)


def test_cpu_tensors_launch_nothing_at_new_widths(rng):
    """On CPU tensors the wrappers run their plain versions at every new
    width: no counter moves."""
    before = dict(_build.launches)
    for d, dv in LASER_WIDTHS:
        q, k, v = (torch.from_numpy(_randn(rng, (1, 2, 40, w))) for w in (d, d, dv))
        assert tpf.laser_attention(q, k, v, 0.1).shape == (1, 2, 40, dv)
    q = torch.from_numpy(_randn(rng, (1, 2, 64, 256))).half()
    tsp.sparse_block_estimate_fused(q, q, 16)
    qd, kc, vc, bids = _topk_inputs(rng, 3, 71, 64, 64, 16, 16, 12)
    tsp.topk_block_sparse_attention(*(torch.from_numpy(x).half() for x in (qd, kc, vc)),
                                    torch.from_numpy(bids), 0.1, 16)
    assert _build.launches == before
