"""The split plans and the row pass of kernels K7, K2 and K1, on the CPU.

K7 (csrc/decode_mla.cu) splits each sequence's tokens over blocks of the
card and merges the splits in split order; K2 (csrc/rmsq_gemm.cu)
quantises every row once, then runs the int8 stage of csrc/w8a8_wgmma.cuh,
which K1 (csrc/w8a8_gemm_tiled.cu) runs straight on its int8 rows; the
stage splits K over blocks where the output has too few tiles. The kernels
need the card; what decides their work is Python that runs here:

  * (a) K7's planner (`mla_splits`, `mla_split_bounds`) for SM counts
    passed in: every live token in exactly one split, the splits in order,
    none empty, S within the kernel's maximum;
  * (b) an f32 emulation of K7's rounds, splits and merge (as the kernel
    takes them, following the planner) against `decode_mla_ref` and the JAX
    package's decode_mla_pallas run in interpret mode, within K7's bar (one
    bf16 ulp + 1e-4 of max|plain|), at DeepSeek's widths;
  * (c) the int8 stage's plan (`gemm_plan`, `gemm_split_bounds`) and its
    grid's block order: every output tile and K step covered once at K2's and
    K1's bench, engine and prefill shapes and panel widths, within one wave
    (half of one for 128-row tiles), no more splits than K steps, and the
    row tiles of a weight tile issued together;
  * (d) K2's plain row pass (`rmsq_rows_ref`, `_quant_rows`) against the
    JAX package's `_row_stats` plus its kernel's quant step;
  * (e) kernel A's plan: the same stage at every caller's (M, N, K) with
    one panel (bn = N), and its wrapper refusing widths the stage cannot
    take;
  * (f) the split plan of kernel C (csrc/decode_tm_core.cuh, mirrored by
    `tm_splits`, `tm_split_walk`): every cached token in exactly one
    split, each step's scores from its first token (from token 0 for a
    split's first step); and an f32 emulation of the splits, their page
    steps and the merge in split order against the plain version (S = 1
    with steps of one page is K3, which shares the loop unsplit);
  * (g) K14's plan on the same loop (`decode_v6.v6_splits`, `v6_groups`):
    splits of whole pages, the same walk and merge against the plain
    version, and the head groups that fit a page's kept scores;
  * (g2) K16's and K23's plan on the same loop (`decode_v3.v3_splits`,
    `v3_step`, `v3_groups`): splits of whole steps (a page, at most 4,096
    tokens of one), each walking only its own steps, and the shared memory
    of a block at every step it can take;
  * (h) K8's plan on the int8 stage (`gemm_plan` with its block_m): the
    row tile by block_m, every tile and K step covered once, the split from
    the shape alone, its partials and counters at the Qwen and MoE shapes;
    and K11's work list (`fused_moe_pallas.k11_items`) and the counters its
    wrapper allocates, at 128-row tiles.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops import rmsq_gemm as jrq
from sgl_kernel_npu_tpu.ops.attention import decode as jdec
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as trq
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v3 as tv3
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v6 as tv6
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v9 as tv9
from sgl_kernel_npu_tpu_torch.parallel.strategies import fused_moe_pallas as tfmp

K7_SHARE = 1e-4
NO_EXCESS = {"xla_allow_excess_precision": False}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_bf16_close(got, want, share, name=""):
    """Every value of `got` within one bf16 ulp of `want` (2^-7 of its
    magnitude) plus `share` * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > 2.0 ** -7 * np.abs(want) + share * np.abs(want).max()
    assert not bad.any(), (name, float(err.max()), int(bad.sum()), float(np.abs(want).max()))


# ----------------------------------------------------------- (a) K7's plan

SMS = (132, 114, 78, 16, 1)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,h", [(1, 16), (8, 16), (3, 4), (8, 20), (64, 128), (128, 16)])
@pytest.mark.parametrize("max_len", [1, 63, 64, 700, 4096, 8192])
def test_k7_split_plan(sms, b, h, max_len):
    s = tdec.mla_splits(sms, b, h, max_len)
    rows = b * math.ceil(h / tdec.MLA_HEADS)
    assert 1 <= s <= tdec.MLA_MAX_SPLITS
    assert s == 1 or s * rows <= sms            # one wave of the card
    for n in sorted({0, 1, 2, 31, 32, 33, 63, 64, 65, 127, 700, 701, 4096, max_len}):
        if n > max_len:
            continue
        bounds = tdec.mla_split_bounds(n, s)
        assert 1 <= len(bounds) <= s
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0                       # in order, nothing skipped or repeated
        if n == 0:
            assert bounds == [(0, 0)]
            continue
        for t0, t1 in bounds:
            assert t0 < t1                        # no split is empty
            assert t0 % tdec.MLA_ROUND == 0       # splits start on a round
        if len(bounds) > 1:                       # at least two rounds a split
            assert all(t1 - t0 > tdec.MLA_ROUND for t0, t1 in bounds)


def test_k7_split_plan_at_the_engine_shape():
    """The MLA engine's decode batch on an H100 (132 SMs): 8 sequences of
    16 heads, 64 pages of 128 tokens; 701 tokens take 11 splits of two
    rounds, a 4,096-token sequence alone 16 splits."""
    s = tdec.mla_splits(132, 8, 16, 64 * 128)
    assert s == 16
    assert len(tdec.mla_split_bounds(701, s)) == 11
    assert len(tdec.mla_split_bounds(41, s)) == 1
    s1 = tdec.mla_splits(132, 1, 16, 64 * 128)
    assert len(tdec.mla_split_bounds(4096, s1)) == 16


# ------------------------------------------------- (b) K7's split and merge


def _split_merge(q, ckv, krope, seq, bt, sm, ps, sms):
    """K7 emulated in f32: each split's rounds of 32 tokens as online-softmax
    steps, then the merge of the splits in split order (one split: its own
    acc / max(l, 1e-37))."""
    b, h, _ = q.shape
    lkv = ckv.shape[-1]
    mp = bt.shape[1]
    s = tdec.mla_splits(sms, b, h, mp * ps)
    qf = q.float()
    out = torch.zeros((b, h, lkv))
    for i in range(b):
        n = min(max(int(seq[i]), 0), mp * ps)
        tok = torch.arange(n)
        rows = bt[i, tok // ps].long() * ps + tok % ps
        ck = ckv.reshape(-1, lkv)[rows].float()
        kr = krope.reshape(-1, krope.shape[-1])[rows].float()
        parts = []
        for t0, t1 in tdec.mla_split_bounds(n, s):
            m = torch.full((h,), -math.inf)
            l = torch.zeros(h)
            acc = torch.zeros((h, lkv))
            for r0 in range(t0, t1, tdec.MLA_ROUND):
                r1 = min(r0 + tdec.MLA_ROUND, t1)
                sc = (qf[i, :, :lkv] @ ck[r0:r1].T + qf[i, :, lkv:] @ kr[r0:r1].T) * sm
                mn = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - mn)
                p = torch.exp(sc - mn[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ ck[r0:r1]
                m = mn
            parts.append((m, l, acc))
        if len(parts) == 1:
            _, l, acc = parts[0]
            out[i] = acc / l.clamp_min(1e-37)[:, None]
            continue
        mx = torch.stack([p[0] for p in parts]).amax(0)
        o, lsum = torch.zeros((h, lkv)), torch.zeros(h)
        for m, l, acc in parts:                  # split order
            w = torch.exp(m - mx)
            lsum = lsum + w * l
            o = o + w[:, None] * acc
        out[i] = o / lsum.clamp_min(1e-37)[:, None]
    return out.to(torch.bfloat16)


@pytest.fixture(scope="module")
def k7_case():
    """DeepSeek's widths (16 heads, 512 | 64) over pages of 16: three
    sequences of 1, 150 and 400 tokens (the current one included), page
    edges inside the splits; the JAX kernel run once in interpret mode."""
    rng = np.random.default_rng(131)
    b, h, lkv, lrope, ps, mp = 3, 16, 512, 64, 16, 26
    pages = b * mp + 1

    def bf16(shape, scale=1.0):
        a = jnp.asarray(scale * rng.standard_normal(shape), jnp.bfloat16)
        return a, _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    jck, tck = bf16((pages, ps, lkv))
    jkr, tkr = bf16((pages, ps, lrope))
    jq, tq = bf16((b, h, lkv + lrope), 1.5)
    seq = np.array([1, 150, 400], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    sm = (128 + 64) ** -0.5
    want = jdec.decode_mla_pallas(jq, jck, jkr, jnp.asarray(seq), jnp.asarray(bt), sm, ps)
    ref = tdec.decode_mla_ref(tq, tck, tkr, _t(seq), _t(bt), sm, ps)
    return dict(args=(tq, tck, tkr, _t(seq), _t(bt), sm, ps),
                want=np.asarray(jnp.asarray(want, jnp.float32)), ref=ref)


@pytest.mark.parametrize("sms", [132, 48, 9, 3])
def test_k7_split_merge_matches_plain_and_jax(k7_case, sms):
    q, ckv, kr, seq, bt, sm, ps = k7_case["args"]
    s = tdec.mla_splits(sms, q.shape[0], q.shape[1], bt.shape[1] * ps)
    if sms in (132, 48):
        assert len(tdec.mla_split_bounds(400, s)) > 2   # several splits merged
    got = _split_merge(q, ckv, kr, seq, bt, sm, ps, sms)
    assert_bf16_close(got.float().numpy(), k7_case["ref"].float().numpy(), K7_SHARE,
                      f"vs decode_mla_ref, S {s}")
    assert_bf16_close(got.float().numpy(), k7_case["want"], K7_SHARE,
                      f"vs decode_mla_pallas, S {s}")


def test_k7_plain_matches_jax(k7_case):
    assert_bf16_close(k7_case["ref"].float().numpy(), k7_case["want"], K7_SHARE)


# ------------------------------------------------- (c) the int8 stage's plan

# (M, N, K): phase 4's wqkv and w13 at Llama-3-8B width; phase 6's per_token
# w13 (intermediate padded to 1024-wide panels), wdqkv (2112 padded to 3072)
# and wuq; the MLA engine's M 8 per_tensor calls on plain weights; a prefill
K2_SHAPES = [(128, 6144, 4096), (128, 28672, 4096), (128, 22528, 2048), (128, 3072, 2048),
             (128, 3072, 1536), (8, 2112, 2048), (8, 3072, 1536), (256, 2112, 2048),
             (100, 384, 256), (8, 128, 64)]
# K1's (M, N, K, bn): Llama-3-8B's wo, w2 (panels of 512) and lm_head (768)
# at the bench path's M 128, the hm engine's decode M 8 and a prefill chunk
# of 672 rows; phase 1's panel straddles (bn 128, 384) and DeepSeek's
# 1024-wide panels; the split edges at M 16, 17 and 129
K1_SHAPES = [(m, n, k, bn) for m in (8, 128, 672)
             for n, k, bn in ((4096, 4096, 512), (4096, 14336, 512), (128256, 4096, 768))]
K1_SHAPES += [(1, 2048, 4096, 128), (16, 3072, 4096, 384), (17, 3072, 2048, 1024),
              (100, 2048, 4096, 128), (129, 3072, 4096, 384), (672, 3072, 2048, 1024)]


def _blocks(tiles_m, tiles_n, splits):
    """(row tile, column tile, split) of each block of the int8 stage in
    the order the card issues them: the kernel's grid is (tiles_m, tiles_n,
    splits) where tiles_m > 1, else (tiles_n, 1, splits), its x fastest
    (csrc/w8a8_wgmma.cuh::launch_gemm), so a weight tile's row tiles go out
    together and its repeats come from L2."""
    return [(tm, tn, sp) for sp in range(splits) for tn in range(tiles_n)
            for tm in range(tiles_m)]


def _check_plan(m, n, k, sms, block_m=0):
    """gemm_plan's tiles and split of (m, n, k) (K8's: with its block_m)
    cover every output tile and K step exactly once, within a wave where it
    splits, and the grid issues each weight tile's row tiles together.
    Returns the plan."""
    bm, tiles_m, tiles_n, splits = tmm.gemm_plan(m, n, k, sms, block_m)
    if block_m:
        assert bm == (128 if block_m % 128 == 0 else 16)
    else:
        assert bm == (16 if m <= 32 else 128)
    assert tiles_m * bm >= m > (tiles_m - 1) * bm
    assert tiles_n * tmm.GEMM_BN >= n > (tiles_n - 1) * tmm.GEMM_BN
    kstep = tmm.gemm_kstep(bm)
    ksteps = -(-k // kstep)
    assert 1 <= splits <= tmm.GEMM_MAX_SPLITS and splits <= ksteps
    # one wave of 16-row tiles, half of one of 128-row tiles
    assert splits == 1 or tiles_m * tiles_n * splits <= (sms if bm == 16 else sms // 2)
    assert splits == 1 or ksteps // splits * kstep >= tmm.GEMM_MIN_SPLIT_K
    bounds = tmm.gemm_split_bounds(ksteps, splits)
    assert [b[0] for b in bounds] == sorted(b[0] for b in bounds)
    assert all(k1 > k0 for k0, k1 in bounds)                    # no split is empty
    blocks = _blocks(tiles_m, tiles_n, splits)
    assert len(blocks) == tiles_m * tiles_n * splits
    covered = np.zeros((tiles_m, tiles_n, ksteps), np.int32)
    for tm, tn, sp in blocks:
        k0, k1 = bounds[sp]
        covered[tm, tn, k0:k1] += 1
    assert (covered == 1).all()
    for i in range(0, len(blocks), tiles_m):                    # row tiles together
        run = blocks[i:i + tiles_m]
        assert [b[0] for b in run] == list(range(tiles_m))
        assert len({b[1:] for b in run}) == 1
    return bm, tiles_m, tiles_n, splits


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("m,n,k", K2_SHAPES)
def test_k2_plan_covers_every_tile_once(sms, m, n, k):
    _check_plan(m, n, k, sms)


def test_k2_plan_at_the_bench_shapes():
    """On an H100 (132 SMs): w13 fills 112 tiles unsplit, wqkv's 24 tiles
    split K twice (half the SMs), the MLA path's wdqkv (12 tiles padded to
    3072 columns) five ways, the engine's M 8 wdqkv (9 tiles of 16 rows,
    stages of 64) eight ways (one wave)."""
    assert tmm.gemm_plan(128, 28672, 4096, 132) == (128, 1, 112, 1)
    assert tmm.gemm_plan(128, 6144, 4096, 132) == (128, 1, 24, 2)
    assert tmm.gemm_plan(128, 3072, 2048, 132) == (128, 1, 12, 5)
    assert tmm.gemm_plan(8, 2112, 2048, 132) == (16, 1, 9, 8)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,n,k,bn", K1_SHAPES)
def test_k1_plan_covers_every_tile_once(sms, m, n, k, bn):
    """K1's shapes: the panels divide N (the bank's own rule), and the plan
    covers every tile and K step once, row tiles of a weight tile together."""
    assert n % bn == 0 and bn % 128 == 0
    _check_plan(m, n, k, sms)


def test_k1_plan_at_the_bench_shapes():
    """On an H100 (132 SMs): M 128 is one row tile, so every weight byte is
    read once; wo and w2 (16 tiles) split K four ways, lm_head's 501 tiles
    run unsplit; at M 8 wo takes 16-row tiles split eight ways; a 672-row
    prefill chunk takes six row tiles of each weight tile, unsplit."""
    assert tmm.gemm_plan(128, 4096, 4096, 132) == (128, 1, 16, 4)
    assert tmm.gemm_plan(128, 4096, 14336, 132) == (128, 1, 16, 4)
    assert tmm.gemm_plan(128, 128256, 4096, 132) == (128, 1, 501, 1)
    assert tmm.gemm_plan(8, 4096, 4096, 132) == (16, 1, 16, 8)
    assert tmm.gemm_plan(672, 4096, 14336, 132) == (128, 6, 16, 1)


# ---------------------------------------------------- (d) K2's row pass


_jax_stats = jax.jit(jrq._row_stats, static_argnums=(5, 6, 7), compiler_options=NO_EXCESS)


def _jax_quant(x, gamma, beta, qs, qo, mode, apply_norm, eps, cast):
    """The JAX kernel's int8 rows: rmsnorm_quant_gemm (interpret mode) on an
    identity weight with unit scales gives xq (per_tensor) or xq * scale
    (per_token, divided back: |xq| <= 128, so the quotient rounds to it)."""
    m, k = x.shape
    eye = jnp.eye(k, dtype=jnp.int8)
    out = jrq.rmsnorm_quant_gemm(x, gamma, beta, eye, jnp.ones((k,), jnp.float32), None,
                                 qs, qo, quant_mode=mode, apply_norm=apply_norm, eps=eps,
                                 quant_cast=cast)
    out = np.asarray(out, np.float64)
    if mode == "per_token":
        _, qdiv, _, _ = _jax_stats(x, gamma, beta, qs, qo, mode, apply_norm, eps)
        out = out / np.asarray(qdiv, np.float64)
    q = np.round(out)
    assert np.abs(out - q).max() < 1e-3
    return q.astype(np.int8)


def _row_case(rng, m, k, x_f32):
    """x (bf16, or an f32 column slice whose rows lie further apart than K),
    gamma and beta, as numpy and as the port's tensors."""
    wide = (2.0 * rng.standard_normal((m, k + 96))).astype(np.float32)
    wide[1, 7] = 40.0                                 # a row with an outlier
    if x_f32:
        tx = _t(wide)[:, 32:32 + k]
        jx = jnp.asarray(wide[:, 32:32 + k])
    else:
        jx = jnp.asarray(wide[:, :k], jnp.bfloat16)
        tx = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    gamma = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(k)).astype(np.float32)
    return jx, tx, gamma, beta


@pytest.mark.parametrize("x_f32", [False, True])
@pytest.mark.parametrize("mode,cast", [("per_token", "f32"), ("per_tensor", "fp16"),
                                       ("per_tensor", "f32")])
@pytest.mark.parametrize("apply_norm", [True, False])
def test_k2_row_pass_matches_jax(monkeypatch, x_f32, mode, cast, apply_norm):
    """The port's quant step on the JAX package's row statistics gives the
    JAX kernel's int8 rows bit for bit (fp16 cast included, f32 x read
    through a strided slice). The port's own statistics: rstd equal to the
    JAX one without the norm and within an ulp with it (the port sums in
    float64 and rounds 1/sqrt once, XLA sums in f32 and approximates rsqrt);
    the per-token scale within an ulp more (the port multiplies by
    f32(1/127), as XLA compiles `_row_stats` inside the model's step, where
    `_row_stats` compiled alone divides by 127). The whole row pass then
    flips at most one int8 value in 2,000, by one; none in the per_tensor
    mode without the norm."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(140 + 2 * x_f32 + apply_norm)
    m, k, eps = 16, 256, 1e-6
    jx, tx, gamma, beta = _row_case(rng, m, k, x_f32)
    if x_f32:
        assert not tx.is_contiguous() and tx.stride(0) > k
    qs, qo = (np.float32(0.04), np.float32(1.5)) if mode == "per_tensor" else (None, None)
    jqs = jnp.float32(qs) if qs is not None else None
    jqo = jnp.float32(qo) if qo is not None else None
    want = _jax_quant(jx, jnp.asarray(gamma), jnp.asarray(beta), jqs, jqo, mode, apply_norm,
                      eps, cast)

    rstd, qdiv, qoff, outsc = (np.asarray(a) for a in _jax_stats(
        jx, jnp.asarray(gamma), jnp.asarray(beta), jqs, jqo, mode, apply_norm, eps))
    qd = _t(qdiv) if mode == "per_token" else torch.tensor(qs)
    got = trq._quant_rows(tx, _t(rstd), _t(gamma), _t(beta), qd,
                          torch.tensor(qo) if qo is not None else None, cast == "fp16")
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)

    xq, xs = trq.rmsq_rows_ref(tx, _t(gamma), _t(beta),
                               torch.tensor(qs) if qs is not None else None,
                               torch.tensor(qo) if qo is not None else None, mode,
                               apply_norm, eps, cast)
    prstd = trq._rstd(tx, apply_norm, eps).numpy()
    ulp = np.spacing(np.abs(rstd).astype(np.float32))
    if apply_norm:
        assert (np.abs(prstd - rstd) <= ulp).all()
    else:
        assert np.array_equal(prstd, rstd)
    if mode == "per_token":
        ulps = (1 + apply_norm) * np.spacing(np.abs(outsc))
        assert (np.abs(xs.numpy() - outsc) <= ulps).all()
    else:
        assert np.array_equal(xs.numpy(), np.ones((m, 1), np.float32))
    diff = np.abs(xq.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-4
    if not apply_norm and mode == "per_tensor":
        assert np.array_equal(xq.numpy(), want)


# ---------------------------------------------------------- (e) A's plan

# kernel A's (N, K) at its callers: Llama-3-8B's stacked wqkv, wo, w13, w2
# (models/llama.py, the engine's [L, K, N] banks) and lm_head (L = 1, the
# engines' quant_matmul_int8); DeepSeek-V2-Lite's wo, w13, w2 (N 21,888:
# half a 256-column tile at the end) and lm_head (models/deepseek_mla.py)
A_WIDTHS = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336), (128256, 4096),
            (2048, 2048), (21888, 2048), (2048, 10944), (102400, 2048)]
# the engines' decode (8), the bench paths' batch (128), prefill chunks up
# to 672 rows, the plan's edges (1, 16, 17)
A_MS = (1, 8, 16, 17, 128, 672)


def _stage_takes(m, n, k, bn, bm, splits, grouped=False):
    """The stage's rule (csrc/w8a8_wgmma.cuh::plan_ok; K8's row tiles are
    16-row ones at any M)."""
    ksteps = k // 64 if bm == 16 else -(-k // 128)
    return (bn > 0 and bn % 16 == 0 and n % bn == 0 and n % 16 == 0 and k % 64 == 0
            and (bm == 16 or (bm == 128 and (bn % 128 == 0 or bn == n)))
            and not (bm == 16 and m > 32 and not grouped) and 1 <= splits <= tmm.GEMM_MAX_SPLITS
            and splits <= ksteps)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", A_MS)
@pytest.mark.parametrize("n,k", A_WIDTHS)
def test_a_plan_covers_every_tile_once(sms, m, n, k):
    """A runs the stage with one panel of N columns: the plan covers every
    output tile and K step once at each caller's shape, and the stage takes
    it."""
    bm, tiles_m, tiles_n, splits = _check_plan(m, n, k, sms)
    assert _stage_takes(m, n, k, n, bm, splits)


def test_a_plan_at_the_engine_shapes():
    """On an H100 (132 SMs): the Llama engine's M 8 wqkv (24 tiles of 16
    rows) splits five ways, w13 (112 tiles) unsplit; lm_head's 501 tiles
    and DeepSeek's w13 (86 tiles, the last half full) run unsplit at M 128,
    its wo four ways at M 8."""
    assert tmm.gemm_plan(8, 6144, 4096, 132) == (16, 1, 24, 5)
    assert tmm.gemm_plan(8, 28672, 4096, 132) == (16, 1, 112, 1)
    assert tmm.gemm_plan(128, 128256, 4096, 132) == (128, 1, 501, 1)
    assert tmm.gemm_plan(128, 21888, 2048, 132) == (128, 1, 86, 1)
    assert tmm.gemm_plan(8, 2048, 2048, 132) == (16, 1, 8, 8)


@pytest.mark.parametrize("n,k", [(4088, 4096), (4096, 4000), (120, 64)])
def test_a_refuses_what_the_stage_cannot_take(n, k):
    """N % 16 or K % 64: the wrapper raises before any launch."""
    x = torch.zeros((8, k), dtype=torch.int8)
    w = torch.zeros((2, k, n), dtype=torch.int8)
    assert not _stage_takes(8, n, k, n, 16, 1)
    with pytest.raises(ValueError, match="needs K % 64 == 0, N % 16 == 0"):
        tmm._w8a8_gemm(x, w, 1, torch.ones((8, 1)), torch.ones((2, n)), torch.bfloat16)


# ------------------------------------------------------ (f) C's split plan


@pytest.mark.parametrize("resident", [396, 264, 132, 16])
@pytest.mark.parametrize("b,hkv,mp,ps", [(128, 8, 2, 512), (128, 8, 1, 512), (8, 8, 64, 128),
                                         (1, 2, 4, 16), (3, 1, 6, 16)])
def test_tm_split_plan(resident, b, hkv, mp, ps):
    """Every cached token in exactly one split's p . v ranges, in order;
    each step's scores from its first token (token 0 for a split's first
    step) to its end or the cached length; S = 1 at the bench path's 1,024
    rows."""
    s = tv9.tm_splits(resident, b, hkv, mp, ps)
    assert 1 <= s <= tv9.TM_MAX_SPLITS
    assert s == 1 or s * b * hkv <= resident
    if (b, hkv) == (128, 8):
        assert s == 1
    for step in sorted({ps, min(4, mp) * ps}):
        for clen in sorted({0, 1, 15, 16, 17, ps - 1, ps, ps + 1, mp * ps - 1, mp * ps}):
            if not 0 <= clen <= mp * ps:
                continue
            seen = np.zeros(clen, np.int32)
            prev_te = 0
            for split in range(s):
                ts, te, steps = tv9.tm_split_walk(clen, s, split, step)
                assert ts % tv9.TM_TILE == 0 and ts >= prev_te
                prev_te = max(prev_te, te)
                for i, (k, (s0, s1), (p0, p1)) in enumerate(steps):
                    assert s0 == (0 if i == 0 else k * step)
                    assert s1 == min(clen, (k + 1) * step)
                    assert k * step <= p0 < p1 <= s1
                    seen[p0:p1] += 1
            assert (seen == 1).all()


def _emulate_tm(q, k_new, v_new, kc, ks, vc, vs, cached, step, sm, s, unit=tv9.TM_TILE):
    """Kernel C (K3 at S = 1) in f32 on a gathered cache ([B, hkv, n, D]): each
    split's page steps as tm_split_walk gives them (the maximum of a step's
    scores range, p over the split's own tokens, bf16(p * v_scale) . V),
    the splits merged in split order, the current token folded in."""
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    out = torch.zeros((b, hkv, g, d))
    for i in range(b):
        clen = max(int(cached[i]), 0)
        for h in range(hkv):
            sc = (qf[i, h] @ kc[i, h, :clen].float().T) * ks[i, h, :clen] * sm   # [g, clen]
            parts = []
            for split in range(s):
                _, _, steps = tv9.tm_split_walk(clen, s, split, step, unit)
                m = torch.full((g,), -1e30)
                l = torch.zeros(g)
                acc = torch.zeros((g, d))
                for _, (s0, s1), (p0, p1) in steps:
                    mn = torch.maximum(m, sc[:, s0:s1].amax(-1))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(sc[:, p0:p1] - mn[:, None])
                    l = l * alpha + p.sum(-1)
                    pv = (p * vs[i, h, p0:p1]).to(torch.bfloat16).float()
                    acc = acc * alpha[:, None] + pv @ vc[i, h, p0:p1].float()
                    m = mn
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).amax(0)
            o, lsum = torch.zeros((g, d)), torch.zeros(g)
            for m, l, acc in parts:              # split order
                w = torch.exp(m - mx)
                lsum = lsum + w * l
                o = o + w[:, None] * acc
            s_cur = (qf[i, h] * k_new[i, h].float()).sum(-1) * sm
            mn = torch.maximum(mx, s_cur)
            alpha = torch.exp(mx - mn)
            p = torch.exp(s_cur - mn)
            lsum = lsum * alpha + p
            o = o * alpha[:, None] + p.to(torch.bfloat16).float()[:, None] * v_new[i, h].float()
            out[i, h] = o / lsum.clamp_min(1e-37)[:, None]
    return out.reshape(b, hq, d).to(torch.bfloat16)


@pytest.mark.parametrize("s", [1, 2, 3, 8])
@pytest.mark.parametrize("pages_per_step", [1, 4])
def test_tm_split_merge_matches_plain(s, pages_per_step):
    """The splits (cut inside pages where S > 1), each taking its step's
    maximum from token 0 of its first step, merged in split order, against
    attend_gathered_ref (steps of one page as C takes decode_v8's contract
    and K3 unsplit, of four as C takes decode_v9's) within one bf16 ulp +
    1e-4 of max|plain|."""
    rng = np.random.default_rng(77 + s)
    b, hkv, g, d, ps, mp = 6, 2, 4, 128, 16, 6
    n = mp * ps
    q = _t(rng.standard_normal((b, hkv * g, d)).astype(np.float32)).to(torch.bfloat16)
    kn = _t(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(torch.bfloat16)
    vn = _t(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(torch.bfloat16)
    kc = _t(rng.integers(-127, 128, (b, hkv, n, d)).astype(np.int8))
    vc = _t(rng.integers(-127, 128, (b, hkv, n, d)).astype(np.int8))
    ks = _t((0.001 + 0.02 * rng.random((b, hkv, n))).astype(np.float32))
    vs = _t((0.001 + 0.02 * rng.random((b, hkv, n))).astype(np.float32))
    cached = torch.tensor([0, 1, 17, 40, 95, 96], dtype=torch.int32)
    step = pages_per_step * ps
    sm = d ** -0.5
    want = tv9.attend_gathered_ref(q, kn, vn, kc, ks, vc, vs, cached, step, sm)
    got = _emulate_tm(q, kn, vn, kc, ks, vc, vs, cached, step, sm, s)
    assert_bf16_close(got.float().numpy(), want.float().numpy(), 1e-4, f"S {s}")


# ------------------------------------------------------ (g) K14's plan


@pytest.mark.parametrize("resident", [396, 264, 132, 16])
@pytest.mark.parametrize("b,hkv,ng,mp,ps", [(128, 8, 1, 1, 512), (8, 8, 1, 6, 128),
                                            (8, 2, 2, 4, 512), (1, 2, 1, 4, 16),
                                            (3, 1, 1, 6, 100)])
def test_v6_split_plan(resident, b, hkv, ng, mp, ps):
    """K14's splits hold whole pages: every cached token in exactly one
    split's p . v ranges, a split's bounds on page edges, each page's scores
    from its first token (token 0 for a split's first page); S = 1 at the
    bench path's 1,024 rows, several at the engine's 64."""
    s = tv6.v6_splits(resident, b, hkv * ng, mp)
    assert 1 <= s <= min(tv6.V6_MAX_SPLITS, mp)
    assert s == 1 or s * b * hkv * ng <= resident
    if (b, hkv) == (128, 8):
        assert s == 1
    if (b, hkv, resident) == (8, 8, 396):
        assert s == 6
    for clen in sorted({0, 1, ps - 1, ps, ps + 1, 2 * ps + 3, mp * ps - 1, mp * ps}):
        if not 0 <= clen <= mp * ps:
            continue
        seen = np.zeros(clen, np.int32)
        for split in range(s):
            ts, te, steps = tv9.tm_split_walk(clen, s, split, ps, unit=ps)
            assert ts % ps == 0 and (te == clen or te % ps == 0)
            for i, (k, (s0, s1), (p0, p1)) in enumerate(steps):
                assert s0 == (0 if i == 0 else k * ps) and s1 == min(clen, (k + 1) * ps)
                assert (p0, p1) == (k * ps, min(clen, (k + 1) * ps))
                seen[p0:p1] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("s", [1, 2, 3, 6])
def test_v6_split_merge_matches_plain(s):
    """K14's page-aligned splits (each first scanning the earlier pages'
    scores for the running maximum), merged in split order, against
    attend_gathered_ref with steps of one page (K14's and K3's contract)
    within one bf16 ulp + 1e-4 of max|plain|."""
    rng = np.random.default_rng(91 + s)
    b, hkv, g, d, ps, mp = 6, 2, 4, 128, 16, 6
    n = mp * ps
    q = _t(rng.standard_normal((b, hkv * g, d)).astype(np.float32)).to(torch.bfloat16)
    kn = _t(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(torch.bfloat16)
    vn = _t(rng.standard_normal((b, hkv, d)).astype(np.float32)).to(torch.bfloat16)
    kc = _t(rng.integers(-127, 128, (b, hkv, n, d)).astype(np.int8))
    vc = _t(rng.integers(-127, 128, (b, hkv, n, d)).astype(np.int8))
    ks = _t((0.001 + 0.02 * rng.random((b, hkv, n))).astype(np.float32))
    vs = _t((0.001 + 0.02 * rng.random((b, hkv, n))).astype(np.float32))
    cached = torch.tensor([0, 1, 17, 40, 95, 96], dtype=torch.int32)
    sm = d ** -0.5
    want = tv9.attend_gathered_ref(q, kn, vn, kc, ks, vc, vs, cached, ps, sm)
    got = _emulate_tm(q, kn, vn, kc, ks, vc, vs, cached, ps, sm, s, unit=ps)
    assert_bf16_close(got.float().numpy(), want.float().numpy(), 1e-4, f"S {s}")


def _v6_kept_floats(g, ps, int8):
    """decode_v6.cu's kept_floats: a K14 block's shared memory is
    decode_tm_core.cuh's 3-stage ring of 16 KB stages (128 int8 rows of 144
    bytes and their scales, or 64 bf16 rows of 272) and its p transposes,
    then g x (ps + 4) f32 kept scores; past Hopper's 227 KB a block the kept
    scores take that many floats of device memory."""
    ring = 3 * 18944 + 1536 if int8 else 3 * 17664 + 1536
    return 0 if ring + g * (ps + 4) * 4 <= 232448 else g * (ps + 4)


@pytest.mark.parametrize("g,ps,int8,smem", [(1, 512, True, True), (4, 512, False, True),
                                            (8, 512, True, True), (16, 512, False, True),
                                            (8, 5000, True, True), (8, 6000, True, False),
                                            (1, 43000, True, True), (1, 44000, True, False),
                                            (1, 44400, False, True), (1, 57600, False, False)])
def test_v6_head_groups(g, ps, int8, smem):
    """K14's head groups: at most 8 query heads a block (G 16: two blocks of
    8); a page's kept scores (G / ng x (ps + 4) f32) stay in shared memory
    where they fit beside the ring in 227 KB, else in device memory, so that
    every page the parent took (up to 57,600 tokens at G 1) runs. The
    wrapper takes the device memory's size from decode_v6.cu's
    skt_*_kept, which chip_smoke.py's K14 edges hold on the card; here the
    rule is held through _v6_kept_floats, its copy."""
    ng = tv6.v6_groups(g)
    assert ng == (2 if g == 16 else 1) and g // ng <= tv6.V6_MAXG
    floats = _v6_kept_floats(g // ng, ps, int8)
    assert (floats == 0) == smem and floats in (0, g // ng * (ps + 4))


# ------------------------------------------------ (g2) K16's and K23's plan


@pytest.mark.parametrize("resident", [396, 264, 132, 16])
@pytest.mark.parametrize("b,hkv,ng,mp,ps", [(128, 8, 1, 1, 512), (64, 8, 1, 4, 128),
                                            (7, 2, 2, 4, 16), (7, 2, 1, 4, 100),
                                            (7, 2, 1, 1, 8192), (1, 2, 1, 4, 16)])
def test_v3_split_plan(resident, b, hkv, ng, mp, ps):
    """K16's and K23's splits hold whole steps (a page, or 4,096 tokens of a
    longer one): every cached token in exactly one split's p . v ranges, the
    splits' bounds on step edges; S = 1 at the bench path's 1,024 rows and
    phase 13's 512, several at chip_smoke.py's edge batch of 7. (A split of
    K16 takes the scores of its own steps only: p is not rounded, so it
    needs no maximum of the keys before it; test_torch_hm.py's
    _p_f32_model holds that arithmetic against the plain version.)"""
    s = tv3.v3_splits(resident, b, hkv * ng, mp, ps)
    step = tv3.v3_step(ps)
    assert step == min(ps, 4096)
    assert 1 <= s <= min(tv3.V3_MAX_SPLITS, -(-mp * ps // step))
    assert s == 1 or s * b * hkv * ng <= resident
    if b * hkv >= 512:
        assert s == 1
    if (b, resident) == (7, 396):
        assert s > 1
    for clen in sorted({0, 1, ps - 1, ps, ps + 1, 2 * ps + 3, mp * ps - 1, mp * ps}):
        if not 0 <= clen <= mp * ps:
            continue
        seen = np.zeros(clen, np.int32)
        for split in range(s):
            ts, te, steps = tv9.tm_split_walk(clen, s, split, step, unit=step)
            assert ts % step == 0 and (te == clen or te % step == 0)
            for k, _, (p0, p1) in steps:
                assert (p0, p1) == (k * step, min(clen, (k + 1) * step))
                seen[p0:p1] += 1
        assert (seen == 1).all()


def _v3_smem(g, step, int8):
    """decode_v3.cu's shared memory a block: decode_tm_core.cuh's 3-stage
    ring (as _v6_kept_floats), three p transposes a warp (4 x 3 x 8 x 24
    bf16) and g x (step + 4) f32 kept scores."""
    ring = 3 * 18944 if int8 else 3 * 17664
    return ring + 3 * 1536 + g * (step + 4) * 4


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("ps", [16, 100, 512, 4096, 8192, 57600, 100000])
@pytest.mark.parametrize("int8", [False, True])
def test_v3_steps_fit_shared_memory(g, ps, int8):
    """Every page size runs: a step of min(ps, 4,096) tokens keeps its G / ng
    <= 8 heads' scores in a block's 227 KB beside the ring (pages past that
    are walked in steps of 4,096), so the parent's pages (up to 57,600
    tokens at G 1) and longer ones run with no scores in device memory."""
    ng = tv3.v3_groups(g)
    assert ng == (2 if g == 16 else 1) and g // ng <= tv3.V3_MAXG
    assert _v3_smem(g // ng, tv3.v3_step(ps), int8) <= 232448


# ------------------------------------------------- (h) K8's and K11's plans
# K8's (M, N, K, block_m): the Qwen bench path's w13 and w2 (5,376 rows in
# 32-row expert tiles); the EP MoE layer's GMM1 and GMM2 on the first
# round's aligned compaction at chunk_rounds 1, 2, 4 (2,048, 1,536 and
# 1,280 rows in 128-row tiles); chip_smoke.py's K8 edges; block_m 64 and
# 256 (16-row and 128-row tiles)
K8_SHAPES = [(5376, 1024, 2048, 32), (5376, 2048, 512, 32)]
K8_SHAPES += [(m, n, k, 128) for m in (2048, 1536, 1280) for n, k in ((4096, 7168),
                                                                      (7168, 2048))]
K8_SHAPES += [(160, 768, 512, 32), (512, 768, 512, 128), (96, 256, 2048, 32),
              (256, 256, 2048, 128), (64, 256, 64, 64), (512, 512, 128, 256)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("m,n,k,block_m", K8_SHAPES)
def test_k8_plan_covers_every_tile_once(sms, m, n, k, block_m):
    """K8's row tiles never straddle two experts (128 rows where block_m is a
    multiple of 128, else 16): the plan covers every output tile and K step
    once, the row tiles of a weight tile issued together (an expert's row
    tiles, so that their repeats come from L2), and the stage takes it."""
    bm, tiles_m, tiles_n, splits = _check_plan(m, n, k, sms, block_m)
    assert block_m % bm == 0 and tiles_m * bm == m
    assert _stage_takes(m, n, k, n, bm, splits, grouped=True)


def test_k8_plan_at_the_bench_shapes():
    """On an H100 (132 SMs): the Qwen w13 and w2 take 336 16-row tiles, the
    MoE layer's GMM1 and GMM2 16 128-row tiles (one an expert tile), all
    unsplit, so no partials and no counters; chip_smoke.py's small split
    shapes split eight ways, with one counter a tile and every split's
    partial sums."""
    for shape, plan in (((5376, 1024, 2048, 32), (16, 336, 4, 1)),
                        ((5376, 2048, 512, 32), (16, 336, 8, 1)),
                        ((2048, 4096, 7168, 128), (128, 16, 16, 1)),
                        ((2048, 7168, 2048, 128), (128, 16, 28, 1))):
        assert tmm.gemm_plan(*shape[:3], 132, shape[3]) == plan
        assert tmm.gemm_scratch(*plan) == (0, 0)
    assert tmm.gemm_plan(96, 256, 2048, 132, 32) == (16, 6, 1, 8)
    assert tmm.gemm_scratch(16, 6, 1, 8) == (6 * 8 * 16 * 256, 6)
    assert tmm.gemm_plan(256, 256, 2048, 132, 128) == (128, 2, 1, 8)
    assert tmm.gemm_scratch(128, 2, 1, 8) == (2 * 8 * 128 * 256, 2)


def test_k8_plan_is_a_function_of_the_shape():
    """The plan reads no data (the host never reads the expert map): it takes
    the shape, the SM count and block_m alone, and at a block_m of 128 it is
    the stage's own plan for M > 32."""
    import inspect
    assert list(inspect.signature(tmm.gemm_plan).parameters) == ["m", "n", "k", "sms",
                                                                 "block_m"]
    for m, n, k, block_m in K8_SHAPES:
        if block_m == 128:
            assert tmm.gemm_plan(m, n, k, 132, block_m) == tmm.gemm_plan(m, n, k, 132)


@pytest.mark.parametrize("block_m", [0, 16, 48])
def test_k8_refuses_what_the_stage_cannot_take(block_m):
    """A block_m that is not a positive multiple of 32: the wrapper raises
    before any launch."""
    m = 96
    x = torch.zeros((m, 128), dtype=torch.int8)
    w = torch.zeros((2, 128, 256), dtype=torch.int8)
    eid = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="block_m % 32 == 0"):
        tmm._w8a8_gemm(x, w, 0, torch.ones((m, 1)), torch.ones((2, 256)), torch.bfloat16,
                       eid=eid, block_m=block_m)


@pytest.mark.parametrize("maxt", [8, 72, 128, 136, 256])
def test_k11_items_and_counters(maxt):
    """K11's work list at the MoE bench widths (8 experts, H 7168, F 2048):
    m-tiles of 128 rows (a window of up to 128 rows is one), GMM1 tiles of
    256 of the 2F columns, GMM2 tiles of 256 of H, 8 requant items of 16
    rows an m-tile, a phase-S item per chunk of 8 send rows; the counters
    [work][arrive El][g1_done El * MT][rq_done El * MT]."""
    el, h, f = 8, 7168, 2048
    sbuf = el * maxt + 64
    mt = -(-maxt // 128)
    items, ctr = tfmp.k11_items(el, maxt, h, f, sbuf)
    assert items == {"send": -(-sbuf // 8), "gmm1": el * 16 * mt, "requant": el * mt * 8,
                     "gmm2": el * 28 * mt}
    assert ctr == 1 + el + 2 * el * mt


@pytest.mark.parametrize("maxt", [8, 72, 136])
def test_k11_wrapper_allocates_the_kernels_counters(monkeypatch, maxt):
    """The wrapper hands K11 the counter buffer k11_items sizes, at TM 128
    (the launch itself is replaced: no card here)."""
    from sgl_kernel_npu_tpu_torch import _build
    seen = {}

    def operands(name, device, *tensors):
        seen["ctr"] = tensors[-1]
    monkeypatch.setattr(_build, "check_operands", operands)
    monkeypatch.setattr(_build, "launcher", lambda name, argtypes: lambda *args: 0)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    el, h, f = 2, 256, 128
    sbuf = el * maxt + 8
    x_send = torch.zeros((sbuf, h), dtype=torch.bfloat16)
    w13 = torch.zeros((el, h, 2 * f), dtype=torch.int8)
    w2 = torch.zeros((el, f, h), dtype=torch.int8)
    tables = [torch.zeros((el,), dtype=torch.int32) for _ in range(5)]
    tfmp._fused_moe_cuda(x_send, w13, torch.ones((el, 2 * f)), w2, torch.ones((el, h)),
                         tables, maxt=maxt)
    mt = -(-maxt // 128)
    assert seen["ctr"].dtype == torch.int32
    assert seen["ctr"].numel() == tfmp.k11_items(el, maxt, h, f, sbuf)[1] == 1 + el + 2 * el * mt
