"""The port's EP MoE slice (the layer `bench.py --config moe` times) against
the JAX package on the CPU, at one rank: the routing and layouts, both
low-latency strategies' dispatch and combine, the chunked ragged scatter
(K12), the single-launch fused layer (K11), the composition at chunk_rounds
1 / 2 / 4, dispatch_ffn_combine, swiglu_quant (K13) and Buffer.fused_deep_moe
end to end. tests/test_torch_moe_ep.py holds 2 and 4 ranks over gloo.

Small sizes as tests/test_fused_moe_pallas.py: H 256, F 128, T 16, K 2,
E 2. The same numpy inputs go to both packages; the JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas) on a one-device mesh, the port
its plain versions (device="cpu"). chip_smoke.py holds the CUDA kernels
against those plain versions on the card.

Tolerances, each with its reason:
  * routing, layouts, compactions, counts, handles, the scatter (with and
    without in-kernel quantisation, zero padding included), the fused
    layer's recv and rs, and every dispatch's recv and scales: exact
    (integer math, copies, and the same f32 scale rule: max(absmax, 1e-7)
    times f32(1/127), which is what the interpreted Pallas kernel computes
    for its division by 127);
  * every combine: one bf16 ulp plus 1e-6 of max|ref| (an f32 sum of k
    products, taken in top-k order here and in XLA's order there);
  * the requantised SwiGLU activation (K11's intermediate, and swiglu_quant,
    K13): XLA's CPU logistic and torch.sigmoid differ in the last f32 bit,
    which can move a value across a rounding boundary: at most 1 LSB on at
    most 0.5% of the entries, and scales within one f32 ulp;
  * the layer outputs (fused kernel, composition, Buffer): calc_diff below
    1e-5 and rtol = atol = 0.05, the JAX tiers' own bound
    (tests/test_fused_moe_pallas.py:62); a flipped int8 activation moves an
    output by one LSB of its scale times a weight. The fused tier against
    the composition: calc_diff below 1e-4 (TIER_DIFF), since the
    composition rounds GMM1's output to bf16 and the fused layer keeps f32.

The JAX fused kernel is held directly at 2 experts. With more, the
interpreted kernel reuses each of its two out_buf slots before the
simulator performs the copies out of it, and returns another expert's rows
(its output is calc_diff 0.1 from the JAX package's own composition on the
random route here; its test's atol of 0.05 exceeds outputs of about 0.01);
there the port's fused layer is held against the composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from sgl_kernel_npu_tpu.ops import activation as jact
from sgl_kernel_npu_tpu.parallel import Buffer as JBuffer
from sgl_kernel_npu_tpu.parallel import elastic as jel
from sgl_kernel_npu_tpu.parallel import fused_moe as jfm
from sgl_kernel_npu_tpu.parallel import layout as jlayout
from sgl_kernel_npu_tpu.parallel.strategies import fused_moe_pallas as jfmp
from sgl_kernel_npu_tpu.parallel.strategies import low_latency as jll
from sgl_kernel_npu_tpu.parallel.strategies import pallas_ll as jpll
from sgl_kernel_npu_tpu.ops import moe_helpers as jmh
from sgl_kernel_npu_tpu_torch.ops import activation as tact
from sgl_kernel_npu_tpu_torch.ops import moe_helpers as tmh
from sgl_kernel_npu_tpu_torch.parallel import Buffer as TBuffer
from sgl_kernel_npu_tpu_torch.parallel import EPGroup, FuseMode
from sgl_kernel_npu_tpu_torch.parallel import elastic as tel
from sgl_kernel_npu_tpu_torch.parallel import fused_moe as tfm
from sgl_kernel_npu_tpu_torch.parallel import layout as tlayout
from sgl_kernel_npu_tpu_torch.parallel.strategies import fused_moe_pallas as tfmp
from sgl_kernel_npu_tpu_torch.parallel.strategies import low_latency as tll
from sgl_kernel_npu_tpu_torch.parallel.strategies import pallas_ll as tpll

from .utils import calc_diff

H, F, T, K = 256, 128, 16, 2
LAYER_DIFF = 1e-5
TIER_DIFF = 1e-4
FLIP_SHARE = 5e-3


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    """numpy / jax array -> torch tensor (bf16 stays bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _mesh(r=1):
    return Mesh(np.array(jax.devices()[:r]), ("ep",))


def _qw(rng, e, kd, n):
    w = (rng.standard_normal((e, kd, n)) * 0.05).astype(np.float32)
    s = (np.abs(w).max(axis=1) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s[:, None, :]), -127, 127).astype(np.int8), s


def make_layer(rng, ranks=1, experts=None, t=T, k=K, route="random"):
    """Seeded numpy inputs of one MoE layer across `ranks` ranks (x and the
    routing for ranks * t tokens): routes "random" (k distinct experts per
    token), "skewed" (every copy to experts 0 .. k-1, the others get no
    rows; with 2 experts, every token to expert 0 and a -1 slot), "drop"
    (random, with some slots -1 and, above 2 experts, expert 1 never
    chosen)."""
    e = experts or 2 * ranks
    n = ranks * t
    x = np.asarray(jnp.asarray(rng.standard_normal((n, H)) * 0.3, jnp.bfloat16))
    if route == "skewed":
        idx = np.tile(np.arange(k, dtype=np.int32), (n, 1))
        if e == 2:
            idx[:, 1:] = -1
    else:
        pool = [i for i in range(e) if route != "drop" or i != 1 or e == 2]
        idx = np.stack([rng.choice(pool, k, replace=False) for _ in range(n)]).astype(np.int32)
        if route == "drop":
            idx[rng.random((n, k)) < 0.2] = -1
    w = rng.random((n, k)).astype(np.float32)
    w13q, w13s = _qw(rng, e, H, 2 * F)
    w2q, w2s = _qw(rng, e, F, H)
    return dict(x=x, idx=idx, w=w, w13q=w13q, w13s=w13s, w2q=w2q, w2s=w2s)


def assert_bf16_sum_close(got, want, name=""):
    """One bf16 ulp of want plus 1e-6 of max|want| (module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert not bad.any(), (name, float(err.max()), int(bad.sum()))


def assert_flips(got, want, name=""):
    """int8 entries: at most 1 LSB apart, on at most FLIP_SHARE of them."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1, (name, int(d.max()))
    assert (d > 0).mean() <= FLIP_SHARE, (name, float((d > 0).mean()))


def assert_f32_ulp(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp), (name, float(np.abs(got - want).max()))


def assert_layer_close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)), name
    assert calc_diff(got, want) < LAYER_DIFF, (name, calc_diff(got, want))
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05, err_msg=name)


# ------------------------------------------------------------- routing, layout


@pytest.mark.parametrize("case", ["plain", "shared", "elastic"])
def test_route_copies_exact(rng, case):
    """_route_copies and the send layout (sorted copies, counts, the
    chunk-aligned offsets and slot rows) equal the JAX package's, with
    shared-expert ranks and with an elastic remap (rank 1 folded onto 2, rank
    3 dropped)."""
    r, el, t, k = 4, 3, 10, 3
    idx = np.stack([rng.choice(r * el, k, replace=False) for _ in range(t)]).astype(np.int32)
    idx[2, 1] = -1
    kw_j, kw_t, s = {}, {}, 0
    if case == "shared":
        s = 1
    if case == "elastic":
        remap = np.array([0, 2, 2, -1], np.int32)
        kw_j["elastic_info"] = jel.ElasticInfo(
            jnp.int32(1), jnp.int32(3), jnp.int32(0), jnp.int32(9), jnp.asarray(remap))
        kw_t["elastic_info"] = tel.ElasticInfo(
            torch.tensor(1, dtype=torch.int32), torch.tensor(3, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32), torch.tensor(9, dtype=torch.int32),
            torch.from_numpy(remap))
    jk, jok = jll._route_copies(jnp.asarray(idx), r, el, shared_expert_rank_num=s, **kw_j)
    tk_, tok = tll._route_copies(torch.from_numpy(idx), r, el, shared_expert_rank_num=s, **kw_t)
    assert np.array_equal(np.asarray(jk), tk_.numpy()) and np.array_equal(np.asarray(jok),
                                                                         tok.numpy())
    n = tk_.shape[0]
    _, copy_slot, counts = tll._sorted_copies(tk_, n, r * el)
    jcounts = np.bincount(np.asarray(jk), minlength=r * el + 1)[: r * el]
    assert np.array_equal(counts.numpy(), jcounts)
    order = np.argsort(np.asarray(jk), kind="stable")
    want_slot = np.full(n, n)
    live = np.asarray(jk)[order] < r * el
    want_slot[order[live]] = np.arange(n)[live]
    assert np.array_equal(copy_slot.numpy(), want_slot)
    offs = np.cumsum(jcounts) - jcounts
    ja, jp, jsb = jpll._aligned_layout(jnp.asarray(jcounts), jnp.asarray(offs), n, r, el, 8)
    ta, tp, tsb = tpll._aligned_layout(counts, tll._exclusive_cumsum(counts), n, r, el, 8)
    assert jsb == tsb and np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("cap", [24, 40])
def test_compact_slots_exact(rng, cap):
    """Both compactions equal the JAX package's, with an expert of no rows
    and a capacity that cuts rows off (24)."""
    r, el, maxt = 2, 3, 16
    rc = rng.integers(0, maxt + 1, (r, el)).astype(np.int32)
    rc[:, 1] = 0
    j = jfm._compact_slots(jnp.asarray(rc), r, el, maxt, cap)
    t = tfm._compact_slots(torch.from_numpy(rc), r, el, maxt, cap)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
    j = jfm._compact_slots_aligned(jnp.asarray(rc), r, el, maxt, cap, 8)
    t = tfm._compact_slots_aligned(torch.from_numpy(rc), r, el, maxt, cap, 8)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_dispatch_layout_exact(rng):
    idx = np.stack([rng.choice(8, 3, replace=False) for _ in range(12)]).astype(np.int32)
    idx[0, 0] = -1
    j = jlayout.get_dispatch_layout(jnp.asarray(idx), 8, 4)
    t = tlayout.get_dispatch_layout(torch.from_numpy(idx), 8, 4)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jlayout.tokens_per_local_expert(jnp.asarray(idx), 8, 4)),
                          tlayout.tokens_per_local_expert(torch.from_numpy(idx), 8, 4).numpy())


# ------------------------------------------------------ dispatch and combine


def _jax_dispatch_combine(d, strategy, quant_mode, maxt):
    mesh = _mesh(1)
    e = d["w13q"].shape[0]
    buf = JBuffer(mesh, e, num_max_dispatch_tokens_per_rank=maxt,
                  low_latency_strategy=strategy)
    recv, sc, packed, lr, hd = buf.low_latency_dispatch(
        jnp.asarray(d["x"]), jnp.asarray(d["idx"]), quant_mode=quant_mode)
    comb_in = _combine_input(_np(recv), None if sc is None else np.asarray(sc))
    comb = buf.low_latency_combine(jnp.asarray(comb_in, jnp.bfloat16), jnp.asarray(d["idx"]),
                                   jnp.asarray(d["w"]), hd)
    return recv, sc, packed, lr, hd, comb_in, comb


def _combine_input(recv, scales):
    """The combine's input, the same bf16 values on both sides: recv
    dequantised (int8) or as is (bf16)."""
    v = recv.astype(np.float32) * (scales[..., None] if scales is not None else 1.0)
    return np.asarray(jnp.asarray(v, jnp.bfloat16)).astype(np.float32)


@pytest.mark.parametrize("quant_mode", ["int8", "bf16"])
@pytest.mark.parametrize("strategy", ["default", "pallas", "alltoall"])
def test_ll_dispatch_combine_exact(rng, strategy, quant_mode):
    """Buffer.low_latency_dispatch at one rank: recv (padding rows and all),
    scales, counts and the handle bit-equal to the JAX Buffer's; the
    combine within one bf16 ulp. Skewed routing puts 32 copies on expert 0
    and none on the others."""
    maxt = 32
    for route in ("random", "skewed"):
        d = make_layer(rng, experts=4, route=route)
        recv, sc, packed, lr, hd, comb_in, comb = _jax_dispatch_combine(
            d, strategy, quant_mode, maxt)
        tb = TBuffer(None, 4, num_max_dispatch_tokens_per_rank=maxt,
                     low_latency_strategy=strategy)
        idx = torch.from_numpy(d["idx"])
        trecv, tsc, tpacked, tlr, thd = tb.low_latency_dispatch(_t(d["x"]), idx,
                                                                quant_mode=quant_mode)
        assert np.array_equal(_np(recv), _f(trecv)), (strategy, route)
        assert (sc is None) == (tsc is None)
        if sc is not None:
            assert np.array_equal(np.asarray(sc), tsc.numpy())
        assert np.array_equal(np.asarray(packed), tpacked.numpy())
        assert np.array_equal(np.asarray(lr), tlr.numpy())
        for f_ in ("copy_slot", "send_counts", "input_offsets", "recv_counts"):
            assert np.array_equal(np.asarray(getattr(hd, f_)), getattr(thd, f_).numpy()), f_
        tcomb = tb.low_latency_combine(torch.from_numpy(comb_in).to(torch.bfloat16), idx,
                                       torch.from_numpy(d["w"]), thd)
        assert_bf16_sum_close(_f(tcomb), _np(comb), f"{strategy} {route}")


def test_jax_pallas_tier_below_chunk_loses_rows():
    """maxT < CHUNK: the JAX pallas strategy takes maxT = 4, but a slice's
    8-row chunk then reaches into the next slot region, and its interpreted
    kernel loses rows that its default strategy keeps (a standing difference
    of the reference). The port keeps its refusal of maxT % CHUNK != 0, in
    the pallas dispatch (K12) and in the fused layer (K11)."""
    rng = np.random.default_rng(1)
    experts, t, k, h, maxt = 4, 4, 2, 32, 4
    x = jnp.asarray(rng.standard_normal((t, h), dtype=np.float32), jnp.bfloat16)
    idx = np.stack([rng.choice(experts, k, replace=False) for _ in range(t)]).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    outs = {}
    for strat in ("default", "pallas"):
        buf = JBuffer(_mesh(), experts, low_latency_strategy=strat,
                      num_max_dispatch_tokens_per_rank=maxt)
        recv, _, _, lr, hd = buf.low_latency_dispatch(x, jnp.asarray(idx), quant_mode="bf16")
        comb = buf.low_latency_combine(recv.astype(jnp.float32), jnp.asarray(idx),
                                       jnp.asarray(w), hd)
        outs[strat] = (_np(recv), np.asarray(lr).reshape(-1), _np(comb))
    (drecv, dlr, dcomb), (precv, plr, pcomb) = outs["default"], outs["pallas"]
    want = _np(x) * w.sum(-1, keepdims=True)
    np.testing.assert_allclose(dcomb, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(dlr, plr) and dlr.sum() == t * k
    assert not all(np.array_equal(precv[e, :n], drecv[e, :n]) for e, n in enumerate(dlr))
    assert np.abs(pcomb - want).max() > 0.5
    tb = TBuffer(None, experts, num_max_dispatch_tokens_per_rank=maxt,
                 low_latency_strategy="pallas")
    with pytest.raises(ValueError, match="multiple of CHUNK"):
        tb.low_latency_dispatch(_t(x), torch.from_numpy(idx), quant_mode="bf16")
    with pytest.raises(ValueError, match="multiple of CHUNK"):
        tfmp.fused_deep_moe_pallas_shard(
            _t(x), torch.from_numpy(idx), torch.from_numpy(w), None, None, None, None,
            group=EPGroup(None), num_experts=experts, num_max_dispatch_tokens_per_rank=maxt)


@pytest.mark.parametrize("num_ranks", [1, 8, 16, 32, 64])
def test_config_presets_match_jax(num_ranks):
    """Buffer's dispatch and combine presets per EP size equal the JAX
    package's."""
    for name in ("get_dispatch_config", "get_combine_config"):
        got = getattr(TBuffer, name)(num_ranks)
        want = getattr(JBuffer, name)(num_ranks)
        assert got.chunk_tokens == want.chunk_tokens, (name, num_ranks)


def test_cumulative_recv_stats_and_bf16_dispatch(rng, monkeypatch):
    """The cumulative per-expert receive counters add packed_recv_count;
    the fp8 mode dispatches float8_e4m3fn rows with f32 scales and an
    unknown mode raises; SKT_BF16_DISPATCH turns an int8 dispatch, low
    latency or normal, into bf16 (no scales)."""
    d = make_layer(rng, experts=4)
    tb = TBuffer(None, 4, num_max_dispatch_tokens_per_rank=32)
    stats = torch.arange(4, dtype=torch.int32)
    out = tb.low_latency_dispatch(_t(d["x"]), torch.from_numpy(d["idx"]),
                                  cumulative_local_expert_recv_stats=stats)
    assert torch.equal(out[5], stats + out[2])
    recv, sc = tb.low_latency_dispatch(_t(d["x"]), torch.from_numpy(d["idx"]),
                                       quant_mode="fp8")[:2]
    assert recv.dtype == torch.float8_e4m3fn and sc.dtype == torch.float32
    with pytest.raises(ValueError):
        tb.low_latency_dispatch(_t(d["x"]), torch.from_numpy(d["idx"]), quant_mode="fp4")
    monkeypatch.setenv("SKT_BF16_DISPATCH", "1")
    recv, sc = tb.low_latency_dispatch(_t(d["x"]), torch.from_numpy(d["idx"]))[:2]
    assert recv.dtype == torch.bfloat16 and sc is None
    recv, sc = tb.dispatch(_t(d["x"]), torch.from_numpy(d["idx"]), torch.from_numpy(d["w"]),
                           quant_mode="int8")[:2]
    assert recv.dtype == torch.bfloat16 and sc is None


# ------------------------------------------------------------ K12: the scatter


@pytest.mark.parametrize("quantize", [True, False])
def test_remote_scatter_matches_jax_kernel(rng, quantize):
    """The plain version of K12 against the JAX kernel (interpreted), on the
    pallas dispatch's tables (one expert with no rows, ragged counts): out
    and scales bit-equal, zero rows and padding-row scales included; without
    quantisation scales ride along."""
    el, maxt = 4, 32
    counts = np.array([13, 0, 32, 5], np.int32)
    offs = np.cumsum(counts) - counts
    tk = int(counts.sum())
    ja, _, sbuf = jpll._aligned_layout(jnp.asarray(counts), jnp.asarray(offs), tk, 1, el, maxt)
    al = np.asarray(ja).astype(np.int32)
    dst = (np.arange(el) * maxt).astype(np.int32)
    x = np.array(jnp.asarray(rng.standard_normal((sbuf, H)) * 2, jnp.bfloat16))
    x[al[0] + 13: al[0] + 16] = 0                  # the chunk padding of the send buffer
    scales = None if quantize else rng.random((sbuf, 1)).astype(np.float32)

    def fn(xx, *ss):
        return jpll._remote_scatter(
            xx, ss[0] if ss else None, jnp.asarray(counts), jnp.asarray(al),
            jnp.asarray(dst), jnp.asarray(counts), num_ranks=1, slices_per_rank=el,
            out_rows=el * maxt, quantize=quantize)

    args = (jnp.asarray(x),) + (() if scales is None else (jnp.asarray(scales),))
    jo, js = jax.jit(jax.shard_map(fn, mesh=_mesh(1), in_specs=(P(),) * len(args),
                                   out_specs=(P(), P()), check_vma=False))(*args)
    to, ts = tpll._remote_scatter(
        _t(x), None if scales is None else torch.from_numpy(scales[:, 0]),
        torch.from_numpy(counts), torch.from_numpy(al), torch.from_numpy(dst),
        torch.from_numpy(counts), group=EPGroup(None), slices_per_rank=el,
        out_rows=el * maxt, quantize=quantize)
    assert np.array_equal(_np(jo), _f(to))
    assert np.array_equal(np.asarray(js)[:, 0], ts.numpy())
    if quantize:
        assert ts[13:16].eq(np.float32(1e-7) * np.float32(1 / 127)).all()   # live-chunk padding
        assert not ts[16:32].any() and not to[16:32].any()                   # never written


def _k12_layouts():
    """K12's layouts by name: (send_cnt, src_off, dst_off, src_rows,
    out_rows). The bench layout is the pallas strategy's at chip_smoke.py's
    MoE shape (8 experts, maxT 128, 128 tokens, top-8): its dispatch (the
    1,088-row send buffer into the 1,024-row window) and its combine (back);
    the edges: an empty slice and counts off a multiple of 8, a chunk
    running past src_rows, one running past out_rows, gaps between windows,
    offsets off a multiple of 8, and no rows at all."""
    r = np.random.default_rng(0)
    idx = np.stack([r.choice(8, 8, replace=False) for _ in range(128)]).astype(np.int32)
    _, _, counts, _, al, _, sbuf = tpll._send_layout(torch.from_numpy(idx), 1, 8, 128)
    win = tll._window_offsets(1, 8, 128, torch.device("cpu"), 0)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    ragged = np.array([13, 0, 32, 5], np.int32)
    ja, _, rbuf = jpll._aligned_layout(jnp.asarray(ragged), jnp.asarray(np.cumsum(ragged) - ragged),
                                       int(ragged.sum()), 1, 4, 32)
    return {
        "bench dispatch": (counts, al, win, sbuf, 8 * 128),
        "bench combine": (counts, win, al, 8 * 128, sbuf),
        "empty slice, ragged counts": (torch.from_numpy(ragged), _t(ja).int(),
                                       i32(0, 32, 64, 96), rbuf, 128),
        "chunk past src_rows": (i32(5, 12), i32(0, 16), i32(0, 32), 26, 64),
        "chunk past out_rows": (i32(8, 11), i32(0, 8), i32(0, 40), 24, 48),
        "gaps between windows": (i32(3, 9, 16), i32(0, 8, 24), i32(0, 24, 64), 40, 96),
        "offsets off a multiple of 8": (i32(7, 4), i32(3, 13), i32(5, 17), 16, 32),
        "no rows": (i32(0, 0, 0), i32(0, 0, 0), i32(0, 8, 16), 24, 24),
    }


@pytest.mark.parametrize("mode", ["quantise bf16", "quantise f32", "copy with scales"])
@pytest.mark.parametrize("layout", sorted(_k12_layouts()))
def test_k12_row_map_matches_the_plain_scatter(rng, layout, mode):
    """K12's row map (scatter_row_map, which the kernel mirrors) against the
    plain version's output: every window row is its mapped source row
    (quantised, or copied with its scale) or zero with scale 0, bit for
    bit; a mapped row lies in its slice's chunk-rounded window."""
    cnt, so, do, src_rows, out_rows = _k12_layouts()[layout]
    quantize = mode.startswith("quantise")
    x = torch.from_numpy(rng.standard_normal((src_rows, 64)).astype(np.float32) * 2)
    if mode != "quantise f32":
        x = x.to(torch.bfloat16)
    scales = None if quantize else torch.from_numpy(rng.random(src_rows).astype(np.float32))
    out, s_out = tpll.remote_scatter_ref(x, scales, cnt, so, do, cnt, group=EPGroup(None),
                                         slices_per_rank=cnt.numel(), out_rows=out_rows,
                                         quantize=quantize)
    sl, row = tpll.scatter_row_map(cnt, so, do, src_rows, out_rows)
    rows, row_scales = tpll.quant_rows_ref(x) if quantize else (x, scales)
    live = row >= 0
    want = torch.zeros_like(out)
    want[live] = rows[row[live]]
    want_s = torch.zeros((out_rows,), dtype=torch.float32)
    want_s[live] = row_scales[row[live]]
    assert torch.equal(out, want) and torch.equal(s_out, want_s)
    assert torch.equal(sl >= 0, live)
    dst0 = do.long() // tpll.CHUNK * tpll.CHUNK
    d = torch.arange(out_rows)[live]
    assert ((d >= dst0[sl[live]]) & (d < dst0[sl[live]] + tpll._chunked(cnt)[sl[live]])).all()
    if layout == "bench dispatch":
        assert bool(live.all())                      # the window is full: no zero row
    if layout == "no rows":
        assert not bool(live.any())


# --------------------------------------------------------- K11: the fused layer


def _jax_fused_with_internals(d, maxt, monkeypatch):
    """fused_deep_moe_pallas_shard at one rank, with the kernel's own
    outputs (recv, rs, back) recorded from its pallas_call."""
    captured = []
    orig = jfmp.pl.pallas_call

    def recording(*a, **kw):
        f = orig(*a, **kw)

        def call(*args):
            outs = f(*args)
            captured.append(outs)
            return outs
        return call

    monkeypatch.setattr(jfmp.pl, "pallas_call", recording)
    e = d["w13q"].shape[0]

    def fn(x, i, w, aq, as_, bq, bs_):
        out = jfmp.fused_deep_moe_pallas_shard(
            x, i, w, aq, as_, bq, bs_, axis_name="ep", num_experts=e, num_ranks=1,
            num_max_dispatch_tokens_per_rank=maxt)
        return (out, *captured[-1])

    args = [jnp.asarray(d[k]) for k in ("x", "idx", "w", "w13q", "w13s", "w2q", "w2s")]
    out = jax.jit(jax.shard_map(fn, mesh=_mesh(1), in_specs=(P(),) * 7, out_specs=(P(),) * 4,
                                check_vma=False))(*args)
    monkeypatch.undo()
    return [np.asarray(o) for o in out]


def _jax_expert_act(recv, rs, d):
    """The requantised SwiGLU activation the JAX kernel feeds GMM2, in jnp
    (its f32 GMM1 dequant, XLA's sigmoid, the same scale rule)."""
    el = d["w13q"].shape[0]
    rows = recv.shape[0] // el
    outs = []
    for e in range(el):
        q = jnp.asarray(recv[e * rows:(e + 1) * rows]).astype(jnp.int32)
        acc = (q @ jnp.asarray(d["w13q"][e]).astype(jnp.int32)).astype(jnp.float32)
        ug = acc * jnp.asarray(rs[e * rows:(e + 1) * rows, :1]) * jnp.asarray(d["w13s"][e])[None]
        g, u = ug[:, :F], ug[:, F:]
        act = g * jax.nn.sigmoid(g) * u
        sc = jnp.maximum(jnp.max(jnp.abs(act), -1, keepdims=True), 1e-7) / 127.0
        outs.append(np.asarray(jnp.clip(jnp.round(act / sc), -128, 127).astype(jnp.int8)))
    return np.concatenate(outs)


@pytest.mark.parametrize("route", ["random", "skewed", "drop"])
def test_fused_layer_matches_jax_kernel(rng, monkeypatch, route):
    """K11's plain version against fused_deep_moe_pallas_shard at one rank
    and 2 experts: recv and rs bit-equal, the requantised activation within
    the flip bound, back and the layer output within the layer bound.
    Routes: random, skewed (every copy to expert 0, expert 1 with no rows, a
    -1 slot per token), and random with -1 slots."""
    maxt = T * K
    d = make_layer(rng, experts=2, route=route)
    out, recv, rs, back = _jax_fused_with_internals(d, maxt, monkeypatch)
    tx = _t(d["x"])
    idx = torch.from_numpy(d["idx"])
    w13q, w13s = torch.from_numpy(d["w13q"]), torch.from_numpy(d["w13s"])
    w2q, w2s = torch.from_numpy(d["w2q"]), torch.from_numpy(d["w2s"])
    g = EPGroup(None)
    tok, _, counts, _, al, apos, sbuf = tpll._send_layout(idx, 1, 2, maxt)
    x_send = tpll.send_buffer(tx[tok], apos, sbuf)
    trecv, trs, tback = tfmp.fused_moe_layer(
        x_send, w13q, w13s, w2q, w2s, counts, al, tll._window_offsets(1, 2, maxt, "cpu", 0),
        counts, al, group=g, maxt=maxt)
    assert np.array_equal(recv, trecv.numpy())
    assert np.array_equal(rs[:, 0], trs.numpy())
    _, act_q, _ = tfmp.expert_rows_ref(trecv, trs, w13q, w13s, w2q, w2s)
    assert_flips(act_q.numpy(), _jax_expert_act(recv, rs, d), route)
    assert_layer_close(_f(tback), back.astype(np.float32), f"back {route}")
    tout = tfmp.fused_deep_moe_pallas_shard(tx, idx, torch.from_numpy(d["w"]), w13q, w13s, w2q,
                                            w2s, group=g, num_experts=2,
                                            num_max_dispatch_tokens_per_rank=maxt)
    assert_layer_close(_f(tout), out.astype(np.float32), f"out {route}")


@pytest.mark.parametrize("route", ["random", "skewed"])
def test_fused_layer_four_experts_matches_jax_composition(rng, route):
    """At 4 experts the JAX kernel, interpreted, reuses each of its two
    out_buf slots before the simulator performs the copies from it (it
    returns another expert's rows there), so the port's fused layer is held
    against the JAX package's composition tier instead, within TIER_DIFF:
    the composition rounds GMM1's output to bf16, the fused layer keeps it
    in f32."""
    d = make_layer(rng, experts=4, route=route)
    want = _np(_jax_buffer_moe(d, "default", 32))
    got = _f(_torch_buffer_moe(d, "pallas", 32))
    assert np.all(np.isfinite(got))
    assert calc_diff(got, want) < TIER_DIFF, calc_diff(got, want)


# ------------------------------------------------------- the composition tier


def _jax_buffer_moe(d, strategy, maxt, **kw):
    e = d["w13q"].shape[0]
    buf = JBuffer(_mesh(1), e, num_max_dispatch_tokens_per_rank=maxt,
                  low_latency_strategy=strategy)
    args = [jnp.asarray(d[k]) for k in ("x", "idx", "w", "w13q", "w13s", "w2q", "w2s")]
    return buf.fused_deep_moe(*args, **kw)


def _torch_buffer_moe(d, strategy, maxt, **kw):
    e = d["w13q"].shape[0]
    buf = TBuffer(None, e, num_max_dispatch_tokens_per_rank=maxt, low_latency_strategy=strategy)
    args = [_t(d[k]) for k in ("x", "idx", "w", "w13q", "w13s", "w2q", "w2s")]
    return buf.fused_deep_moe(*args, **kw)


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_fused_deep_moe_rounds_match_jax(rng, rounds):
    """fused_deep_moe_shard (default strategy, aligned compaction, K8's plain
    version) at chunk_rounds 1, 2 and 4 against the JAX Buffer."""
    d = make_layer(rng, experts=4)
    want = _jax_buffer_moe(d, "default", 32, chunk_rounds=rounds)
    got = _torch_buffer_moe(d, "default", 32, chunk_rounds=rounds)
    assert_layer_close(_f(got), _np(want), f"rounds={rounds}")


@pytest.mark.parametrize("strategy", ["default", "pallas"])
def test_buffer_fused_deep_moe_both_tiers(rng, strategy):
    """Buffer.fused_deep_moe end to end at one rank, both tiers: the pallas
    strategy's single launch (K11) and, with capacity_rows, the composition
    through its scatter (K12); the default strategy's composition. Holds
    each against the JAX Buffer (2 experts, see the test above), and the
    fused layer against rounds = 1 within TIER_DIFF."""
    d = make_layer(rng, experts=2, route="drop")
    for kw in ({}, {"capacity_rows": 24}):
        want = _jax_buffer_moe(d, strategy, 32, **kw)
        got = _torch_buffer_moe(d, strategy, 32, **kw)
        assert_layer_close(_f(got), _np(want), f"{strategy} {kw}")
    if strategy == "pallas":
        fused = _f(_torch_buffer_moe(d, "pallas", 32))
        rounds1 = _f(_torch_buffer_moe(d, "default", 32))
        assert calc_diff(fused, rounds1) < TIER_DIFF


def test_dispatch_ffn_combine_matches_jax(rng):
    """FuseMode.DISPATCH_FFN_COMBINE: int64 bit-pattern scales, the received
    bound, and expert_token_nums."""
    d = make_layer(rng, experts=4)
    i64 = {k: np.frombuffer(d[k].tobytes(), np.int32).astype(np.int64)
           .reshape(d[k].shape) for k in ("w13s", "w2s")}
    e = 4
    jbuf = JBuffer(_mesh(1), e, num_max_dispatch_tokens_per_rank=32)
    jargs = [jnp.asarray(d[k]) for k in ("x", "idx", "w", "w13q")] + [
        jnp.asarray(i64["w13s"]), jnp.asarray(d["w2q"]), jnp.asarray(i64["w2s"])]
    jout, jnums = jbuf.fused_deep_moe(*jargs, fuse_mode=jbuf_fuse_mode())
    tbuf = TBuffer(None, e, num_max_dispatch_tokens_per_rank=32)
    targs = [_t(d[k]) for k in ("x", "idx", "w", "w13q")] + [
        torch.from_numpy(i64["w13s"]), _t(d["w2q"]), torch.from_numpy(i64["w2s"])]
    tout, tnums = tbuf.fused_deep_moe(*targs, fuse_mode=FuseMode.DISPATCH_FFN_COMBINE)
    assert np.array_equal(np.asarray(jnums), tnums.numpy())
    assert_layer_close(_f(tout), _np(jout), "dispatch_ffn_combine")
    assert np.array_equal(tfm.scale_int64_to_float(torch.from_numpy(i64["w2s"])).numpy(),
                          d["w2s"])
    assert (FuseMode.NONE, FuseMode.FUSED_DEEP_MOE, FuseMode.DISPATCH_FFN_COMBINE) == (0, 1, 2)


def jbuf_fuse_mode():
    from sgl_kernel_npu_tpu.parallel.buffer import FuseMode as JFuseMode
    return JFuseMode.DISPATCH_FFN_COMBINE


# ------------------------------------------------------------ K13 swiglu_quant


@pytest.mark.parametrize("do_limit", [False, True])
@pytest.mark.parametrize("group_list_type", [0, 1])
def test_swiglu_quant_matches_jax(rng, do_limit, group_list_type):
    """swiglu_quant's plain version against the JAX Pallas kernel and its
    jnp reference: int8 within the flip bound, scales within one f32 ulp;
    rows past the group total are zero with scale 0. Inputs of 2.5 standard
    deviations, so that the clamp at 3.0 bites."""
    s, n = 96, 256
    x = np.asarray(jnp.asarray(rng.standard_normal((s, 2 * n)) * 2.5, jnp.bfloat16))
    counts = np.array([20, 0, 33], np.int32)
    gl = counts if group_list_type == 1 else np.cumsum(counts).astype(np.int32)
    kw = dict(do_limit=do_limit, limit=3.0)
    jq, js = jact._swiglu_quant_pallas(jnp.asarray(x), jnp.int32(53), do_limit, 3.0)
    rq, rs_ = jact.swiglu_quant_ref(jnp.asarray(x), jnp.asarray(gl), group_list_type, **kw)
    tq, ts = tact.swiglu_quant(_t(x), torch.from_numpy(gl), group_list_type, **kw)
    for q_, s_ in ((jq, js), (rq, rs_)):
        assert_flips(tq.numpy(), np.asarray(q_), f"limit={do_limit}")
        assert_f32_ulp(ts.numpy(), np.asarray(s_))
    assert not tq[53:].any() and not ts[53:].any()
    out, zeros = tact.swiglu_quant(_t(x), torch.from_numpy(gl), group_list_type,
                                   need_quant=False, **kw)
    jout, _ = jact.swiglu_quant(jnp.asarray(x), jnp.asarray(gl), group_list_type,
                                need_quant=False, **kw)
    assert_bf16_sum_close(_f(out), _np(jout))
    assert not zeros.any()


@pytest.mark.parametrize("form", ["f32 x", "f32 x with the limit", "N 1003",
                                  "N 1003 f32 with the limit"])
def test_swiglu_quant_forms_match_jax(rng, form):
    """swiglu_quant's plain version with f32 x and at a width that is no
    multiple of 8 (the forms the card's kernel takes by other loads) against
    the JAX Pallas kernel and its jnp reference, at the bars above; rows past
    the group total are zero with scale 0."""
    s, n = 72, 1003 if form.startswith("N 1003") else 256
    dtype = jnp.float32 if "f32" in form else jnp.bfloat16
    do_limit = "limit" in form
    x = np.asarray(jnp.asarray(rng.standard_normal((s, 2 * n)) * 2.5, dtype))
    gl = np.array([30, 0, 11], np.int32)
    kw = dict(do_limit=do_limit, limit=3.0)
    jq, js = jact._swiglu_quant_pallas(jnp.asarray(x), jnp.int32(41), do_limit, 3.0)
    rq, rs_ = jact.swiglu_quant_ref(jnp.asarray(x), jnp.asarray(gl), 1, **kw)
    tq, ts = tact.swiglu_quant(_t(x), torch.from_numpy(gl), 1, **kw)
    assert tq.shape == (s, n) and tq.dtype == torch.int8
    for q_, s_ in ((jq, js), (rq, rs_)):
        assert_flips(tq.numpy(), np.asarray(q_), form)
        assert_f32_ulp(ts.numpy(), np.asarray(s_), form)
    assert not tq[41:].any() and not ts[41:].any()
    assert ts[:41].all()


@pytest.mark.parametrize("lists", ["empty list of counts", "list type 2 (counts)",
                                   "cumulative list ending at S"])
def test_swiglu_quant_group_lists_match_jax(rng, lists):
    """swiglu_quant's plain version on the group lists whose total the
    card's kernel reduces itself (an empty list of counts is total 0, any
    type but 0 a list of counts) against the JAX Pallas kernel given that
    total and its jnp reference, at the bars above."""
    s, n = 40, 256
    gl, gtype, total = {"empty list of counts": (np.zeros(0, np.int32), 1, 0),
                        "list type 2 (counts)": (np.array([9, 14], np.int32), 2, 23),
                        "cumulative list ending at S": (np.array([10, 40], np.int32), 0, 40)}[lists]
    x = np.asarray(jnp.asarray(rng.standard_normal((s, 2 * n)) * 2.5, jnp.bfloat16))
    jq, js = jact._swiglu_quant_pallas(jnp.asarray(x), jnp.int32(total), False, 7.0)
    rq, rs_ = jact.swiglu_quant_ref(jnp.asarray(x), jnp.asarray(gl), gtype)
    tq, ts = tact.swiglu_quant(_t(x), torch.from_numpy(gl), gtype)
    for q_, s_ in ((jq, js), (rq, rs_)):
        assert_flips(tq.numpy(), np.asarray(q_), lists)
        assert_f32_ulp(ts.numpy(), np.asarray(s_), lists)
    assert not tq[total:].any() and not ts[total:].any()
    assert ts[:total].all()


@pytest.mark.parametrize("values", ["uniform", "half-integer quotients"])
def test_k13_quant_fast_path_model(rng, values):
    """A float32 model of K13's quantisation fast path (csrc/swiglu_quant.cu
    quant_fast): u = (v * (1 / scale) + 0.5) rounded at each step, kept
    where |u| < 256 and u is more than 1.5e-4 from an integer, gives the
    parent's floor(v / scale + 0.5) (IEEE division) everywhere it is kept,
    here on 1 M values over row scales from 1e-13 to 2e4; in the second
    case every value within 64 ulps of a quotient k + 0.5, where the sum
    lands near an integer and the fast path must decline the nearest."""
    f32 = np.float32
    for _ in range(4):
        amax = f32(np.exp(rng.uniform(-30, 10)))
        scale = f32(amax * f32(1.0 / 127.0))
        n = 250_000
        if values == "uniform":
            v = (rng.uniform(-1, 1, n).astype(f32) * amax).astype(f32)
        else:
            v = ((rng.integers(-127, 127, n).astype(f32) + f32(0.5)) * scale).astype(f32)
            v = (v + rng.integers(-64, 65, n).astype(f32) * np.spacing(v)).astype(f32)
        v = np.clip(v, -amax, amax).astype(f32)
        want = np.floor((v / scale).astype(f32) + f32(0.5)).astype(f32)
        u = ((v * (f32(1) / scale)).astype(f32) + f32(0.5)).astype(f32)
        kept = (np.abs(u) < 256) & (np.abs((u - np.rint(u)).astype(f32)) > f32(1.5e-4))
        assert 0.99 < kept.mean() if values == "uniform" else 0.1 < kept.mean() < 0.9
        assert np.array_equal(np.floor(u)[kept], want[kept])


def test_swiglu_oai_and_moe_helpers(rng):
    x = np.asarray(jnp.asarray(rng.standard_normal((8, 64)) * 4, jnp.bfloat16))
    assert_bf16_sum_close(_f(tact.swiglu_oai(_t(x))), _np(jact.swiglu_oai(jnp.asarray(x))))
    a = np.asarray(jnp.asarray(rng.standard_normal((8, 32)), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.standard_normal((8, 32)), jnp.bfloat16))
    assert np.array_equal(_f(tmh.mul_add(_t(a), _t(b), 0.7)),
                          _np(jmh.mul_add(jnp.asarray(a), jnp.asarray(b), 0.7)))
    idx = rng.integers(0, 12, (8, 4)).astype(np.int32)
    sc = rng.random((8, 4)).astype(np.float32)
    j = jmh.zero_experts_compute_identity(jnp.asarray(idx), jnp.asarray(sc), 8, "identity",
                                          jnp.asarray(a))
    t = tmh.zero_experts_compute_identity(torch.from_numpy(idx), torch.from_numpy(sc), 8,
                                          "identity", _t(a))
    for u, v in zip(j, t):
        assert np.array_equal(_np(u), _f(v))
