#!/usr/bin/env python3
"""Time the port's kernels as two or more checkouts build them, on one card,
in turns, each turn a fresh process that imports sgl_kernel_npu_tpu_torch
from its checkout and drives every kernel through that checkout's own
wrappers (so a kernel whose C interface changed between the checkouts needs
nothing of its own here).

  python3 scripts/compare_builds.py [--rounds N] [--only PREFIX,...] ROOT [ROOT ...]

With one ROOT, the second is this checkout. The turns run the roots forward
and back (a b b a for two, a b c c b a for three), ROUNDS times (default
1). Before the first turn every root builds its kernels, all roots at once
(one nvcc per source, as its _build.py builds them). A turn keeps the card
busy for a second so that its clocks ramp up, makes every case's inputs
from one seed (the same in every turn), holds each output against its plain
version, and times it by replaying a CUDA graph of the calls (median of 5
replays). The cases, each name a prefix that --only can pick:
  * K3 (tm2 int8 decode) at chip_smoke.py's phase 1 shape (128 sequences,
    8 kv heads of 4, pages of 512, 2 pages each, 0..1023 cached) and phase
    4's (one page, 256..383 cached); within chip_smoke.py's ATTN_TOL;
  * A (W8A8 GEMM on a stacked [2, K, N] bank, layer 1) at M 1, 8, 16, 17,
    32, 128, 672 on Llama-3-8B's wqkv, wo, w13, w2 and DeepSeek-V2-Lite's
    wo, w13, w2, f32 out on wqkv at M 8 and 128, and the L = 1 contract on
    both lm_heads at M 8 and 128; exact;
  * K1 (pretiled banks: wo, w2 at 512, lm_head at 768) at M 128 and 8;
    exact;
  * K2 per_token (Llama's wqkv and w13, pretiled at 512) at M 128 and 8;
    the same bits from every root;
  * C (tm int8 decode: 8 sequences of 40..700 tokens over 64 pages of 128,
    Llama's heads); within ATTN_TOL;
  * K8 at the Qwen bench path's expert w13 and w2 (5,376 rows in 32-row
    expert tiles) and at the EP MoE layer's GMM1 and GMM2 (the first
    round's aligned compaction at chunk_rounds 1: 2,048 rows in 128-row
    tiles, 8 experts of 7168 x 4096 and 2048 x 7168), and K11 (the MoE
    layer's bench shape, its recv); exact;
  * K5 (MLA decode over the combined latent cache) at chip_smoke.py's
    phase 1 shape (128 sequences, 16 heads, rows of 576, pages of 128, 3
    each, 0..319 cached), int8 and bf16 rows, and int8 over 6 pages (0..767
    cached: two softmax steps of 4 pages); within K5_SHARE;
  * K14 (v6 deferred decode over hm pages), bf16 and int8, at the bench
    shape (128 sequences, 32 / 8 heads, one page of 512, 256..383 cached),
    the engine's (8 sequences, 6 pages of 128) and G 16 (the bench shape
    with 2 kv heads); within K14_SHARE;
  * K10 (the Qwen bench shape); within K10_SHARE;
  * K9 (the gated delta rule's decode step) at the bench path's bf16 pool
    (128 sequences, 8 / 8 heads of 128, the rows of the last of 9 layers),
    and, where the root takes them, an f32 pool at Qwen3-Next-80B-A3B's GDN
    shape (16 / 32 heads of 128) and bf16 and f32 pools at D 32 (4 / 8
    heads); decay 1 and beta 0, so that a call rewrites the state it
    reads; within chip_smoke.py's GDN_SHARE;
  * K16's five contracts (v3 bf16 / int8, in the cache or deferred, and
    decode_int8kv) at the bench shape and K23's five (the attic's v5 pair,
    v4b int8 and the fused pair over stacked caches, layer 5 of 6) and K24
    (the attic's v7 two-tier decode) at chip_smoke.py's phase 13 shape (64
    sequences of 256..383 cached tokens, 128-token pages); within HM_SHARE
    (K24: K14_SHARE);
  * K12 (the pallas strategy's scatter) at chip_smoke.py's MoE bench
    layout: its quantising dispatch and its bf16 combine; exact;
  * K17 (laser attention, bf16 at Llama-3-8B's heads, D 128, B 1) at
    chip_smoke.py's LASER_CASES (causal T 8192, not causal T 4096, causal
    T 8000); within ATT_SHARE (one bf16 ulp + 1e-4 of max|plain|); and at
    three of its phase-21 rows ("K17 D 96 bf16", "K17 D 96 f32", "K17 D 80
    fp16": Phi-3-mini's 32 heads of 96 at T 4096 causal, Phi-2's 32 of 80
    at T 2048 causal), within phase 21's bar of their dtype;
  * K18 (the sparse-block estimator's scores, blocks of 128, causal) at
    both of chip_smoke.py's EST_SHAPES, and at [1, 8, 32768] not causal, a
    case only a root without the old NQ + NK <= 384 cap runs; within 1e-5
    of the largest |score|, the -1e30 entries exact;
  * K20 (add_rmsnorm_bias's quant pass, hidden 4096) at chip_smoke.py's
    phase 1 inputs: bf16 at N 128 (a decode batch) and 8192 (a prefill),
    f32 at N 128; h exact, the int8 within chip_smoke.py's K20_FLIP_SHARE;
  * K6 (the MLA latent append) at chip_smoke.py's check_append_mla shape
    (27 layers x 128 rows of 576 into 385 pages of 128, one row dropped),
    int8 and bf16 rows; exact;
  * D (the token-major int8 append, on K6's copy loop) at chip_smoke.py's
    check_append shapes: the decode step (32 layers x 8 rows, one padded,
    into 512 pages) and a prefill chunk (8 sequences of 512 rows, 1,746
    live, into 64 pages); exact;
  * K13 (swiglu_quant) at chip_smoke.py's phase 1 shape (2,048 x 4096,
    total 1,024), bf16 and f32 x, with and without do_limit (limit 3.0);
    within chip_smoke.py's MOE_FLIP_SHARE and one scale ulp, and the same
    bits from every root; and bf16 without the group list's reduction
    ("K13 bf16 kernel alone": the kernel given the total, exact);
  * the calls around them: phase 8's "pallas dispatch+combine" and "pallas
    capacity_rows=1024" MoE layer calls (bits only), and phase 11's sparse
    prefill at keep 0.25, T 8192 (K18, the threshold, the page lists and
    K15; CUDA events around eager calls, as chip_smoke.py times it; bits
    only, and they may differ between roots, as K18's f32 order may).
Each case must also give the same bits in every turn of its root (a case
that returns a tuple: each of its tensors), and in every root but for the
kernels whose sums another design may order otherwise (K3, C, K5, K10,
K14, K16, K17 at phase 21's widths, K18, K20's float64 sum of squares, K23,
K24, phase 11). Prints
the cases whose bits every root gives alike, and, per case, each root's
median over its turns and the ratio of each to the first root's, the sums
of the four Llama GEMMs of A at M 8 and 128, of K1's three at M 128 and of
K8's two at each shape, then the card's name and power limit. Needs one
CUDA card and nvcc; a turn of every case takes about a minute.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
H, Q, KV, F, V = 4096, 4096, 1024, 14336, 128256           # Llama-3-8B
MH, MF, MV, MHEADS = 2048, 10944, 102400, 16               # DeepSeek-V2-Lite
A_MS = (1, 8, 16, 17, 32, 128, 672)
A_WIDTHS = (("wqkv", H, Q + 2 * KV), ("wo", Q, H), ("w13", H, 2 * F), ("w2", F, H),
            ("mla wo", MHEADS * 128, MH), ("mla w13", MH, 2 * MF), ("mla w2", MF, MH))
# the kernels the cases launch (names of _build.KERNELS)
KERNELS = ("decode_tm2", "decode_tm", "w8a8_gemm", "w8a8_gemm_tiled", "rmsq_gemm",
           "append_tm", "swiglu_quant",
           "w8a8_gemm_grouped", "fused_moe", "decode_mla_c", "append_mla", "decode_v6_defer",
           "gdn_recurrent",
           "decode_v6_int8_defer", "decode_hm", "decode_v3", "decode_v3_int8",
           "decode_v3_defer", "decode_v3_int8_defer", "decode_int8kv", "decode_v5_defer",
           "decode_v5_int8_defer", "decode_v4b_int8", "decode_fused_v4_int8",
           "decode_fused_v4", "decode_v7_int8", "remote_scatter", "sparse_estimate",
           "laser_attention", "laser_attention_general",
           "add_rmsnorm_quant")
SUMS = {f"A wqkv + wo + w13 + w2 M {m}": [f"A {nm} M {m}" for nm in ("wqkv", "wo", "w13", "w2")]
        for m in (8, 128)}
SUMS["K1 wo + w2 + lm_head M 128"] = [f"K1 {nm} M 128" for nm in ("wo", "w2", "lm_head")]
SUMS["K8 Qwen w13 + w2"] = ["K8 Qwen expert w13", "K8 Qwen expert w2"]
SUMS["K8 MoE GMM1 + GMM2"] = ["K8 MoE GMM1", "K8 MoE GMM2"]


def _graph_ms(torch, fn, iters):
    """ms per call: `iters` calls captured in one CUDA graph, the median of
    REPS replays."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[REPS // 2]


def k3_inputs(torch, gen, mp, full=False):
    """K3's inputs at the bench path's widths: mp = 2, 0..1023 cached
    (phase 1's shape); mp = 1, 256..383 (phase 4's); `full`: every row
    holds mp whole pages. (q, k_new, v_new, caches, scales, cached, block
    table, sm_scale, page size), the caches of 2 layers."""
    b, hkv, g, d, ps = 128, 8, 4, 128, 512
    pages = b * mp + 1
    shape = (2, pages, hkv, ps, d)
    kc = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device="cuda")
    vc = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device="cuda")
    ks = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 0.001
    vs = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 0.001
    if full:
        cached = torch.full((b,), mp * ps, device="cuda", dtype=torch.int32)
    elif mp == 2:
        cached = torch.randint(0, mp * ps, (b,), generator=gen, device="cuda", dtype=torch.int32)
        cached[:5] = torch.tensor([0, 1, 511, 512, 513], dtype=torch.int32)
    else:
        cached = torch.randint(256, 384, (b,), generator=gen, device="cuda", dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = torch.randn((b, hkv * g, d), generator=gen, device="cuda").to(torch.bfloat16)
    kn = torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    return (q, kn, vn, kc, vc, ks, vs, cached, bt, d ** -0.5, ps)


def k5_inputs(torch, gen, mp, int8, max_cached):
    """K5's inputs at DeepSeek-V2-Lite's latent widths (16 heads, rows of 512
    | 64, pages of 128): 128 sequences of 0..max_cached - 1 cached tokens (0,
    1, 127, 128, 129, 256 among them), mp pages each, caches of 2 layers.
    Returns the wrapper's arguments and its keywords at layer 1."""
    b, h, lkv, c, ps = 128, 16, 512, 576, 128
    pages = b * mp + 1
    cached = torch.randint(0, max_cached, (b,), generator=gen, device="cuda", dtype=torch.int32)
    cached[:6] = torch.tensor([0, 1, 127, 128, 129, 256], dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = (1.5 * torch.randn((b, h, c), generator=gen, device="cuda")).to(torch.bfloat16)
    new = torch.randn((b, c), generator=gen, device="cuda").to(torch.bfloat16)
    shape = (2, pages, ps, c)
    if int8:
        cache = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device="cuda")
        scales = torch.rand((2, pages, 1, ps), generator=gen, device="cuda") * 0.02 + 0.005
    else:
        cache = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scales = None
    return (q, new, cache, cached, bt, 192 ** -0.5, ps, lkv), dict(layer_idx=1,
                                                                    kv_scales=scales)


def k14_inputs(torch, gen, shape, int8, hkv=8):
    """K14's inputs at Llama-3-8B's heads (32 query heads over `hkv` kv
    heads of 128): "bench", 128 sequences, one page of 512, 256..383 cached
    (0, 1, 255, 511 among them); "engine", 8 sequences, 6 pages of 128,
    phase 2's lengths. Returns the wrapper's arguments."""
    hq, d = 32, 128
    if shape == "bench":
        b, ps, mp = 128, 512, 1
        cached = torch.randint(256, 384, (b,), generator=gen, device="cuda", dtype=torch.int32)
        cached[:4] = torch.tensor([0, 1, 255, 511], dtype=torch.int32)
    else:
        lens = (40, 127, 128, 129, 255, 384, 511, 700)
        b, ps, mp = len(lens), 128, 6
        cached = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pages = b * mp + 1
    bt = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = (1.5 * torch.randn((b, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    kn, vn = (torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    shp = (pages, hkv, ps, d)
    if int8:
        k, v = (torch.randint(-127, 128, shp, generator=gen, dtype=torch.int8, device="cuda")
                for _ in range(2))
        ks, vs = (torch.rand((pages, hkv, 1, ps), generator=gen, device="cuda") * 0.02 + 0.005
                  for _ in range(2))
        return (q, kn, vn, k, v, ks, vs, cached, bt, d ** -0.5, ps)
    k, v = (torch.randn(shp, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    return (q, kn, vn, k, v, cached, bt, d ** -0.5, ps)


def _cases(torch, cs, want):
    """Yield (name, call, check, iters) for every case whose name starts with
    a prefix in `want` (all when it is empty), inputs made from one seed.
    check(out) is True when out meets its plain version's bar, or None when
    the case is only held to the same bits across roots."""
    from sgl_kernel_npu_tpu_torch.models import qwen_next
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    from sgl_kernel_npu_tpu_torch.ops import quant
    from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as rq
    from sgl_kernel_npu_tpu_torch.ops.attention import (decode, decode_mla_v2, decode_v3,
                                                        decode_v6, decode_v9, decode_v11)

    def on(name):
        return not want or name.startswith(want)

    def exact(ref):
        return lambda got: torch.equal(got, ref)

    def close(ref):
        return lambda got: (got.float() - ref.float()).abs().max().item() <= cs.ATTN_TOL

    def ulp(ref, share):
        """chip_smoke.py's bar for the bf16 decodes: one bf16 ulp of the
        plain value plus `share` of max|plain|"""
        def check(got):
            try:
                cs._bf16_check("", got, ref, share)
            except AssertionError:
                return False
            return True
        return check

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for label, mp in (("phase 1", 2), ("phase 4", 1)):
        if on(f"K3 {label}"):
            args = k3_inputs(torch, gen, mp)
            yield (f"K3 {label}",
                   lambda args=args: decode_v11.decode_gqa_v11_int8_defer(*args, layer_idx=1),
                   close(decode_v11.decode_gqa_v11_int8_defer_ref(*args, layer_idx=1)), 50)
            del args
    gen.manual_seed(15)
    for name, k, n in A_WIDTHS:
        names = [f"A {name} M {m}" for m in A_MS] + [f"A {name} M {m} f32" for m in (8, 128)]
        if not any(on(x) for x in names):
            continue
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        for m in A_MS:
            xq, xs = quant.per_token_quant_int8(
                torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16))
            ods = (torch.bfloat16, torch.float32) if name == "wqkv" and m in (8, 128) else (
                torch.bfloat16,)
            for od in ods:
                key = f"A {name} M {m}" + (" f32" if od == torch.float32 else "")
                if on(key):
                    yield (key, lambda xq=xq, w=w, xs=xs, ws=ws, od=od:
                           mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws, out_dtype=od),
                           exact(mm.quant_matmul_int8_ref(xq, w[1], xs, ws[1], out_dtype=od)),
                           20)
        del w
    gen.manual_seed(16)
    for name, k, n in (("lm_head", H, V), ("mla lm_head", MH, MV)):
        if not any(on(f"A L=1 {name} M {m}") for m in (8, 128)):
            continue
        w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((n,), generator=gen, device="cuda") * 1e-3
        for m in (8, 128):
            xq, xs = quant.per_token_quant_int8(
                torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16))
            if on(f"A L=1 {name} M {m}"):
                yield (f"A L=1 {name} M {m}",
                       lambda xq=xq, w=w, xs=xs, ws=ws: mm.quant_matmul_int8(xq, w, xs, ws),
                       exact(mm.quant_matmul_int8_ref(xq, w, xs, ws)), 20)
        del w
    gen.manual_seed(17)
    for name, k, n, bn in (("wo", Q, H, 512), ("w2", F, H, 512), ("lm_head", H, V, 768)):
        if not any(on(f"K1 {name} M {m}") for m in (128, 8)):
            continue
        w = torch.randint(-127, 128, (1, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((1, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, bn)
        del w
        for m in (128, 8):
            xq, xs = quant.per_token_quant_int8(torch.randn((m, k), generator=gen, device="cuda"))
            if on(f"K1 {name} M {m}"):
                yield (f"K1 {name} M {m}", lambda xq=xq, wt=wt, xs=xs, ws=ws:
                       mm.quant_matmul_int8_stacked_tiled(xq, wt, 0, xs, ws),
                       exact(mm.quant_matmul_int8_stacked_tiled_ref(xq, wt, 0, xs, ws)), 20)
        del wt
    gen.manual_seed(18)
    for name, k, n in (("wqkv", H, Q + 2 * KV), ("w13", H, 2 * F)):
        if not any(on(f"K2 per_token {name} M {m}") for m in (128, 8)):
            continue
        w = torch.randint(-127, 128, (1, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((1, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        del w
        gamma = (1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(torch.bfloat16)
        beta = torch.zeros((k,), device="cuda")
        for m in (128, 8):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            if on(f"K2 per_token {name} M {m}"):
                yield (f"K2 per_token {name} M {m}",
                       lambda x=x, gamma=gamma, beta=beta, wt=wt, ws=ws: rq.rmsnorm_quant_gemm(
                           x, gamma, beta, wt, ws, li=0, quant_mode="per_token", eps=1e-5,
                           out_dtype=torch.bfloat16), None, 20)
        del wt
    gen.manual_seed(19)
    if on("C phase 1"):
        cached = torch.tensor([40, 127, 128, 129, 255, 384, 511, 700], dtype=torch.int32,
                              device="cuda")
        kc, vc, ks, vs = cs._tm_cache(torch, gen, 2, 8 * 64 + 1, 128, KV // 128, 128)
        bt = (torch.randperm(8 * 64, generator=gen, device="cuda").reshape(8, 64)
              .to(torch.int32) + 1)
        q = torch.randn((8, Q // 128, 128), generator=gen, device="cuda").to(torch.bfloat16)
        kn = torch.randn((8, KV // 128, 128), generator=gen, device="cuda").to(torch.bfloat16)
        vn = torch.randn((8, KV // 128, 128), generator=gen, device="cuda").to(torch.bfloat16)
        cargs = (q, kn, vn, kc, vc, ks, vs, cached, bt, 128 ** -0.5, 128)
        yield ("C phase 1", lambda: decode_v9.decode_gqa_v9_int8_defer(*cargs, layer_idx=1),
               close(decode_v9.decode_gqa_v9_int8_defer_ref(*cargs, layer_idx=1)), 50)
    gen.manual_seed(20)
    if on("K8 Qwen expert w13"):
        qcfg = cs.qwen_bench_config(qwen_next)
        e, topk, tile = qcfg.num_experts, qcfg.top_k, qwen_next.MOE_TILE
        ids = torch.topk(torch.rand((128, e), generator=gen, device="cuda"), topk,
                         dim=-1).indices
        ok, src, eid = qwen_next.align_routes(ids, e, tile)
        kk, n = qcfg.hidden_size, 2 * qcfg.moe_intermediate_size
        bank = torch.randint(-127, 128, (e, n // 1024, kk, 1024), generator=gen,
                             dtype=torch.int8, device="cuda")
        ws = torch.rand((e, n), generator=gen, device="cuda") * 1e-3
        xq, xs = quant.per_token_quant_int8(torch.randn((128, kk), generator=gen, device="cuda"))
        tok = src // topk
        gargs = (torch.where(ok[:, None], xq[tok], 0).to(torch.int8),
                 bank, torch.where(ok[:, None], xs[tok], 0.0), ws, eid, tile)
        yield ("K8 Qwen expert w13", lambda: mm.grouped_matmul_int8(*gargs),
               exact(mm.grouped_matmul_int8_tiles_ref(*gargs)), 20)
        del bank, gargs
    gen.manual_seed(24)
    if on("K8 Qwen expert w2"):
        qcfg = cs.qwen_bench_config(qwen_next)
        e, topk, tile = qcfg.num_experts, qcfg.top_k, qwen_next.MOE_TILE
        ids = torch.topk(torch.rand((128, e), generator=gen, device="cuda"), topk,
                         dim=-1).indices
        ok, src, eid = qwen_next.align_routes(ids, e, tile)
        kk, n = qcfg.moe_intermediate_size, qcfg.hidden_size
        bank = torch.randint(-127, 128, (e, n // 1024, kk, 1024), generator=gen,
                             dtype=torch.int8, device="cuda")
        ws = torch.rand((e, n), generator=gen, device="cuda") * 1e-3
        xq, xs = quant.per_token_quant_int8(torch.randn((ok.shape[0], kk), generator=gen,
                                                        device="cuda"))
        gargs = (torch.where(ok[:, None], xq, 0).to(torch.int8), bank,
                 torch.where(ok[:, None], xs, 0.0), ws, eid, tile)
        yield ("K8 Qwen expert w2", lambda: mm.grouped_matmul_int8(*gargs),
               exact(mm.grouped_matmul_int8_tiles_ref(*gargs)), 20)
        del bank, gargs
    gen.manual_seed(21)
    for label, mp, int8, maxc in (("int8 phase 1", 3, True, 320), ("bf16 phase 1", 3, False, 320),
                                  ("int8 MP 6 cp 4", 6, True, 768)):
        if on(f"K5 {label}"):
            args, kw = k5_inputs(torch, gen, mp, int8, maxc)
            ref = decode_mla_v2._decode_chunks_ref(*args[:2], args[2], kw["kv_scales"],
                                                   *args[3:], kw["layer_idx"],
                                                   decode_mla_v2._chunk_pages(mp))
            yield (f"K5 {label}", lambda args=args, kw=kw: decode_mla_v2.decode_mla_v3_defer(
                *args, **kw), ulp(ref, cs.K5_SHARE), 50)
            del args, kw, ref
    gen.manual_seed(22)
    for label, shape, hkv in (("bench", "bench", 8), ("engine", "engine", 8), ("G 16", "bench", 2)):
        for int8 in (False, True):
            name = f"K14 {'int8' if int8 else 'bf16'} {label}"
            if not on(name):
                continue
            args = k14_inputs(torch, gen, shape, int8, hkv)
            fn = decode_v6.decode_gqa_v6_int8_defer if int8 else decode_v6.decode_gqa_v6_defer
            sc = dict(k_scales=args[5], v_scales=args[6]) if int8 else {}
            plain = args[:5] + args[-4:-1]
            ref = decode_v6.decode_gqa_v6_defer_ref(*plain, **sc)
            yield (name, lambda fn=fn, args=args: fn(*args), ulp(ref, cs.K14_SHARE), 50)
            del args, ref
    gen.manual_seed(23)
    if on("K10 qwen bench"):
        b, hq, hkv, d, ps, mp = 128, 16, 2, 128, 128, 3
        pages = b * mp + 1
        kc, vc = (torch.randn((hkv, pages, ps, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        seq = torch.randint(250, 290, (b,), generator=gen, device="cuda", dtype=torch.int32)
        bt = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        q = (1.5 * torch.randn((b, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
        hargs = (q, kc, vc, seq, bt, d ** -0.5, ps)
        yield ("K10 qwen bench", lambda: decode.decode_gqa_hm(*hargs),
               ulp(decode.decode_gqa_hm_ref(*hargs), cs.K10_SHARE), 50)
    yield from _gdn_cases(torch, cs, on)
    for int8 in (True, False):
        q, kn, vn, k, v, *sc, cached, bt, sm, ps = k14_inputs(torch, gen, "bench", int8)
        ks, vs = sc if int8 else (None, None)
        i8 = "_int8" if int8 else ""
        for defer in (True, False):
            name = f"K16 {'int8' if int8 else 'bf16'} {'defer ' if defer else ''}bench"
            if not on(name):
                continue
            lens = cached if defer else cached + 1
            new = (kn, vn) if defer else ()
            fn = getattr(decode_v3, f"decode_gqa_v3{i8}{'_defer' if defer else ''}")
            ref = decode_v3.decode_gqa_v3_ref(q, k, v, lens, bt, sm, k_scales=ks, v_scales=vs,
                                              k_new=kn if defer else None,
                                              v_new=vn if defer else None)
            yield (name, lambda fn=fn, a=(q, *new, k, v, *sc, lens, bt, sm, ps): fn(*a),
                   ulp(ref, cs.HM_SHARE), 50)
        del k, v, sc
    if on("K16 int8kv bench"):
        q, _, _, k, v, ks, vs, cached, bt, sm, ps = k14_inputs(torch, gen, "bench", True)
        hk, hv = (x.transpose(0, 1).contiguous() for x in (k, v))
        hks, hvs = (x.transpose(0, 1).contiguous() for x in (ks, vs))
        kv_args = (q, hk, hv, hks, hvs, cached + 1, bt, sm, ps)
        yield ("K16 int8kv bench", lambda: decode.decode_gqa_int8kv(*kv_args),
               ulp(decode.decode_gqa_int8kv_ref(*kv_args), cs.HM_SHARE), 50)
        del k, v, hk, hv
    yield from _attic_cases(torch, cs, on, ulp)
    yield from _norm_append_cases(torch, cs, on)
    yield from _append_swiglu_cases(torch, cs, on)
    data = None
    if on("K8 MoE GMM1") or on("K8 MoE GMM2"):
        from sgl_kernel_npu_tpu_torch import parallel
        data = cs.moe_bench_data(torch)
        x, idx, _, w13q, w13s, w2q, w2s = data
        el, t, topk = cs.MOE_EL, cs.MOE_T, cs.MOE_K
        res = parallel.get_low_latency_strategy("default").low_latency_dispatch(
            x, idx, group=parallel.EPGroup(None), num_experts=el,
            num_max_dispatch_tokens_per_rank=t, quant_mode="int8")
        _, _, a, a_s, eid = parallel.fused_moe._compact_rows(res, 1, el, t, t * min(topk, el),
                                                             True)
        tile = parallel.fused_moe.GEMM_TILE
        g1 = (a, w13q, a_s, w13s, eid, tile)
        ref1 = mm.grouped_matmul_int8_tiles_ref(*g1)
        if on("K8 MoE GMM1"):
            yield ("K8 MoE GMM1", lambda: mm.grouped_matmul_int8(*g1), exact(ref1), 20)
        aq, aqs = parallel.fused_moe._swiglu_requant(ref1)
        g2 = (aq, w2q, aqs, w2s, eid, tile)
        if on("K8 MoE GMM2"):
            yield ("K8 MoE GMM2", lambda: mm.grouped_matmul_int8(*g2),
                   exact(mm.grouped_matmul_int8_tiles_ref(*g2)), 20)
    if on("K11 fused_moe"):
        from sgl_kernel_npu_tpu_torch.parallel import EPGroup
        from sgl_kernel_npu_tpu_torch.parallel.strategies import (fused_moe_pallas,
                                                                  low_latency, pallas_ll)
        data = data or cs.moe_bench_data(torch)
        kargs = cs._k11_args(torch, low_latency, pallas_ll, data[0], data[1], data[3:],
                             cs.MOE_EL, cs.MOE_T)
        grp = EPGroup(None)
        yield ("K11 fused_moe",
               lambda: fused_moe_pallas.fused_moe_layer(*kargs, group=grp, maxt=cs.MOE_T)[0],
               exact(fused_moe_pallas.fused_moe_layer_ref(*kargs, group=grp,
                                                          maxt=cs.MOE_T)[0]), 10)
    yield from _scatter_estimate_cases(torch, cs, on, exact, data)


# K9's cases: (name, B, H, HV, D, pool rows, pool dtype name); the bench
# path's bf16 pool at D 128 (chip_smoke.py's check_gdn), the f32 pool at
# Qwen3-Next-80B-A3B's GDN shape and D 32 (check_gdn_widths)
GDN_CASES = (("K9 qwen bench", 128, 8, 8, 128, 9, "bfloat16"),
             ("K9 f32 pool published", 128, 16, 32, 128, 3, "float32"),
             ("K9 D 32 bf16", 128, 4, 8, 32, 3, "bfloat16"),
             ("K9 D 32 f32", 128, 4, 8, 32, 3, "float32"))


def _gdn_cases(torch, cs, on):
    """K9 at GDN_CASES, each where the root's wrapper takes its pool dtype
    and width (a root before them has no WIDTHS and takes bf16 at 128
    alone). Decay 1 and beta 0 leave every written state equal to the one
    read, so each call does the same work on the same pool; o within
    chip_smoke.py's GDN_SHARE of max|plain|."""
    from sgl_kernel_npu_tpu_torch.ops.gdn import recurrent_pallas as rec
    widths = getattr(rec, "WIDTHS", (128,))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    for name, b, h, hv, d, layers, dt in GDN_CASES:
        if not on(name) or d not in widths or (dt != "bfloat16" and not hasattr(rec, "WIDTHS")):
            continue
        pool, (q, k, v, _, _) = cs._gdn_inputs(torch, gen, b, h, hv, d, layers * b,
                                               getattr(torch, dt))
        zero = torch.zeros((b, hv), device="cuda")
        idx = ((layers - 1) * b + torch.arange(b, device="cuda")).to(torch.int32)
        a = (q, k, v, zero, zero, pool, idx, d ** -0.5, True)
        ref = rec.delta_rule_step_ref(q, k, v, zero, zero, pool.clone(), idx, d ** -0.5, True)

        def close(got, ref=ref):
            return float((got - ref).abs().max()) <= cs.GDN_SHARE * float(ref.abs().max())
        yield (name, lambda a=a: rec.delta_rule_step(*a), close, 50)
        del pool, a


def _events_ms(torch, fn, iters):
    """ms per call: CUDA events around `iters` eager calls, the median of
    REPS runs (for calls that a CUDA graph cannot capture)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[REPS // 2]


def _scatter_estimate_cases(torch, cs, on, exact, data):
    """K12's two halves at the MoE bench layout and K18 at chip_smoke.py's
    shapes (the T 32768 case only where the root's estimator has no cap),
    then the phase-8 and phase-11 calls that run them. A negative iteration
    count asks for event timing."""
    if on("K12"):
        from sgl_kernel_npu_tpu_torch.parallel import EPGroup
        from sgl_kernel_npu_tpu_torch.parallel.strategies import low_latency, pallas_ll
        data = data or cs.moe_bench_data(torch)
        el, maxt = cs.MOE_EL, cs.MOE_T
        x_send, counts, al, win = cs._moe_send_layout(torch, low_latency, pallas_ll, data[0],
                                                      data[1], el, maxt)
        y = torch.randn((el * maxt, cs.MOE_H), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(12))
        kw = dict(group=EPGroup(None), slices_per_rank=el)
        for name, args, more in (
                ("K12 dispatch", (x_send, None, counts, al, win, counts),
                 dict(out_rows=el * maxt, quantize=True)),
                ("K12 combine", (y.to(torch.bfloat16), None, counts, win, al, counts),
                 dict(out_rows=x_send.shape[0]))):
            if on(name):
                ref = pallas_ll.remote_scatter_ref(*args, **kw, **more)[0]
                yield (name, lambda a=args, m=more: pallas_ll._remote_scatter(*a, **kw, **m)[0],
                       exact(ref), 50)
    from sgl_kernel_npu_tpu_torch.ops.attention import prefill, sparse
    for i, (t, causal) in enumerate(cs.LASER_CASES):
        name = f"K17 T {t}{'' if causal else ' not causal'}"
        if not on(name):
            continue
        q, k, v = cs._laser_inputs(torch, t, 170 + i)
        sm = cs.ATT_D ** -0.5
        ref = prefill.laser_attention_blocked_ref(q, k, v, sm, causal)

        def laser_close(got, ref=ref):
            try:
                cs._bf16_check("", got, ref, cs.ATT_SHARE)
            except AssertionError:
                return False
            return True
        yield (name, lambda q=q, k=k, v=v, c=causal: prefill.laser_attention(q, k, v, sm, c),
               laser_close, 10)
        del q, k, v, ref
    # K17 at chip_smoke.py's phase-21 rows (WIDTH_LA index, its seed 2100 +
    # index): Phi-3's D 96 in bf16 and f32, Phi-2's D 80 in fp16
    for name, i in (("K17 D 96 bf16", 4), ("K17 D 96 f32", 5), ("K17 D 80 fp16", 7)):
        if not on(name):
            continue
        _, _, _, hq, hkv, d, dv, t, causal, dtype = cs.WIDTH_LA[i]
        gen = torch.Generator(device="cuda").manual_seed(2100 + i)
        q = cs._width_randn(torch, gen, (1, hq, t, d), dtype, "cuda")
        k = cs._width_randn(torch, gen, (1, hkv, t, d), dtype, "cuda")
        v = cs._width_randn(torch, gen, (1, hkv, t, dv), dtype, "cuda")
        sm = 1.0 / float(d) ** 0.5
        ref = prefill.laser_attention_blocked_ref(q, k, v, sm, causal)

        def width_close(got, ref=ref, dtype=dtype):
            try:
                cs._width_check("", got, ref, dtype)
            except AssertionError:
                return False
            return True
        yield (name, lambda q=q, k=k, v=v, c=causal: prefill.laser_attention(q, k, v, sm, c),
               width_close, 5)
        del q, k, v, ref
    cap = getattr(sparse, "_EST_MAX_BLOCKS", None)
    bs = cs.EST_BLOCK

    def scores_close(ref):
        live = ref > -1e29
        top = ref[live].abs().max()
        return lambda got: (torch.equal(got[~live], ref[~live])
                            and bool((got[live] - ref[live]).abs().max() <= 1e-5 * top))
    for i, (b, h, t, causal) in enumerate([(*sh, True) for sh in cs.EST_SHAPES]
                                          + [(*cs.EST_LONG, False)]):
        name = f"K18 [{b}, {h}, {t}]{'' if causal else ' not causal'}"
        if not on(name) or (cap is not None and 2 * t // bs > cap):
            continue
        gen = torch.Generator(device="cuda").manual_seed(180 + i)
        q, k = (torch.randn((b * h, t, cs.ATT_D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        yield (name, lambda q=q, k=k, c=causal: sparse.block_scores(q, k, bs, c),
               scores_close(sparse.block_scores_ref(q, k, bs, causal)), 20)
        del q, k
    if on("Phase 8"):
        from sgl_kernel_npu_tpu_torch import parallel
        data = data or cs.moe_bench_data(torch)
        calls = cs.moe_variants(torch, parallel, data)
        for name in ("pallas dispatch+combine", "pallas capacity_rows=1024"):
            if on(f"Phase 8 {name}"):
                yield (f"Phase 8 {name}", calls[name], None, 10)
    if on("Phase 11"):
        from sgl_kernel_npu_tpu_torch.ops.attention import paged_prefill
        t = cs.LASER_CASES[0][0]
        q, k, v = cs._laser_inputs(torch, t, 1170)
        gen = torch.Generator(device="cuda").manual_seed(1180)
        q8 = torch.randn((1, cs.ATT_HKV, t, cs.ATT_D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        bt = (torch.randperm(t // 128, generator=gen, device="cuda") + 1).to(torch.int32)
        kv = (cs._pages_of(torch, k, bt), cs._pages_of(torch, v, bt))
        qt = q[0].transpose(0, 1).contiguous()

        def pipeline():
            mask, _ = sparse.sparse_block_estimate_dispatch(q8, k, 128, keep_ratio=0.25)
            return paged_prefill.block_sparse_paged_attention(qt, kv, bt, mask[0], 0,
                                                              cs.ATT_D ** -0.5, 128)
        yield ("Phase 11 sparse prefill keep 0.25", pipeline, None, -3)


def _norm_append_cases(torch, cs, on):
    """K20 at chip_smoke.py's phase 1 inputs and K6 at check_append_mla's
    shape (chip_smoke.py's _append_mla_inputs, seed 20), int8 and bf16
    rows."""
    from sgl_kernel_npu_tpu_torch.ops import norm
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_mla_v2
    for n, dtype, tag in ((128, torch.bfloat16, "bf16"), (8192, torch.bfloat16, "bf16"),
                          (128, torch.float32, "f32")):
        name = f"K20 N {n} {tag}"
        if not on(name):
            continue
        x, r, w, b, qs, qo = cs._norm_inputs(torch, n, 200 + n, dtype)
        args = (x, r, w, b, 1e-6, qs, qo)
        want = norm.add_rmsnorm_bias_ref(*args)

        def check(got, want=want, name=name):
            try:
                cs._norm_check(torch, name, got, want)
            except AssertionError:
                return False
            return True
        yield (name, lambda a=args: norm.add_rmsnorm_bias(*a), check, 20)
        del x, r, want
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    for dtype, tag in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        if not on(f"K6 {tag} phase 1"):
            continue
        new, cache, pg, off = cs._append_mla_inputs(torch, gen, 27, 128, dtype)
        want = decode_mla_v2.append_mla_ref(new, cache.clone(), pg, off)
        yield (f"K6 {tag} phase 1",
               lambda a=(new, cache, pg, off): decode_mla_v2.append_mla(*a),
               lambda got, want=want: torch.equal(got, want), 50)
        del want


def _append_swiglu_cases(torch, cs, on):
    """D at chip_smoke.py's two shapes (the decode step's 8 rows and the
    prefill chunk's 8 x 512, seed 21) and K13 at its phase 1 shape (2,048 x
    4096, total 1,024; seed 13), bf16 and f32 x, with and without the limit
    of 3.0."""
    from sgl_kernel_npu_tpu_torch.models import llama
    from sgl_kernel_npu_tpu_torch.ops import activation
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8
    cfg = llama.LlamaConfig(int8_kv=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    for label in ("decode", "prefill"):
        if not on(f"D {label}"):
            continue
        if label == "decode":
            pages, (kq, vq, pg, off) = 512, cs.append_tm_decode_inputs(torch, gen, cfg)
        else:
            pages, (kq, vq, pg, off) = 64, cs.append_tm_prefill_inputs(torch, gen, cfg)
        shape = (cfg.num_layers, pages, cfg.page_size * cfg.num_kv_heads, cfg.head_dim)
        kc, vc = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                                device="cuda") for _ in range(2))
        want = decode_v8.append_tm_int8_ref(kq, vq, kc.clone(), vc.clone(), pg, off)
        yield (f"D {label}",
               lambda a=(kq, vq, kc, vc, pg, off): decode_v8.append_tm_int8(*a),
               lambda got, want=want: all(torch.equal(g, w) for g, w in zip(got, want)), 20)
        del kq, vq, kc, vc, want
    gen.manual_seed(13)
    x, gl = cs.k13_inputs(torch, gen, 2048, cs.MOE_F, torch.bfloat16, (600, 0, 424))
    if on("K13 bf16 kernel alone"):
        total = gl.sum().to(torch.int32).reshape(1)
        rq = activation.swiglu_quant_ref(x, gl, 1)[0]
        yield ("K13 bf16 kernel alone",
               lambda: activation._swiglu_quant_cuda(x, total, False, cs.K13_LIMIT),
               lambda got: torch.equal(got[0], rq), 20)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for do_limit in (False, True):
            name = f"K13 {tag}{' limit' if do_limit else ''}"
            if not on(name):
                continue
            xd, kw = x.to(dtype), dict(do_limit=do_limit, limit=cs.K13_LIMIT)
            rq, rsc = activation.swiglu_quant_ref(xd, gl, 1, **kw)

            def check(got, rq=rq, rsc=rsc):
                d = (got[0].int() - rq.int()).abs()
                ulp = torch.nextafter(rsc.abs(), torch.full_like(rsc, float("inf"))) - rsc.abs()
                return (int(d.max()) <= 1 and float((d > 0).double().mean()) <= cs.MOE_FLIP_SHARE
                        and bool(((got[1] - rsc).abs() <= ulp).all()))
            yield (name, lambda a=(xd, gl), kw=kw: activation.swiglu_quant(*a, 1, **kw), check, 20)


def _attic_cases(torch, cs, on, ulp):
    """K23's five contracts and K24 at chip_smoke.py's phase 13 state
    (_attic_state, seed 350), the stacked caches 6 layers deep at layer 5."""
    from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v4, decode_v5, decode_v7
    from sgl_kernel_npu_tpu_torch.models import llama
    st = cs._attic_state(torch, llama.LlamaConfig(int8_kv=True), 350)
    q, kn, vn, cached, bt, sm, ps = (st[k] for k in ("q", "kn", "vn", "cached", "bt", "sm", "ps"))
    gen, li, seq = st["gen"], 5, cached + 1
    slots = cs._slots_of(torch, bt, cached, ps)
    for int8 in (True, False):
        tag = "int8" if int8 else "bf16"
        if on(f"K23 v5 {tag}"):
            k, v, ks, vs = cs._hm_pages(torch, gen, st["pages"], st["hkv"], ps, st["d"], int8)
            fn = decode_v5.decode_gqa_v5_int8_defer if int8 else decode_v5.decode_gqa_v5_defer
            a = (q, kn, vn, k, v, *((ks, vs) if int8 else ()), cached, bt, sm, ps)
            yield (f"K23 v5 {tag}", lambda fn=fn, a=a: fn(*a),
                   ulp(decode_v5.decode_gqa_v5_defer_ref(q, kn, vn, k, v, cached, bt, sm,
                                                         k_scales=ks, v_scales=vs),
                       cs.HM_SHARE), 50)
            del k, v, ks, vs
        if not (on(f"K23 fused {tag}") or (int8 and on("K23 v4b int8"))):
            continue
        shape = (6, st["pages"], st["hkv"], ps, st["d"])
        if int8:
            caches = [torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                                    device="cuda") for _ in range(2)]
            caches += [torch.rand(shape[:3] + (1, ps), generator=gen, device="cuda") * 0.02
                       + 0.005 for _ in range(2)]
        else:
            caches = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2)]
        if int8 and on("K23 v4b int8"):
            yield ("K23 v4b int8",
                   lambda c=caches: decode_v4.decode_v4b_int8(q, *c, seq, bt, li, sm, ps)[0],
                   ulp(decode_v4.decode_v4b_int8_ref(q, *caches, seq, bt, li, sm)[0],
                       cs.HM_SHARE), 50)
        if on(f"K23 fused {tag}"):
            kfn = decode_v4.decode_fused_v4_int8 if int8 else decode_v4.decode_fused_v4
            pfn = decode_v4.decode_fused_v4_int8_ref if int8 else decode_v4.decode_fused_v4_ref
            ref = pfn(q, kn, vn, *[c.clone() for c in caches], seq, bt, slots, li, sm)[0]
            yield (f"K23 fused {tag}",
                   lambda kfn=kfn, c=caches: kfn(q, kn, vn, *c, seq, bt, slots, li, sm, ps)[0],
                   ulp(ref, cs.HM_SHARE), 50)
        del caches
    if on("K24 attic v7"):
        s7 = cs._v7_state(torch, st)
        a7 = (q, None, kn, vn, s7["k"], s7["v"], s7["ks"], s7["vs"], s7["kside"], s7["vside"],
              s7["rows"], cached, bt, sm, ps)
        yield ("K24 attic v7", lambda: decode_v7.decode_gqa_v7_int8(*a7),
               ulp(decode_v7.decode_gqa_v7_int8_ref(*a7), cs.K14_SHARE), 50)


def _import_root(root):
    """Put `root` first on the path, so that its package is the one imported."""
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def _chip_smoke():
    """This checkout's chip_smoke.py, for its bars and input helpers (each
    takes the modules it drives as arguments)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _build_root(root):
    _import_root(root)
    from sgl_kernel_npu_tpu_torch import _build
    _build.build(sorted({_build.KERNELS[k] for k in KERNELS if k in _build.KERNELS}))


def _turn(root, want):
    """One turn: every case checked and timed; prints one JSON line
    {"ms": {case: ms}, "digest": {case: sha256 of the output}}."""
    _import_root(root)
    import torch
    cs = _chip_smoke()
    cs._warm_up_card(torch)
    ms, digest = {}, {}
    for name, call, check, iters in _cases(torch, cs, want):
        out = call()
        again = call()
        torch.cuda.synchronize()
        if check is not None and not check(out):
            raise AssertionError(f"{name} fails its plain version's bar")
        outs, agains = (out, again) if isinstance(out, tuple) else ((out,), (again,))
        if not all(torch.equal(o, a) for o, a in zip(outs, agains)):
            raise AssertionError(f"{name}: a second call differs")
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digest[name] = h.hexdigest()
        ms[name] = _graph_ms(torch, call, iters) if iters > 0 else _events_ms(torch, call, -iters)
        del out, again
    print(json.dumps({"ms": ms, "digest": digest}))


def _run(what):
    res = subprocess.run([sys.executable, os.path.abspath(__file__), *what], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"compare_builds {' '.join(what)} failed:\n{res.stdout}{res.stderr}")
    return res.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", default="", help="comma-separated case-name prefixes")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args()
    want = tuple(p for p in args.only.split(",") if p)
    if args.build:
        _build_root(os.path.abspath(args.build))
        return 0
    if args.turn:
        _turn(os.path.abspath(args.turn), want)
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    if not roots:
        ap.print_usage(sys.stderr)
        return 2
    if len(roots) == 1:
        roots.append(HERE)
    import torch
    if not torch.cuda.is_available():
        print("compare_builds: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", r],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in roots]
    for r, p in zip(roots, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"compare_builds: building {r} failed:\n{log}")
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    order = list(range(len(roots)))
    runs = {i: [] for i in order}
    for i in (order + order[::-1]) * args.rounds:
        line = _run(["--turn", roots[i], "--only", args.only]).strip().splitlines()[-1]
        runs[i].append(json.loads(line))
        print(f"turn {chr(97 + i)} ({roots[i]}) done", flush=True)
    for i in order:
        for r in runs[i]:
            if r["digest"] != runs[i][0]["digest"]:
                raise AssertionError(f"root {roots[i]}: a case's bits changed between turns")
    first = runs[0][0]["digest"]
    differ = [k for i in order for k, v in runs[i][0]["digest"].items()
              if k in first and first[k] != v
              and not k.startswith(("K3", "C ", "K5", "K10", "K14", "K16", "K17 D", "K18", "K20",
                                    "K23", "K24", "Phase 11"))]
    if differ:
        raise AssertionError(f"these cases differ between roots: {sorted(set(differ))}")
    same = [k for k, v in first.items() if all(runs[i][0]["digest"].get(k) == v for i in order)]
    print(f"the same bits from every root: {', '.join(same) or 'none'}")

    def med(i, key):
        if key not in runs[i][0]["ms"]:
            return float("nan")                 # a case this root does not run
        return statistics.median(r["ms"][key] for r in runs[i])
    for i in order:
        print(f"{chr(97 + i)}: {roots[i]}")
    keys = list(dict.fromkeys(k for i in order for k in runs[i][0]["ms"]))
    rows = [(k, [med(i, k) for i in order]) for k in keys]
    rows += [(k, [sum(med(i, p) for p in parts) for i in order]) for k, parts in SUMS.items()
             if all(p in keys for p in parts)]
    head = "".join(f" {chr(97 + i) + ' ms':>9s}" for i in order)
    head += "".join(f" {chr(97 + i) + ' / a':>7s}" for i in order[1:])
    print(f"{'case':34s}{head}")
    for k, vals in rows:
        print(f"{k:34s}" + "".join(f" {v:9.4f}" for v in vals)
              + "".join(f" {v / vals[0]:7.3f}" for v in vals[1:]))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
