#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sgl_kernel_npu_tpu_torch) on one NVIDIA H100.

  python3 chip_smoke.py

1. Builds the four CUDA kernels (one nvcc each, all at once) and the native
   scheduler (g++) from the checkout into build/torch_kernels/.
2. Holds every kernel against its plain PyTorch version on the card at the
   shapes of the Llama-3-8B serving path: the W8A8 GEMM and the KV append must
   agree exactly, the two attention kernels within 2e-2 max-abs. Times the
   kernel, the plain version and a PyTorch library yardstick with CUDA events,
   and computes each kernel's bound from its bytes and operations.
3. Serves 8 greedy requests through LlamaEngine at Llama-3-8B width (int8 KV,
   seed-0 random weights) with all launch counters set to 0 first, checks
   the tokens, the logits, the scheduler and that every kernel launched, and
   serves them again to check that the tokens repeat.
4. Runs a small configuration through prefill and decode on the card and on
   the CPU (plain versions) and compares logits and caches.

Prints the kernels' JSON line, the card's name and power limit, and last the
result line. Any failure raises, and the exit code is not 0. Imports nothing
of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ATTN_TOL = 2e-2                # bf16 output rounding + summation order


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _warm_up_card(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for a while so that its clocks have ramped up
    before the first kernel is timed."""
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()


def _bound_ms(nbytes: float, ops: float, rate: str):
    """Least time on an H100 (data-sheet rates at 700 W): the larger of the
    bytes over its memory rate and the operations over its `rate` peak."""
    from sgl_kernel_npu_tpu_torch.utils import H100
    t_bytes = nbytes / H100.hbm_bytes_per_s
    t_ops = ops / getattr(H100, rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class _Launches:
    """Counts per kernel between construction and .delta()."""

    def __init__(self, build):
        self._build = build
        self._start = dict(build.launches)

    def delta(self):
        return {k: v - self._start[k] for k, v in self._build.launches.items()}


# ----------------------------------------------------------- kernel checks


def check_gemm(torch, mm, quant, cfg, rng):
    """Kernel A at the five decode GEMMs (M = 8) and a prefill M."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = [("wqkv", h, cfg.q_size + 2 * cfg.kv_size, 2), ("wo", cfg.q_size, h, 2),
              ("w13", h, 2 * f, 2), ("w2", f, h, 2), ("lm_head", h, v, 1)]
    rows = []
    dev = "cuda"
    for m in (8, 256):
        for name, k, n, layers in shapes:
            li = layers - 1
            w = torch.randint(-127, 128, (layers, k, n), generator=rng,
                              dtype=torch.int8, device=dev)
            ws = torch.rand((layers, n), generator=rng, device=dev) * 1e-3
            x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
            xq, xs = quant.per_token_quant_int8(x)
            out = mm.quant_matmul_int8_stacked(xq, w, li, xs, ws)
            ref = mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li])
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                bad = (out != ref).sum().item()
                raise AssertionError(f"w8a8_gemm {name} M={m}: {bad} elements differ")
            ms = _time_ms(lambda: mm.quant_matmul_int8_stacked(xq, w, li, xs, ws), 20)
            plain = _time_ms(lambda: mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li]), 3, 1)
            lib = None
            try:
                xp = xq if m > 16 else torch.cat([xq, xq.new_zeros((32 - m, k))])
                wl = w[li]
                sc = xs if m > 16 else torch.cat([xs, xs.new_ones((32 - m, 1))])

                def library():
                    acc = torch._int_mm(xp, wl)
                    return (acc.float() * sc * ws[li][None]).to(torch.bfloat16)
                got = library()[:m]
                if not torch.equal(got, ref):
                    raise AssertionError("torch._int_mm + epilogue disagrees")
                lib = _time_ms(library, 20)
            except (RuntimeError, AssertionError) as e:
                print(f"  library yardstick for {name} M={m} unavailable: {e}")
            nbytes = m * k + k * n + 4 * m + 4 * n + 2 * m * n
            bound, by = _bound_ms(nbytes, 2.0 * m * n * k, "int8_ops")
            rows.append(dict(name=name, m=m, k=k, n=n, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bound, bound_by=by,
                             max_abs_err=0.0))
            print(f"  w8a8_gemm {name:8s} M={m:4d} K={k:5d} N={n:6d}: exact; "
                  f"kernel {ms:.4f} ms, plain {plain:.3f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms ({by})")
            del w, ws
    # exactness at the other row counts the engine gives the kernel
    k, n = h, cfg.q_size + 2 * cfg.kv_size
    w = torch.randint(-127, 128, (2, k, n), generator=rng, dtype=torch.int8, device=dev)
    ws = torch.rand((2, n), generator=rng, device=dev) * 1e-3
    for m in (1, 17, 40, 64, 100, 2048):
        x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
        xq, xs = quant.per_token_quant_int8(x)
        if not torch.equal(mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws),
                           mm.quant_matmul_int8_ref(xq, w[1], xs, ws[1])):
            raise AssertionError(f"w8a8_gemm wqkv M={m} differs")
    print("  w8a8_gemm wqkv exact also at M = 1, 17, 40, 64, 100, 2048")
    return rows


def _tm_cache(torch, rng, layers, pages, ps, hkv, d):
    shape = (layers, pages, ps * hkv, d)
    kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    ks = torch.rand((layers, pages, 1, ps * hkv), generator=rng, device="cuda") * 0.02
    vs = torch.rand((layers, pages, 1, ps * hkv), generator=rng, device="cuda") * 0.02
    return kc, vc, ks, vs


def _block_tables(torch, rng, lens, mp, pages, ps):
    """Engine-style tables [len(lens), mp]: distinct pages for the tokens of
    each row (lens), pad entries 0."""
    need = [-(-int(n) // ps) for n in lens]
    perm = torch.randperm(pages - 1, generator=rng, device="cuda") + 1
    bt = torch.zeros((len(lens), mp), dtype=torch.int32, device="cuda")
    at = 0
    for i, k in enumerate(need):
        bt[i, :k] = perm[at:at + k]
        at += k
    return bt


def check_decode(torch, dv9, cfg, rng):
    """Kernel C: 8 sequences, cached lengths 40..700 (page edges included)."""
    b, hq, hkv, d, ps = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    pages, mp, layers, li = 512, 64, 2, 1
    kc, vc, ks, vs = _tm_cache(torch, rng, layers, pages, ps, hkv, d)
    cached = torch.tensor([40, 127, 128, 129, 255, 384, 511, 700], dtype=torch.int32,
                          device="cuda")
    bt = _block_tables(torch, rng, (cached + 1).tolist(), mp, pages, ps)
    q = torch.randn((b, hq, d), generator=rng, device="cuda").to(torch.bfloat16)
    kn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    vn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    sm = d ** -0.5
    args = (q, kn, vn, kc, vc, ks, vs, cached, bt, sm, ps)
    out = dv9.decode_gqa_v9_int8_defer(*args, layer_idx=li)
    ref = dv9.decode_gqa_v9_int8_defer_ref(*args, layer_idx=li)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"decode_tm max-abs {err} > {ATTN_TOL}")
    ms = _time_ms(lambda: dv9.decode_gqa_v9_int8_defer(*args, layer_idx=li), 50)
    plain = _time_ms(lambda: dv9.decode_gqa_v9_int8_defer_ref(*args, layer_idx=li), 5)

    # yardstick: SDPA over the dequantized, gathered cache plus the current token
    n = int(cached.max()) + 1
    kd, ksd = dv9._gather_layer(kc, ks, li, bt, hkv)
    vd, vsd = dv9._gather_layer(vc, vs, li, bt, hkv)
    kf = (kd[:, :, :n].float() * ksd[:, :, :n, None]).to(torch.bfloat16)
    vf = (vd[:, :, :n].float() * vsd[:, :, :n, None]).to(torch.bfloat16)
    idx = cached.long()
    kf[torch.arange(b), :, idx] = kn
    vf[torch.arange(b), :, idx] = vn
    g = hq // hkv
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    mask = torch.arange(n, device="cuda")[None, :] <= cached[:, None]
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qs, kf, vf, attn_mask=mask, scale=sm)[:, :, 0]
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    lib = _time_ms(lambda: sdpa(qs, kf, vf, attn_mask=mask, scale=sm), 50)

    c = cached.double().sum().item()
    nbytes = (c * hkv * (2 * d + 8) + 2 * (2 * b * hq * d) + 2 * (2 * b * hkv * d)
              + 4 * b + 4 * b * mp)
    ops = 4.0 * (c + b) * hq * d
    bound, by = _bound_ms(nbytes, ops, "bf16_flops")
    print(f"  decode_tm B=8 cached={cached.tolist()}: max-abs {err:.3g}; kernel "
          f"{ms:.4f} ms, plain {plain:.3f} ms, SDPA {lib:.4f} ms (max-abs vs plain "
          f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_prefill(torch, pp, cfg, rng):
    """Kernel B: 2 chunks of a 256-token bucket, prefixes 0 and 256."""
    hq, hkv, d, ps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    s, t, pages, mp, layers, li = 2, 256, 512, 64, 2, 1
    kc, vc, ks, vs = _tm_cache(torch, rng, layers, pages, ps, hkv, d)
    plen = torch.tensor([0, 256], dtype=torch.int32, device="cuda")
    vlen = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
    bt = _block_tables(torch, rng, (plen + vlen).tolist(), mp, pages, ps)
    q = torch.randn((s, t, hq, d), generator=rng, device="cuda").to(torch.bfloat16)
    ck = torch.randn((s, t, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    cv = torch.randn((s, t, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    sm = d ** -0.5
    args = (q, ck, cv, kc, vc, ks, vs, bt, plen, vlen, sm, ps)
    out = pp.paged_prefill_attention_tm(*args, layer_idx=li)
    ref = pp.paged_prefill_attention_tm_ref(*args, layer_idx=li)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"prefill_tm max-abs {err} > {ATTN_TOL}")
    ms = _time_ms(lambda: pp.paged_prefill_attention_tm(*args, layer_idx=li), 20)
    plain = _time_ms(lambda: pp.paged_prefill_attention_tm_ref(*args, layer_idx=li), 3)

    # yardstick: SDPA over the dequantized prefix + chunk with the same mask
    from sgl_kernel_npu_tpu_torch.ops.attention.decode_v9 import _gather_layer
    npre = int(plen.max())
    kd, ksd = _gather_layer(kc, ks, li, bt, hkv)
    vd, vsd = _gather_layer(vc, vs, li, bt, hkv)
    kf = torch.cat([(kd[:, :, :npre].float() * ksd[:, :, :npre, None]).to(torch.bfloat16),
                    ck.permute(0, 2, 1, 3)], dim=2)
    vf = torch.cat([(vd[:, :, :npre].float() * vsd[:, :, :npre, None]).to(torch.bfloat16),
                    cv.permute(0, 2, 1, 3)], dim=2)
    g = hq // hkv
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    col = torch.arange(npre + t, device="cuda")
    row = torch.arange(t, device="cuda")
    pre = col[None, None, :] < plen[:, None, None]
    chunk = ((col[None, None, :] - npre <= row[None, :, None])
             & (col[None, None, :] - npre < vlen[:, None, None])
             & (col[None, None, :] >= npre))
    mask = (pre | chunk)[:, None]
    qs = q.permute(0, 2, 1, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = _time_ms(lambda: sdpa(qs, kf, vf, attn_mask=mask, scale=sm), 20)

    pairs = sum(int(vlen[i]) * int(plen[i]) + int(vlen[i]) * (int(vlen[i]) + 1) // 2
                for i in range(s))
    pre_tok = int(plen.sum())
    nbytes = (2 * s * t * hq * d * 2 + 2 * s * t * hkv * d * 2
              + pre_tok * hkv * (2 * d + 8) + 4 * s * (mp + 2))
    bound, by = _bound_ms(nbytes, 4.0 * pairs * hq * d, "bf16_flops")
    print(f"  prefill_tm S=2 T=256 prefix=[0,256] valid=[256,200]: max-abs {err:.3g}; "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_append(torch, dv8, cfg, rng):
    """Kernel D at the decode step's shape (all 32 layers, 8 rows, one padded)."""
    layers, b, hkv, d, ps, pages = cfg.num_layers, 8, cfg.num_kv_heads, cfg.head_dim, \
        cfg.page_size, 512
    kq = torch.randint(-127, 128, (layers, b, hkv, d), generator=rng, dtype=torch.int8,
                       device="cuda")
    vq = torch.randint(-127, 128, (layers, b, hkv, d), generator=rng, dtype=torch.int8,
                       device="cuda")
    pg = torch.randperm(pages, generator=rng, device="cuda")[:b].to(torch.int32)
    pg[-1] = pages                                    # a padded row: sentinel P
    off = torch.randint(0, ps, (b,), generator=rng, device="cuda", dtype=torch.int32)
    shape = (layers, pages, ps * hkv, d)
    kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    kc2, vc2 = kc.clone(), vc.clone()
    dv8.append_tm_int8(kq, vq, kc, vc, pg, off)
    dv8.append_tm_int8_ref(kq, vq, kc2, vc2, pg, off)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError("append_tm differs from its plain version")
    ms = _time_ms(lambda: dv8.append_tm_int8(kq, vq, kc, vc, pg, off), 50)
    plain = _time_ms(lambda: dv8.append_tm_int8_ref(kq, vq, kc2, vc2, pg, off), 10)
    live = pg < pages
    slots = (pg[live].long() * ps + off[live].long())
    kv3, vv3 = kc2.view(layers, pages * ps, hkv * d), vc2.view(layers, pages * ps, hkv * d)
    ksrc = kq[:, live].reshape(layers, -1, hkv * d)
    vsrc = vq[:, live].reshape(layers, -1, hkv * d)

    def library():
        kv3.index_copy_(1, slots, ksrc)
        vv3.index_copy_(1, slots, vsrc)
    library()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError("index_copy_ yardstick disagrees")
    lib = _time_ms(library, 50)
    nrow = int(live.sum())
    nbytes = 2 * 2 * layers * nrow * hkv * d + 8 * b
    bound, by = _bound_ms(nbytes, 0.0, "bf16_flops")
    print(f"  append_tm L={layers} B={b} (1 padded): exact; kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, index_copy_ x2 {lib:.4f} ms, bound {bound:.5f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=0.0)


# ------------------------------------------------------------- the engine


def _prompts(rng, vocab):
    """Six prompts of 40..511 tokens and two that share a 256-token prefix
    (300 and 700 tokens); the second is returned apart, to be added late."""
    prefix = rng.integers(0, vocab, 256).tolist()
    lens = [40, 127, 129, 255, 384, 511]
    first = [rng.integers(0, vocab, n).tolist() for n in lens]
    shared_a = prefix + rng.integers(0, vocab, 44).tolist()        # 300 tokens
    shared_b = prefix + rng.integers(0, vocab, 444).tolist()       # 700 tokens
    return first + [shared_a], shared_b


def run_engine(torch, serving, build, cfg, params, prompts, late, new_tokens,
               profile=False):
    """Serve `prompts`, then `late` once the first shared-prefix prompt has
    been prefilled (so it reuses the radix-cached prefix). Returns outputs,
    timings, launch counts per step kind and the counts of the whole run;
    with `profile`, afterwards profiles one steady-state decode call."""
    eng = serving.LlamaEngine(cfg, params=params, device="cuda", num_pages=512,
                              decode_batch=8, token_budget=256)
    from sgl_kernel_npu_tpu_torch.runtime import NativeScheduler
    if not isinstance(eng.sched, NativeScheduler):
        raise AssertionError("the engine must run on the native scheduler")
    stats = {"prefill_s": 0.0, "prefill_tok": 0, "prefill_steps": 0,
             "decode_s": 0.0, "decode_tok": 0, "decode_steps": 0,
             "per_prefill": None, "per_decode": None}
    inner_pre, inner_dec = eng._prefill_batch, eng._decode

    def prefill(*a):
        torch.cuda.synchronize()
        t0, c = time.perf_counter(), _Launches(build)
        logits, kv = inner_pre(*a)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t0
        stats["prefill_tok"] += int(a[1].sum())
        stats["prefill_steps"] += 1
        stats["per_prefill"] = stats["per_prefill"] or c.delta()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        return logits, kv

    def decode(*a):
        torch.cuda.synchronize()
        t0, c = time.perf_counter(), _Launches(build)
        logits, kv = inner_dec(*a)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t0
        stats["decode_tok"] += int((a[4] >= 0).sum())
        stats["decode_steps"] += 1
        stats["per_decode"] = stats["per_decode"] or c.delta()
        if stats["decode_steps"] == 8:          # a full batch, kept to profile
            stats["steady_args"] = [x.clone() for x in a]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
        return logits, kv

    eng._prefill_batch, eng._decode = prefill, decode
    rids = [eng.add_request(p, new_tokens) for p in prompts]
    late_rid = None
    t0 = time.perf_counter()
    for _ in range(1000):
        if late_rid is None and eng.reqs[rids[-1]]["out"]:
            late_rid = eng.add_request(late, new_tokens)
        if not eng.step() and late_rid is not None:
            break
    wall = time.perf_counter() - t0
    launches = dict(build.launches)      # read before anything else launches
    outs = [eng.reqs[r]["out"] for r in rids + [late_rid]]
    reused = eng.reqs[late_rid]["cached"]
    if profile:
        profile_decode(torch, inner_dec, stats["steady_args"])
    del eng
    return outs, stats, wall, reused, launches


def profile_decode(torch, decode, args, reps=3):
    """Device time of a steady-state decode call (all 8 rows live) by
    torch.profiler, and the kernels that take it. The engine has finished,
    so re-running the call only rewrites slots nobody reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    decode(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            decode(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    if not by_name:
        print("  decode profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(by_name.values()) / reps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  decode profile (B=8, steady state): device busy {busy:.3f} ms per call, "
          f"wall {1e3 * wall:.3f} ms per call under the profiler; top kernels (ms per "
          "call): " + "; ".join(f"{n[:48]} {t / reps / 1e3:.3f}" for n, t in top))


def check_small_config(torch, llama):
    """Prefill + 2 decode steps of a small config (D = 128, G = 4, so every
    kernel runs) on the card and on the CPU (plain versions), from the same
    CPU-made weights and inputs: logits within the repo's calc_diff bound
    (8e-3, tests/test_llama_model.py), layer-0 caches exact but for
    rounding-boundary flips of 1."""
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512, num_layers=2,
                            num_heads=8, num_kv_heads=2, head_dim=128,
                            intermediate_size=1024, page_size=16,
                            max_position=512, int8_kv=True)
    rng = np.random.default_rng(7)
    lens, s, t, mp, pages, b = [37, 20], 2, 64, 6, 16, 4
    ps = cfg.page_size
    bts = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 10, 0]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    pos = np.zeros((s, t), np.int32)
    for si, n in enumerate(lens):
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[si, :n] = np.arange(n)
        p = np.arange(n)
        slp[si, :n] = bts[si, p // ps] * ps + p % ps
    steps = []
    for step in range(2):
        cur = [n + step for n in lens]
        ids_d = np.zeros(b, np.int32)
        ids_d[:2] = rng.integers(0, cfg.vocab_size, 2)
        bt = np.zeros((b, mp), np.int32)
        bt[:2] = bts
        sl = np.full(b, -1, np.int32)
        sl[:2] = [bts[i, c // ps] * ps + c % ps for i, c in enumerate(cur)]
        steps.append((ids_d, np.array(cur + [0, 0], np.int32),
                      np.array([c + 1 for c in cur] + [1, 1], np.int32), bt, sl))
    cpu_params = llama.init_params(cfg, 3, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        params = _to_device(cpu_params, dev)
        kv = llama.init_kv_cache(cfg, pages, device=dev)

        def tt(a):
            return torch.from_numpy(np.array(a)).to(dev)
        lg, kv = llama.prefill_batch_step_kv(
            params, cfg, kv, tt(ids), tt(np.array(lens, np.int32)), tt(pos), tt(slp),
            tt(bts), torch.zeros(s, dtype=torch.int32, device=dev))
        logits = [lg[si, :n].float().cpu() for si, n in enumerate(lens)]
        for args in steps:
            lg, kv = llama.decode_step_kv(params, cfg, kv, *(tt(a) for a in args))
            logits.append(lg[:2].float().cpu())
        results[dev] = (logits, {k: v.cpu() for k, v in kv.items()})
    diffs = []
    for a, ref in zip(results["cuda"][0], results["cpu"][0]):
        if not bool(torch.isfinite(a).all()) or a.shape != ref.shape:
            raise AssertionError("small-config logits are not finite or misshapen")
        x, y = a.double().ravel(), ref.double().ravel()
        diffs.append(1 - 2 * float((x * y).sum()) / float((x * x).sum() + (y * y).sum()))
    if max(diffs) >= 8e-3:
        raise AssertionError(f"small-config logits calc_diff {diffs}")
    match = {}
    for k in ("k", "v"):
        a = results["cuda"][1][k].int()
        ref = results["cpu"][1][k].int()
        match[k] = [float((a[li] == ref[li]).float().mean()) for li in range(2)]
        if match[k][0] < 0.999 or int((a[0] - ref[0]).abs().max()) > 1:
            raise AssertionError(f"small-config layer-0 {k} cache: {match[k][0]:.5f} "
                                 f"exact, max |diff| {int((a[0] - ref[0]).abs().max())}")
    print(f"  small config (L=2, D=128, G=4, ps=16): logits calc_diff max "
          f"{max(diffs):.3g}; cache exact fraction per layer k {match['k']} "
          f"v {match['v']}")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to drive",
              file=sys.stderr)
        return 2
    try:
        from sgl_kernel_npu_tpu_torch import _build, serving
        from sgl_kernel_npu_tpu_torch import runtime
        from sgl_kernel_npu_tpu_torch.models import llama
        from sgl_kernel_npu_tpu_torch.ops import matmul, quant
        from sgl_kernel_npu_tpu_torch.ops.attention import (decode_v8, decode_v9,
                                                            paged_prefill_tm)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    gpu = _gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    times = _build.build()
    print(f"nvcc (4 in parallel) {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    t0 = time.perf_counter()
    runtime.build_native()
    print(f"g++ runtime {time.perf_counter() - t0:.1f} s")

    cfg = llama.LlamaConfig(int8_kv=True)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)

    print("phase 1: kernels vs plain versions at Llama-3-8B shapes")
    _warm_up_card(torch)
    gemm_rows = check_gemm(torch, matmul, quant, cfg, rng)
    torch.cuda.empty_cache()
    dec = check_decode(torch, decode_v9, cfg, rng)
    torch.cuda.empty_cache()
    pre = check_prefill(torch, paged_prefill_tm, cfg, rng)
    torch.cuda.empty_cache()
    app = check_append(torch, decode_v8, cfg, rng)
    torch.cuda.empty_cache()

    print("phase 2: LlamaEngine at Llama-3-8B width, int8 KV, seed-0 weights")
    t0 = time.perf_counter()
    params = llama.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    print(f"  init_params {time.perf_counter() - t0:.1f} s")
    prompts, late = _prompts(np.random.default_rng(0), cfg.vocab_size)
    new_tokens = 16
    _build.reset_launches()
    outs, st, wall, reused, launches = run_engine(
        torch, serving, _build, cfg, params, prompts, late, new_tokens, profile=True)
    if any(len(o) != new_tokens for o in outs):
        raise AssertionError(f"token counts {[len(o) for o in outs]}")
    if reused != 256:
        raise AssertionError(f"the shared 256-token prefix was not reused ({reused})")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    outs2 = run_engine(torch, serving, _build, cfg, params, prompts, late,
                       new_tokens)[0]
    if outs2 != outs:
        raise AssertionError("a second run from the same seed gave other tokens")
    print(f"  {len(outs)} requests (lengths {[len(p) for p in prompts + [late]]}), "
          f"{new_tokens} tokens each, radix reuse {reused} tokens, repeat run identical")
    print(f"  {st['prefill_steps']} prefill calls, {st['prefill_tok']} tokens, "
          f"{st['prefill_s']:.3f} s -> {st['prefill_tok'] / st['prefill_s']:.1f} prefill tok/s; "
          f"{st['decode_steps']} decode calls, {st['decode_tok']} tokens, "
          f"{st['decode_s']:.3f} s -> {st['decode_tok'] / st['decode_s']:.1f} decode tok/s, "
          f"{1e3 * st['decode_s'] / st['decode_steps']:.2f} ms/decode step; "
          f"wall {wall:.2f} s [{gpu}]")
    print(f"  launches in the run: {launches}; per prefill call {st['per_prefill']}; "
          f"per decode call {st['per_decode']}")
    del params
    torch.cuda.empty_cache()

    print("phase 3: small config, card vs CPU plain versions")
    check_small_config(torch, llama)

    g8 = [r for r in gemm_rows if r["m"] == 8]

    def total(key):
        vals = [r[key] for r in g8]
        return None if any(v is None for v in vals) else sum(vals)
    gemm = dict(ms=total("ms"), plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                bound_ms=total("bound_ms"),
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in g8)
                else "operations", max_abs_err=0.0)
    base = "sgl_kernel_npu_tpu"
    kernels = [
        dict(name="w8a8_gemm", route="cuda", source="sgl_kernel_npu_tpu_torch/csrc/w8a8_gemm.cu",
             replaces=f"{base}/ops/matmul.py:496", launches=launches["w8a8_gemm"], **gemm),
        dict(name="prefill_tm", route="cuda", source="sgl_kernel_npu_tpu_torch/csrc/prefill_tm.cu",
             replaces=f"{base}/ops/attention/paged_prefill_tm.py:133",
             launches=launches["prefill_tm"], **pre),
        dict(name="decode_tm", route="cuda", source="sgl_kernel_npu_tpu_torch/csrc/decode_tm.cu",
             replaces=f"{base}/ops/attention/decode_v9.py:163",
             launches=launches["decode_tm"], **dec),
        dict(name="append_tm", route="cuda", source="sgl_kernel_npu_tpu_torch/csrc/append_tm.cu",
             replaces=f"{base}/ops/attention/decode_v8.py:148",
             launches=launches["append_tm"], **app),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print("w8a8_gemm row: sum of the five M=8 decode GEMMs (wqkv, wo, w13, w2, lm_head)")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
