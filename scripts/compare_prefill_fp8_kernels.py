#!/usr/bin/env python3
"""Time the port's paged prefill over hm pages (K15) and soft-FP8 GEMM (K21)
from two checkouts on one card, in turns (a, b, b, a, repeated), at the
shapes of chip_smoke.py's phases 1 and 11, with their library yardsticks.

  python3 scripts/compare_prefill_fp8_kernels.py ROOT_A ROOT_B [ROUNDS]

Each turn is a fresh process that imports sgl_kernel_npu_tpu_torch from its
root (building the kernels there on first use), keeps the card busy for a
second so that its clocks ramp up, checks each kernel against its plain
version where that is quick, and times every shape on the same seeded
inputs by replaying a CUDA graph of the calls (median of 5 replays). The
shapes: K15 on a 512-token chunk over a 256-token prefix at Llama-3-8B's
heads (32 / 8, 128-token pages, bf16 and int8) and on T 8192 at prefix 0
with per-kv-head page lists of a quarter of the causal pages (seeded) and
of all of them; K21 dense at M 4096 on DeepSeek-V3's gate_proj (7168 x
18432) and at M 128 on gate_proj, down_proj and kv_a_proj_with_mqa, and
grouped over 8 experts x 128 rows (GMM1 7168 x 4096, GMM2 2048 x 7168).
The yardsticks, timed the same way in every turn: SDPA (the hm rows
gathered, the causal mask) and torch.matmul on the dequantised bf16
weights. Prints one JSON line per turn and, per shape, the median over each
checkout's turns and the ratio b / a, then the card's name and power limit.
ROUNDS (default 1) repeats a, b, b, a. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS = 5
HQ, HKV, D = 32, 8, 128
FP8_DENSE = (("gate_proj", 7168, 18432), ("down_proj", 18432, 7168),
             ("kv_a_proj_with_mqa", 7168, 576))
FP8_GROUPED = (("GMM1", 7168, 4096), ("GMM2", 2048, 7168))
EXPERTS = 8


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


def _close(name, out, ref, share, diff=None):
    """Every value within one bf16 ulp of the larger plus share * max|ref|
    (and calc_diff <= diff where given), as chip_smoke.py's bars."""
    a, b = out.double(), ref.double()
    err = (a - b).abs()
    ratio = float((err / (2.0 ** -7 * a.abs().maximum(b.abs()) + share * b.abs().max())).max())
    ok = ratio <= 1.0
    if diff is not None:
        cd = 1 - 2 * float((a * b).sum()) / max(float((a * a + b * b).sum()), 1e-30)
        ok = ok and cd <= diff
    if not ok:
        raise AssertionError(f"{name}: max-abs {float(err.max()):.3g} ({ratio:.3g} x its bound)")


def _prefill(torch, pp, out):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    sm = D ** -0.5
    t, prefix, mp, ps = 512, 256, 6, 128
    n = prefix + t
    bt = (torch.randperm(2 * mp, generator=gen, device="cuda")[:mp].to(torch.int32) + 1)
    q = (1.5 * torch.randn((t, HQ, D), generator=gen, device="cuda")).to(torch.bfloat16)
    plen = torch.tensor(prefix, dtype=torch.int32, device="cuda")
    g = HQ // HKV
    for int8 in (False, True):
        shape = (2 * mp + 1, HKV, ps, D)
        if int8:
            k, v = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                                  device="cuda") for _ in range(2))
            ks, vs = (torch.rand((2 * mp + 1, HKV, 1, ps), generator=gen, device="cuda") * 0.02
                      + 0.005 for _ in range(2))
            kv = {"k": k, "v": v, "ks": ks, "vs": vs}
        else:
            k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            ks = vs = None
            kv = (k, v)
        args = (q, kv, bt, plen, sm, ps)
        kind = "int8" if int8 else "bf16"
        _close(f"prefill_hm {kind}", pp.paged_prefill_attention(*args),
               pp.paged_prefill_attention_ref(*args), 1e-4)
        out[f"K15 {kind} T512/256"] = _graph_ms(
            torch, lambda: pp.paged_prefill_attention(*args), 20)

        def rows(c, sc):
            r = c[bt.long()].transpose(0, 1).reshape(HKV, mp * ps, D).float()
            if sc is not None:
                r = r * sc[bt.long()].transpose(0, 1).reshape(HKV, mp * ps, 1)
            return r[None, :, :n].to(torch.bfloat16).contiguous()
        kk, vv = rows(k, ks), rows(v, vs)
        qq = q.reshape(t, HKV, g, D).permute(1, 0, 2, 3).reshape(1, HKV, t * g, D).contiguous()
        tok = torch.arange(t * g, device="cuda") // g
        mask = (torch.arange(n, device="cuda")[None, :] <= prefix + tok[:, None])[None, None]

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask, scale=sm)
        out[f"SDPA {kind} T512/256"] = _graph_ms(torch, sdpa, 20)
    # T 8192 at prefix 0, per kv head page lists: a seeded quarter of each
    # tile's causal pages (the diagonal always) and all of them
    t = 8192
    npages = t // ps
    q = torch.randn((t, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt = (torch.randperm(npages, generator=gen, device="cuda") + 1).to(torch.int32)
    k, v = (torch.randn((npages + 1, HKV, ps, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    causal = torch.ones((npages, npages), dtype=torch.bool, device="cuda").tril()
    zero = torch.zeros((), dtype=torch.int32, device="cuda")     # no copy in a graph
    for keep in (0.25, 1.0):
        if keep < 1.0:
            r = torch.rand((HKV, npages, npages), generator=gen, device="cuda")
            diag = torch.eye(npages, dtype=torch.bool, device="cuda")
            mask = causal & ((r < keep) | diag)
        else:
            mask = causal.expand(HKV, npages, npages)
        sel, cnt = pp.block_mask_to_page_lists(mask, npages)
        out[f"K15 sparse T8192 keep {keep}"] = _graph_ms(torch, lambda: pp.paged_prefill_attention(
            q, (k, v), bt, zero, sm, ps, page_sel=sel, page_cnt=cnt, block_q=ps), 2)


def _fp8_bank(torch, mm, gen, shape):
    """Seeded bf16 weights quantised per 128 x 128 block to e4m3 (absmax /
    448 scales); returns (w e4m3, scales f32, the dequantised bf16 weights)."""
    *lead, k, n = shape
    w = 0.05 * torch.randn(shape, generator=gen, device="cuda")
    sk, sn = -(-k // 128), -(-n // 128)
    wp = torch.nn.functional.pad(w, (0, sn * 128 - n, 0, sk * 128 - k))
    blocks = wp.reshape(*lead, sk, 128, sn, 128)
    s = (blocks.abs().amax(dim=(-3, -1)) / 448.0).clamp_min(1e-12)
    q = (blocks / s[..., :, None, :, None]).to(torch.float8_e4m3fn)
    q = q.reshape(*lead, sk * 128, sn * 128)[..., :k, :n].contiguous()
    del w, wp, blocks
    if lead:
        w16 = torch.stack([mm._dequant_w_fp8_block(q[e], s[e]) for e in range(lead[0])])
    else:
        w16 = mm._dequant_w_fp8_block(q, s)
    return q, s.float().contiguous(), w16


def _fp8(torch, mm, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    for name, k, n in FP8_DENSE:
        w, s, w16 = _fp8_bank(torch, mm, gen, (k, n))
        for m in (128, 4096) if name == "gate_proj" else (128,):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            if m == 128:
                _close(f"mm_wfp8a16 {name}", mm.mm_wfp8a16(x, w, s), mm.mm_wfp8a16_ref(x, w, s),
                       1e-4, 1e-5)
            iters = 10 if m > 128 else 30
            out[f"K21 {name} M{m}"] = _graph_ms(torch, lambda: mm.mm_wfp8a16(x, w, s), iters)
            out[f"matmul {name} M{m}"] = _graph_ms(torch, lambda: torch.matmul(x, w16), iters)
        del w, s, w16
        torch.cuda.empty_cache()
    eid = torch.arange(EXPERTS, dtype=torch.int32, device="cuda")
    for name, k, n in FP8_GROUPED:
        w, s, w16 = _fp8_bank(torch, mm, gen, (EXPERTS, k, n))
        x = torch.randn((EXPERTS * 128, k), generator=gen, device="cuda").to(torch.bfloat16)
        args = (x, w, s, eid)
        _close(f"gmm_wfp8a16_aligned {name}", mm.gmm_wfp8a16_aligned(*args),
               mm.gmm_wfp8a16_aligned_ref(*args), 1e-4, 1e-5)
        out[f"K21 grouped {name}"] = _graph_ms(torch, lambda: mm.gmm_wfp8a16_aligned(*args), 20)

        def library():
            return torch.cat([torch.matmul(x[e * 128:(e + 1) * 128], w16[e])
                              for e in range(EXPERTS)])
        out[f"matmul grouped {name}"] = _graph_ms(torch, library, 20)
        del w, s, w16
        torch.cuda.empty_cache()


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from sgl_kernel_npu_tpu_torch.ops import matmul
    from sgl_kernel_npu_tpu_torch.ops.attention import paged_prefill

    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    out = {}
    _prefill(torch, paged_prefill, out)
    _fp8(torch, matmul, out)
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 1
    import torch
    if not torch.cuda.is_available():
        print("compare_prefill_fp8_kernels: no CUDA card", file=sys.stderr)
        return 2
    roots = {"a": os.path.abspath(sys.argv[1]), "b": os.path.abspath(sys.argv[2])}
    runs = {"a": [], "b": []}
    for side in ("a", "b", "b", "a") * rounds:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              roots[side]], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(f"{side} ({roots[side]}): {line}")
        runs[side].append(json.loads(line))
    print(f"{'shape':32s} {'a ms':>9s} {'b ms':>9s} {'b / a':>7s}")
    for key in runs["a"][0]:
        a = statistics.median(r[key] for r in runs["a"])
        b = statistics.median(r[key] for r in runs["b"])
        print(f"{key:32s} {a:9.4f} {b:9.4f} {b / a:7.3f}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
