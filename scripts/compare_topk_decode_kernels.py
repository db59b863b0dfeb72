#!/usr/bin/env python3
"""Time the port's top-k block-sparse decode (K19) and token-major int8
decode (C) from two checkouts on one card, in turns (a, b, b, a, repeated),
at the shapes of chip_smoke.py's phase 1, with their SDPA yardsticks.

  python3 scripts/compare_topk_decode_kernels.py ROOT_A ROOT_B [ROUNDS]

Each turn is a fresh process that imports sgl_kernel_npu_tpu_torch from its
root (building the kernels there on first use), keeps the card busy for a
second so that its clocks ramp up, checks each kernel against its plain
version (phase 1's bars), and times every shape on the same seeded inputs by
replaying a CUDA graph of the calls (median of 5 replays). The shapes: K19
at bench_ops.py's (B 64, 16 heads, D = Dv = 128, 512 pages of 128) and at
DeepSeek-V2-Lite's latent rows (B 128, D 576, Dv 512, 4096 pages), 256
selected 8-token blocks a row (row 1 leaves its last 100 at -1, row 2 is all
-1); C at Llama-3-8B's heads (32 / 8, D 128), batch 8, cached 40..700 over
64 pages of 128, through decode_v9 and decode_v8's contract. The
yardsticks, timed the same way in every turn: SDPA over rows gathered
beforehand (K19) and over the dequantised cache with the current token
(C). Prints one JSON line per turn and, per shape, the median over each
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
TOPK_SHAPES = (("bench_ops", 64, 128, 128, 512), ("latent", 128, 576, 512, 4096))
TOPK_H, TOPK_PS, TOPK_KB = 16, 128, 256
HQ, HKV, D, PS = 32, 8, 128, 128
CACHED = (40, 127, 128, 129, 255, 384, 511, 700)


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


def _ulp_close(name, out, ref, share):
    """Every value within one bf16 ulp of the plain one plus share *
    max|plain| (chip_smoke.py's _bf16_check)."""
    a, b = out.double(), ref.double()
    err = (a - b).abs()
    ratio = float((err / (2.0 ** -7 * b.abs() + share * b.abs().max())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: max-abs {float(err.max()):.3g} ({ratio:.3g} x its bound)")


def _sdpa(torch, q, k, v, mask, scale, fused=False):
    """One SDPA call as chip_smoke.py times it: for K19 on its memory-
    efficient backend (`fused`), for C on PyTorch's own choice."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional.scaled_dot_product_attention
    if not fused:
        return f(q, k, v, attn_mask=mask, scale=scale)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        return f(q, k, v, attn_mask=mask, scale=scale)


def _topk(torch, sp, out):
    for i, (name, b, d, dv, pages) in enumerate(TOPK_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(190 + i)
        q = torch.randn((b, TOPK_H, d), generator=gen, device="cuda").to(torch.bfloat16)
        kc = torch.randn((pages, TOPK_PS, d), generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn((pages, TOPK_PS, dv), generator=gen, device="cuda").to(torch.bfloat16)
        nblocks = pages * TOPK_PS // 8
        ids = torch.rand((b, nblocks), generator=gen, device="cuda").argsort(dim=1)[:, :TOPK_KB]
        ids = ids.to(torch.int32)
        ids[1, TOPK_KB - 100:] = -1
        ids[2] = -1
        sm = d ** -0.5

        def kernel():
            return sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS)
        _ulp_close(f"topk_block_sparse {name}", kernel(),
                   sp.topk_block_sparse_attention_ref(q, kc, vc, ids, sm, TOPK_PS, 64), 1e-4)
        out[f"K19 {name}"] = _graph_ms(torch, kernel, 20)
        tok = torch.where(ids[..., None] >= 0, ids[..., None] * 8
                          + torch.arange(8, device="cuda"), -1).reshape(b, -1)
        flat = tok.clamp_min(0).long().reshape(-1)
        kg = kc.reshape(-1, d).index_select(0, flat).reshape(b, 1, -1, d)
        vg = vc.reshape(-1, dv).index_select(0, flat).reshape(b, 1, -1, dv)
        live = (tok >= 0)[:, None, None, :]
        qq = q[:, None]
        out[f"SDPA topk {name}"] = _graph_ms(
            torch, lambda: _sdpa(torch, qq, kg, vg, live, sm, fused=True), 20)
        del q, kc, vc, ids, kg, vg
        torch.cuda.empty_cache()


def _decode(torch, dv9, dv8, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    b, pages, mp, layers, li = 8, 512, 64, 2, 1
    shape = (layers, pages, PS * HKV, D)
    kc, vc = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device="cuda")
              for _ in range(2))
    ks, vs = (torch.rand((layers, pages, 1, PS * HKV), generator=gen, device="cuda") * 0.02
              for _ in range(2))
    cached = torch.tensor(CACHED, dtype=torch.int32, device="cuda")
    perm = (torch.randperm(pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    bt = torch.zeros((b, mp), dtype=torch.int32, device="cuda")
    at = 0
    for i, n in enumerate(CACHED):
        k = -(-(n + 1) // PS)
        bt[i, :k] = perm[at:at + k]
        at += k
    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    kn, vn = (torch.randn((b, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    sm = D ** -0.5
    args = (q, kn, vn, kc, vc, ks, vs, cached, bt, sm, PS)
    for name, fn, ref in (("C decode_v9", dv9.decode_gqa_v9_int8_defer,
                           dv9.decode_gqa_v9_int8_defer_ref),
                          ("C decode_v8 contract", dv8.decode_gqa_v8_int8_defer,
                           dv8.decode_gqa_v8_int8_defer_ref)):
        err = (fn(*args, layer_idx=li).float() - ref(*args, layer_idx=li).float()).abs().max()
        if not float(err) <= 2e-2:
            raise AssertionError(f"{name}: max-abs {float(err):.3g} > 2e-2")
        out[name] = _graph_ms(torch, lambda: fn(*args, layer_idx=li), 50)
    n = max(CACHED) + 1
    kd, ksd = dv9._gather_layer(kc, ks, li, bt, HKV)
    vd, vsd = dv9._gather_layer(vc, vs, li, bt, HKV)
    kf = (kd[:, :, :n].float() * ksd[:, :, :n, None]).to(torch.bfloat16)
    vf = (vd[:, :, :n].float() * vsd[:, :, :n, None]).to(torch.bfloat16)
    idx = cached.long()
    kf[torch.arange(b), :, idx] = kn
    vf[torch.arange(b), :, idx] = vn
    kf, vf = kf.repeat_interleave(HQ // HKV, 1), vf.repeat_interleave(HQ // HKV, 1)
    mask = (torch.arange(n, device="cuda")[None, :] <= cached[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    out["SDPA decode"] = _graph_ms(torch, lambda: _sdpa(torch, qs, kf, vf, mask, sm), 50)


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8, decode_v9, sparse

    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    out = {}
    _decode(torch, decode_v9, decode_v8, out)
    _topk(torch, sparse, out)
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
        print("compare_topk_decode_kernels: no CUDA card", file=sys.stderr)
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
