#!/usr/bin/env python3
"""Time the port's W8A8 GEMM kernels and the bf16 add from two checkouts on
one card, in turns (a, b, b, a, repeated), at the shapes of their main
paths, each held to its plain version first.

  python3 scripts/compare_gemm_kernels.py ROOT_A ROOT_B [ROUNDS]

The shapes (Llama-3-8B's GEMMs unless named otherwise):
  * K1 (pretiled banks: wo and w2 at 512, lm_head at 768) at the bench
    paths' M 128 and the hm engine's decode M 8, and wqkv, wo, w13, w2 at
    a prefill chunk of M 672; torch._int_mm + epilogue at M 128 beside it;
  * K2 per_token at wqkv and w13 (M 128, banks at 512), per_tensor with
    the int32 bias and the fp16 cast at DeepSeek-V2-Lite's wdqkv and wuq
    (an f32 column slice) at M 128 (banks at 1024);
  * controls: A at the Llama engine's M 8 GEMMs, K8 at the Qwen bench
    path's expert w13 and K11 at the MoE layer's bench shape (all three on
    K1's int8 stage, csrc/w8a8_wgmma.cuh);
  * K22 (helloworld) at [4096, 7168] with torch.add beside it.

Each turn is a fresh process that imports sgl_kernel_npu_tpu_torch from its
root (building the kernels there first, one nvcc per source in parallel),
keeps the card busy for a second so that its clocks ramp up, holds each
kernel to its plain version (K1, A, K8, K22 exact; K2 within 4 quant flips
with >= 99% of rows exact; K11's recv exact) and times every shape on the
same seeded inputs by replaying a CUDA graph of the calls (median of 5
replays). Prints one JSON line per turn and, per shape, the median over
each checkout's turns and the ratio b / a, then the card's name and power
limit. ROUNDS (default 1) repeats a, b, b, a. Needs one CUDA card; a turn
takes about a minute: give the runner 10-15 minutes for a round.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_rmsq_mla_kernels as cmp  # noqa: E402

H, Q, KV, F, V = 4096, 4096, 1024, 14336, 128256           # Llama-3-8B
# K1: (name, K, N, layers, bn)
K1_BANKS = {"wqkv": (H, Q + 2 * KV, 2, 512), "wo": (Q, H, 2, 512), "w13": (H, 2 * F, 2, 512),
            "w2": (F, H, 2, 512), "lm_head": (H, V, 1, 768)}
K1_SHAPES = ((128, ("wo", "w2", "lm_head")), (8, ("wo", "w2", "lm_head")),
             (672, ("wqkv", "wo", "w13", "w2")))
HELLO = (4096, 7168)


def _k1(torch, mm, quant, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    banks = {}
    for name in ("wqkv", "wo", "w13", "w2", "lm_head"):
        k, n, layers, bn = K1_BANKS[name]
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        banks[name] = (mm.pretile_weight_bank(w, bn), ws, layers - 1, w[layers - 1]
                       if name in K1_SHAPES[0][1] else None)
        del w
    for m, names in K1_SHAPES:
        total = 0.0
        for name in names:
            wt, ws, li, wk = banks[name]
            xq, xs = quant.per_token_quant_int8(
                torch.randn((m, wt.shape[2]), generator=gen, device="cuda"))
            ref = mm.quant_matmul_int8_stacked_tiled_ref(xq, wt, li, xs, ws)
            if not torch.equal(mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws), ref):
                raise AssertionError(f"K1 {name} M {m} differs from its plain version")
            ms = cmp._graph_ms(
                torch, lambda: mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws), 20)
            out[f"K1 {name} M {m}"] = ms
            total += ms
            if m == 128:
                out[f"_int_mm {name} M 128"] = cmp._graph_ms(
                    torch, cmp._int_mm(torch, xq, wk.contiguous(), xs, ws[li]), 20)
        out[f"K1 {' + '.join(names)} M {m}"] = total
    del banks


def _a(torch, mm, quant, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    for name, k, n in (("wqkv", H, Q + 2 * KV), ("wo", Q, H), ("w13", H, 2 * F), ("w2", F, H)):
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        xq, xs = quant.per_token_quant_int8(torch.randn((8, k), generator=gen, device="cuda"))
        if not torch.equal(mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws),
                           mm.quant_matmul_int8_ref(xq, w[1], xs, ws[1])):
            raise AssertionError(f"A {name} differs from its plain version")
        out[f"A {name} M 8"] = cmp._graph_ms(
            torch, lambda: mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws), 20)
        del w


def _k22(torch, hw, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    x = torch.randn(HELLO, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randn(HELLO, generator=gen, device="cuda").to(torch.bfloat16)
    if not torch.equal(hw.helloworld(x, y), x + y):
        raise AssertionError("K22 differs from x + y")
    out["K22 helloworld"] = cmp._graph_ms(torch, lambda: hw.helloworld(x, y), 50)
    out["torch.add"] = cmp._graph_ms(torch, lambda: torch.add(x, y), 50)


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.models import qwen_next
    from sgl_kernel_npu_tpu_torch.ops import helloworld, matmul, quant, rmsq_gemm

    spec = importlib.util.spec_from_file_location("chip_smoke_of_root",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build(sorted({_build.KERNELS[k] for k in (
        "w8a8_gemm", "w8a8_gemm_tiled", "rmsq_gemm", "fused_moe", "helloworld")}))
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    out = {}
    _k1(torch, matmul, quant, out)
    torch.cuda.empty_cache()
    cmp._k2(torch, matmul, rmsq_gemm, out)
    torch.cuda.empty_cache()
    _a(torch, matmul, quant, out)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    cmp._k8_control(torch, matmul, quant, qwen_next, cs, gen, out)
    cmp._k11_control(torch, cs, out)
    torch.cuda.empty_cache()
    _k22(torch, helloworld, out)
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
        print("compare_gemm_kernels: no CUDA card", file=sys.stderr)
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
        print(f"{side} ({roots[side]}): {line}", flush=True)
        runs[side].append(json.loads(line))
    print(f"{'shape':34s} {'a ms':>9s} {'b ms':>9s} {'b / a':>7s}")
    for key in runs["a"][0]:
        a = statistics.median(r[key] for r in runs["a"])
        b = statistics.median(r[key] for r in runs["b"])
        print(f"{key:34s} {a:9.4f} {b:9.4f} {b / a:7.3f}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
