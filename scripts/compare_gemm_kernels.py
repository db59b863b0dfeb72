#!/usr/bin/env python3
"""Time the port's W8A8 GEMM kernels (A, K1, K2 in both modes) from two
checkouts on one card, in turns (a, b, b, a, repeated), at the shapes of
their main paths, with CUDA events.

  python3 scripts/compare_gemm_kernels.py ROOT_A ROOT_B [ROUNDS]

Each turn is a fresh process that imports sgl_kernel_npu_tpu_torch from its
root (building the kernels there on first use), keeps the card busy for a
second so that its clocks ramp up, and times every shape on the same seeded
inputs (median of 5 runs of 50 launches). Prints one JSON line per turn and,
per shape, the median over each checkout's turns and the ratio b / a. ROUNDS
(default 2) repeats a, b, b, a. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS, ITERS = 5, 50

# (kernel, name, M, K, N, layers, panel width or None, mode)
SHAPES = (
    ("A", "wqkv", 8, 4096, 6144, 2, None, None),
    ("A", "wo", 8, 4096, 4096, 2, None, None),
    ("A", "w13", 8, 4096, 28672, 2, None, None),
    ("A", "w2", 8, 14336, 4096, 2, None, None),
    ("K1", "wo", 128, 4096, 4096, 2, 512, None),
    ("K1", "w2", 128, 14336, 4096, 2, 512, None),
    ("K2", "wqkv", 128, 4096, 6144, 2, 512, "per_token"),
    ("K2", "w13", 128, 4096, 28672, 2, 512, "per_token"),
    ("K2", "wdqkv", 128, 2048, 3072, 2, 1024, "per_tensor"),
    ("K2", "wuq f32 x", 128, 1536, 3072, 2, 1024, "per_tensor"),
)


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from sgl_kernel_npu_tpu_torch.ops import matmul, quant, rmsq_gemm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    out = {}
    for kernel, name, m, k, n, layers, bn, mode in SHAPES:
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        x = torch.randn((m, k), generator=gen, device="cuda")
        if bn is not None:
            w = matmul.pretile_weight_bank(w, bn)
        if kernel == "K2":
            x = x if name.endswith("f32 x") else x.to(torch.bfloat16)
            g = torch.ones(k, device="cuda")
            b = torch.zeros(k, device="cuda")
            if mode == "per_token":
                def call():
                    return rmsq_gemm.rmsnorm_quant_gemm(x, g, b, w, ws, None, li=1,
                                                        quant_mode=mode)
            else:
                bias = torch.zeros((layers, n), dtype=torch.int32, device="cuda")
                qs = torch.tensor(0.05, device="cuda")
                qo = torch.tensor(0.0, device="cuda")

                def call():
                    return rmsq_gemm.rmsnorm_quant_gemm(x, g, b, w, ws, bias, qs, qo, li=1,
                                                        quant_mode=mode, quant_cast="fp16")
        else:
            xq, xs = quant.per_token_quant_int8(x.to(torch.bfloat16))

            def call():
                return matmul.quant_matmul_int8_stacked(xq, w, 1, xs, ws)
        for _ in range(3):
            call()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(ITERS):
                call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / ITERS)
        out[f"{kernel} {name} M={m}"] = sorted(times)[REPS // 2]
        del w, ws
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 2
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
        print(f"{side} ({roots[side]}): {line}")
        runs[side].append(json.loads(line))
    print(f"{'shape':28s} {'a ms':>9s} {'b ms':>9s} {'b / a':>7s}")
    for key in runs["a"][0]:
        a = statistics.median(r[key] for r in runs["a"])
        b = statistics.median(r[key] for r in runs["b"])
        print(f"{key:28s} {a:9.4f} {b:9.4f} {b / a:7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
