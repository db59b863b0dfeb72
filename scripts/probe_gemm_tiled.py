#!/usr/bin/env python3
"""Time K1, the W8A8 GEMM over a pretiled bank, against the two choices its
plan and its bank make, on one card: the panel width bn the bank is
pretiled at, and the number of splits of K.

  python3 scripts/probe_gemm_tiled.py

At Llama-3-8B's wo, w2 and lm_head (and K2's w13, through its wrapper) at
M 128, with the bank pretiled at each width of BNS that divides N; then K1
at wo and w2 at M 8, 128 and 672 with K split 1, 2, 4, 8 and 16 ways (the
plan's own choice marked). Each call is checked against the plain version
(K1 exact; K2 within its flip bar at bn 256 against bn 512) and timed by
replaying a CUDA graph of the calls (median of 5). Also lm_head's 501
column tiles (3.8 waves of 132 SMs) against 528 (4 whole waves), for what
the last, partial wave costs. Prints one JSON line per shape, then the
card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

BNS = (256, 512, 768, 1024)
# (name, K, N, layers)
SHAPES = (("wo", 4096, 4096, 2), ("w2", 14336, 4096, 2), ("lm_head", 4096, 128256, 1))
# lm_head's 501 column tiles fill 3.8 waves of 132 SMs; 528 fill 4
TAIL = (("lm_head", 4096, 128256), ("lm_head at 4 whole waves", 4096, 135168))


def main() -> int:
    import torch
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    from sgl_kernel_npu_tpu_torch.ops import quant
    from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as rq
    import compare_rmsq_mla_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_gemm_tiled: no CUDA card", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    for name, k, n, layers in SHAPES:
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        li = layers - 1
        xq, xs = quant.per_token_quant_int8(torch.randn((128, k), generator=gen, device="cuda"))
        ref = mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li])
        row = {}
        for bn in BNS:
            if n % bn:
                continue
            wt = mm.pretile_weight_bank(w, bn)
            if not torch.equal(mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws), ref):
                raise AssertionError(f"probe_gemm_tiled: K1 {name} bn {bn} differs")
            row[f"bn {bn}"] = cmp._graph_ms(
                torch, lambda: mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws), 20)
            del wt
        print(f"K1 {name} M 128 by panel width", json.dumps(row), flush=True)
        del w
    row = {}
    for name, k, n in TAIL:
        w = mm.pretile_weight_bank(torch.randint(-127, 128, (1, k, n), generator=gen,
                                                 dtype=torch.int8, device="cuda"), 768)
        ws = torch.rand((1, n), generator=gen, device="cuda") * 1e-3
        xq, xs = quant.per_token_quant_int8(torch.randn((128, k), generator=gen, device="cuda"))
        row[f"{name} (N {n})"] = cmp._graph_ms(
            torch, lambda: mm.quant_matmul_int8_stacked_tiled(xq, w, 0, xs, ws), 20)
        del w
    print("K1 M 128 by column tiles", json.dumps(row), flush=True)
    k, n = 4096, 28672
    w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
    ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
    x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.ones(k, device="cuda")
    b = torch.zeros(k, device="cuda")
    row, outs = {}, {}
    for bn in (256, 512):
        wt = mm.pretile_weight_bank(w, bn)
        outs[bn] = rq.rmsnorm_quant_gemm(x, g, b, wt, ws, li=1, quant_mode="per_token")
        row[f"bn {bn}"] = cmp._graph_ms(
            torch, lambda: rq.rmsnorm_quant_gemm(x, g, b, wt, ws, li=1, quant_mode="per_token"),
            20)
        del wt
    if not torch.equal(outs[256], outs[512]):
        raise AssertionError("probe_gemm_tiled: K2 w13 differs between panel widths")
    print("K2 w13 M 128 by panel width", json.dumps(row), flush=True)
    del w
    real = mm.gemm_plan
    for name, k, n, layers in SHAPES[:2]:
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        li = layers - 1
        for m in (8, 128, 672):
            xq, xs = quant.per_token_quant_int8(
                torch.randn((m, k), generator=gen, device="cuda"))
            ref = mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li])
            bm, tm, tn, chosen = real(m, n, k, sms)
            row = {}
            for splits in (1, 2, 4, 8, 16):
                with mock.patch.object(mm, "gemm_plan",
                                       lambda *_, s=splits: (bm, tm, tn, s)):
                    def call():
                        return mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws)
                    if not torch.equal(call(), ref):
                        raise AssertionError(f"probe_gemm_tiled: {name} M {m} x{splits} differs")
                    key = f"x{splits}" + (" (plan)" if splits == chosen else "")
                    row[key] = cmp._graph_ms(torch, call, 20)
            print(f"K1 {name} M {m} by splits", json.dumps(row), flush=True)
        del w, wt
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
