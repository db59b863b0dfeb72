#!/usr/bin/env python3
"""Time K2 (the fused RMSNorm-quant GEMM) built from two checkouts in one
process, in turns, and the int8 stage's split policy, on one card.

  python3 scripts/probe_rmsq_builds.py ROOT_A ROOT_B

K2's C interface is the same in both checkouts, so this tree's wrapper
drives either library: each root's csrc/rmsq_gemm.cu is built under
build/rmsq_builds/ (nvcc, as _build.py builds the kernels) and the two are
timed in turns (a, b, b, a, a, b, b, a) at the comparison's K2 shapes
(per_token wqkv and w13 at M 128, banks pretiled at 512; per_tensor wdqkv
and wuq at M 128, pretiled at 1024; wdqkv on the plain weight at M 8),
every output held equal to the first turn's. Then, on this tree's
libraries, K2 and K1 (wo and w2 at M 128) with the plan's splits (half
the card's SMs for 128-row tiles) against splits that fill the whole card. ms per
call by replaying a CUDA graph of the calls (median of 5); prints the
medians per shape and side, then the card's name and power limit. Needs
one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

H, Q, KV, F = 4096, 4096, 1024, 14336                      # Llama-3-8B
MH, QLORA, C = 2048, 1536, 576                             # DeepSeek-V2-Lite


def _whole_wave(real):
    """gemm_plan with a 128-row tile's splits filling every SM."""
    def plan(m, n, k, sms):
        bm, tm, tn, splits = real(m, n, k, sms)
        if bm == 16:
            return bm, tm, tn, splits
        ksteps = -(-k // 128)
        return bm, tm, tn, max(1, min(16, sms // (tm * tn), ksteps // 2))
    return plan


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    from sgl_kernel_npu_tpu_torch.ops import quant
    from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as rq
    import compare_rmsq_mla_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_rmsq_builds: no CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "rmsq_builds")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for side, root in (("a", sys.argv[1]), ("b", sys.argv[2])):
        src = os.path.join(os.path.abspath(root), "sgl_kernel_npu_tpu_torch", "csrc",
                           "rmsq_gemm.cu")
        so = os.path.join(out_dir, f"{side}.so")
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
        lib.skt_rmsq_gemm_error.restype = ctypes.c_char_p
        lib.skt_rmsq_gemm_error.argtypes = [ctypes.c_int]
        libs[side] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    cases = {}
    for name, k, n in (("wqkv", H, Q + 2 * KV), ("w13", H, 2 * F)):
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
        g = (1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(torch.bfloat16)
        b = torch.zeros((k,), device="cuda")
        cases[f"K2 per_token {name} M 128"] = (
            lambda x=x, g=g, b=b, wt=wt, ws=ws: rq.rmsnorm_quant_gemm(
                x, g, b, wt, ws, li=1, quant_mode="per_token", out_dtype=torch.bfloat16))
        del w
    for name, m, k, n, bn, f32 in (("wdqkv", 128, MH, QLORA + C, 1024, False),
                                   ("wuq", 128, QLORA, 16 * 192, 1024, True),
                                   ("wdqkv plain", 8, MH, QLORA + C, None, False)):
        n_pad = -(-n // bn) * bn if bn else n
        w = torch.zeros((2, k, n_pad), dtype=torch.int8, device="cuda")
        w[..., :n] = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8,
                                   device="cuda")
        ds = torch.rand((2, n_pad), generator=gen, device="cuda") * 1e-3
        bias = torch.randint(-50, 50, (2, n_pad), generator=gen, dtype=torch.int32,
                             device="cuda")
        if f32:
            x = torch.randn((m, 2 * C + k), generator=gen, device="cuda")[:, C:C + k]
        else:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        g = 1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
        b = 0.05 * torch.randn((k,), generator=gen, device="cuda")
        qs, qo = torch.tensor([0.05], device="cuda"), torch.tensor([0.5], device="cuda")
        if bn:
            wt, dsl, bl, li = mm.pretile_weight_bank(w, bn), ds, bias, 1
        else:
            wt, dsl, bl, li = w[1], ds[1], bias[1], None
        cases[f"K2 per_tensor {name} M {m}"] = (
            lambda x=x, g=g, b=b, wt=wt, dsl=dsl, bl=bl, qs=qs, qo=qo, li=li:
            rq.rmsnorm_quant_gemm(x, g, b, wt, dsl, bl, qs, qo, li=li,
                                  quant_mode="per_tensor", quant_cast="fp16"))
    first, times = {}, {}
    for side in ("a", "b", "b", "a") * 2:
        _build._libs["rmsq_gemm"] = libs[side]
        for key, fn in cases.items():
            got = fn().clone()
            if key in first and not torch.equal(got, first[key]):
                raise AssertionError(f"probe_rmsq_builds: {key} differs between builds")
            first.setdefault(key, got)
            times.setdefault((key, side), []).append(cmp._graph_ms(torch, fn, 20))
    print(json.dumps({f"{key} {side}": statistics.median(v)
                      for (key, side), v in times.items()}), flush=True)

    _build._libs["rmsq_gemm"] = libs["b"]
    for name, k, n in (("wo", Q, H), ("w2", F, H)):
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        xq, xs = quant.per_token_quant_int8(torch.randn((128, k), generator=gen, device="cuda"))
        cases[f"K1 {name} M 128"] = (
            lambda xq=xq, wt=wt, xs=xs, ws=ws: mm.quant_matmul_int8_stacked_tiled(
                xq, wt, 1, xs, ws))
        del w
    real = mm.gemm_plan
    times = {}
    for policy in ("plan", "whole", "whole", "plan"):
        plan = real if policy == "plan" else _whole_wave(real)
        with mock.patch.object(mm, "gemm_plan", plan), mock.patch.object(rq, "gemm_plan", plan):
            for key, fn in cases.items():
                got = fn().clone()
                if key in first and not torch.equal(got, first[key]):
                    raise AssertionError(f"probe_rmsq_builds: {key} differs between plans")
                first.setdefault(key, got)
                times.setdefault(key, {}).setdefault(policy, []).append(
                    cmp._graph_ms(torch, fn, 20))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {"K2 per_token wqkv M 128": (128, Q + 2 * KV, H),
              "K2 per_token w13 M 128": (128, 2 * F, H),
              "K2 per_tensor wdqkv M 128": (128, 3072, MH),
              "K2 per_tensor wuq M 128": (128, 3072, QLORA),
              "K2 per_tensor wdqkv plain M 8": (8, QLORA + C, MH),
              "K1 wo M 128": (128, H, Q), "K1 w2 M 128": (128, H, F)}
    for key, by in times.items():
        m, n, k = shapes[key]
        print(key, json.dumps({f"{p} (x{pl(m, n, k, sms)[3]})": statistics.median(v)
                               for p, v in by.items()
                               for pl in [real if p == "plan" else _whole_wave(real)]}),
              flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
