#!/usr/bin/env python3
"""Split the time of the fused RMSNorm-quant GEMM (K2) at M 128 between
streaming the weights, transposing them on chip, the wgmmas and the
epilogue, on one card.

  python3 scripts/probe_rmsq_split.py

Builds five variants of csrc/rmsq_gemm.cu under build/rmsq_split/ (nvcc, as
_build.py builds the kernel) and times each through the port's wrapper at
chip_smoke.py's phase-1 per_token shapes (Llama-3-8B's wqkv and w13, M 128,
banks pretiled at 512), in turns (full first and last):

  full          the kernel as it is;
  no_transpose  the consumers leave the weight tile untransposed (its reads,
                byte permutes and stores go; the wgmmas read stale rows);
  no_mma        the wgmmas go (the transpose stays);
  neither       both: the copy rings, barriers and epilogue alone;
  stream        neither, and the epilogue writes no output to device
                memory: the row pass and the weight stream alone.

The variants compute wrong products; only `full` is checked (bit-equal
across its two turns). ms per call by replaying a CUDA graph of the calls
(median of 5), the row pass included; for `stream` also the weight bytes
over its time. Prints one line per variant, then the card's name and power
limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

TRANSPOSE = ("          *reinterpret_cast<uint4*>(bk + n * W_BK + 16 * (kc ^ (n & 7))) =\n"
             "              make_uint4(o[0][c], o[1][c], o[2][c], o[3][c]);")
MMA = ("      wgmma_s8(d, sw128_desc(xa + 32 * kk, 16, 1024), "
       "sw128_desc(ba + 32 * kk, 16, 1024));")
STORE = ("    *reinterpret_cast<uint4*>(out + (size_t)r * a.N * esz + 16 * c) =\n"
         "        *reinterpret_cast<const uint4*>(ot + r * orow + 16 * c);")
NO_STORE = ("    if (c < 0)\n"
            "      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(ot);")
SHAPES = (("wqkv", 4096, 6144), ("w13", 4096, 28672))


def _variants(src):
    def sub(s, old, new):
        if s.count(old) != 1:
            raise SystemExit(f"probe_rmsq_split: '{old[:60]}' is no longer in the source once")
        return s.replace(old, new)
    no_t = sub(src, TRANSPOSE, "          ;")
    neither = sub(no_t, MMA, "      ;")
    return {"full": src, "no_transpose": no_t, "no_mma": sub(src, MMA, "      ;"),
            "neither": neither, "stream": sub(neither, STORE, NO_STORE)}


def main() -> int:
    import torch
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as rq
    import compare_rmsq_mla_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_rmsq_split: no CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "rmsq_split")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, name)) as f, \
                    open(os.path.join(out_dir, name), "w") as g:
                g.write(f.read())
    with open(os.path.join(_build.CSRC, "rmsq_gemm.cu")) as f:
        variants = _variants(f.read())
    procs = {}
    for name, text in variants.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.skt_rmsq_gemm_error.restype = ctypes.c_char_p
        lib.skt_rmsq_gemm_error.argtypes = [ctypes.c_int]
        libs[name] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    cases = {}
    for key, k, n in SHAPES:
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        del w
        x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(torch.bfloat16)
        beta = torch.zeros((k,), device="cuda")
        cases[key] = (lambda x=x, gamma=gamma, beta=beta, wt=wt, ws=ws: rq.rmsnorm_quant_gemm(
            x, gamma, beta, wt, ws, li=1, quant_mode="per_token", out_dtype=torch.bfloat16),
            k * n)
    first = {}
    for name in ("full", "no_transpose", "no_mma", "neither", "stream", "full"):
        _build._libs["rmsq_gemm"] = libs[name]
        row = {}
        for key, (fn, nbytes) in cases.items():
            if name == "full":
                got = fn().clone()
                if key in first and not torch.equal(got, first[key]):
                    raise AssertionError(f"probe_rmsq_split: {key} differs between turns")
                first[key] = got
            row[key] = cmp._graph_ms(torch, fn, 20)
            if name == "stream":
                row[key + " weight TB/s"] = nbytes / row[key] / 1e9
        print(name, json.dumps(row), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
