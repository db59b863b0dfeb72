#!/usr/bin/env python3
"""Split the time of the int8 GEMM stage that K2 (the fused RMSNorm-quant
GEMM) and K1 (the W8A8 GEMM over a pretiled bank) share, at M 128, between
streaming the weights, transposing them on chip, the wgmmas and the
epilogue, on one card.

  python3 scripts/probe_rmsq_split.py

Builds ten variants of csrc/w8a8_wgmma.cuh, each with csrc/rmsq_gemm.cu
and csrc/w8a8_gemm_tiled.cu, under build/rmsq_split/<variant>/ (nvcc, as
_build.py builds the kernels), and times each through the port's wrappers
at chip_smoke.py's phase-1 shapes at M 128 (K2 per_token at Llama-3-8B's
wqkv and w13, banks pretiled at 512; K1 at wo and w2, pretiled at 512, and
lm_head, at 768; and wo unsplit, 16 blocks streaming on an otherwise idle
card), in turns (full first and last):

  full          the kernel as it is;
  no_transpose  the consumers leave the weight tile untransposed (its reads,
                byte permutes and stores go; the wgmmas read stale rows);
  no_mma        the wgmmas go (the transpose stays);
  neither       both: the copy rings, barriers and epilogue alone;
  stream        neither, and the epilogue writes no output to device
                memory: the row pass and the weight stream alone;
  no_merge      the last split of a tile does not add the others' sums;
  raw2, x2      a ring of 2 weight (x) stages instead of 3;
  raw4 x2       4 weight stages and 2 x stages, and `stream` so.

The variants compute wrong products; only `full` is checked (bit-equal
across its two turns). ms per call by replaying a CUDA graph of the calls
(median of 5), K2's row pass included; for `stream` also the weight bytes
over its time (the `stream` ones). Prints one line per variant, then the card's name and power
limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

TRANSPOSE = ("          *reinterpret_cast<uint4*>(bk + n * W_BK + 16 * (kc ^ (n & 7))) =\n"
             "              make_uint4(o[0][c], o[1][c], o[2][c], o[3][c]);")
MMA = "      wgmma_s8(d, da + 2 * kk, db + 2 * kk);"
STORE = ("    *reinterpret_cast<uint4*>(dst + 16 * c) =\n"
         "        *reinterpret_cast<const uint4*>(ot + r * orow + 16 * c);")
NO_STORE = ("    if (c < 0)\n"
            "      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(ot);")
# (kernel, name, K, N, layers, bn)
SHAPES = (("K2", "wqkv", 4096, 6144, 2, 512), ("K2", "w13", 4096, 28672, 2, 512),
          ("K1", "wo", 4096, 4096, 2, 512), ("K1", "w2", 14336, 4096, 2, 512),
          ("K1", "lm_head", 4096, 128256, 1, 768))
HEADER = "w8a8_wgmma.cuh"
LIBS = {"K2": "rmsq_gemm", "K1": "w8a8_gemm_tiled"}


MERGE = "    add_splits_bulk(a, ct, d, reinterpret_cast<unsigned char*>(sm.bk), sm.mfull);"
RAW = "constexpr int W_RAW = 3;"
XS = "constexpr int W_X = 3;"


def _variants(src):
    def sub(s, old, new):
        if s.count(old) != 1:
            raise SystemExit(f"probe_rmsq_split: '{old[:60]}' is no longer in the source once")
        return s.replace(old, new)
    no_t = sub(src, TRANSPOSE, "          ;")
    neither = sub(no_t, MMA, "      ;")
    return {"full": src, "no_transpose": no_t, "no_mma": sub(src, MMA, "      ;"),
            "neither": neither, "stream": sub(neither, STORE, NO_STORE),
            "no_merge": sub(src, MERGE, "    ;"),
            "raw2": sub(src, RAW, "constexpr int W_RAW = 2;"),
            "x2": sub(src, XS, "constexpr int W_X = 2;"),
            "raw4 x2": sub(sub(src, RAW, "constexpr int W_RAW = 4;"), XS, "constexpr int W_X = 2;"),
            "stream raw4 x2": sub(sub(sub(neither, STORE, NO_STORE), RAW,
                                      "constexpr int W_RAW = 4;"), XS, "constexpr int W_X = 2;")}


def main() -> int:
    import torch
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    from sgl_kernel_npu_tpu_torch.ops import quant
    from sgl_kernel_npu_tpu_torch.ops import rmsq_gemm as rq
    import compare_rmsq_mla_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_rmsq_split: no CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "rmsq_split")
    with open(os.path.join(_build.CSRC, HEADER)) as f:
        variants = _variants(f.read())
    procs = {}
    for name, text in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for fname in os.listdir(_build.CSRC):
            if fname.endswith(".cuh") or fname in (f"{lib}.cu" for lib in LIBS.values()):
                with open(os.path.join(_build.CSRC, fname)) as f, \
                        open(os.path.join(vdir, fname), "w") as g:
                    g.write(text if fname == HEADER else f.read())
        for lib in LIBS.values():
            procs[name, lib] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(vdir, f"{lib}.so"),
                 os.path.join(vdir, f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
    libs = {}
    for (name, lib), proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        so = ctypes.CDLL(os.path.join(out_dir, name, f"{lib}.so"))
        err = getattr(so, f"skt_{lib}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        libs[name, lib] = so

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    cases = {}
    for kernel, key, k, n, layers, bn in SHAPES:
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, bn)
        del w
        li = layers - 1
        if kernel == "K2":
            x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
            gamma = (1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(torch.bfloat16)
            beta = torch.zeros((k,), device="cuda")
            fn = (lambda x=x, gamma=gamma, beta=beta, wt=wt, ws=ws, li=li:
                  rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, li=li, quant_mode="per_token",
                                        out_dtype=torch.bfloat16))
        else:
            xq, xs = quant.per_token_quant_int8(
                torch.randn((128, k), generator=gen, device="cuda"))
            fn = (lambda xq=xq, xs=xs, wt=wt, ws=ws, li=li:
                  mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws))
        cases[f"{kernel} {key}"] = (fn, k * n)
        if key == "wo":
            def one_split(fn=fn, m=128, k=k, n=n):
                bm, tm, tn, _ = mm.gemm_plan(m, n, k, 132)
                with mock.patch.object(mm, "gemm_plan", lambda *_: (bm, tm, tn, 1)):
                    return fn()
            cases["K1 wo x1"] = (one_split, k * n)
    first = {}
    for name in ("full", "no_transpose", "no_mma", "neither", "stream", "no_merge", "raw2",
                 "x2", "raw4 x2", "stream raw4 x2", "full"):
        for lib in LIBS.values():
            _build._libs[lib] = libs[name, lib]
        row = {}
        for key, (fn, nbytes) in cases.items():
            if name == "full":
                got = fn().clone()
                if key in first and not torch.equal(got, first[key]):
                    raise AssertionError(f"probe_rmsq_split: {key} differs between turns")
                first[key] = got
            row[key] = cmp._graph_ms(torch, fn, 20)
            if name.startswith("stream"):
                row[key + " weight TB/s"] = nbytes / row[key] / 1e9
        print(name, json.dumps(row), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
