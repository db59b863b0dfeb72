#!/usr/bin/env python3
"""Split the time of the soft-FP8 GEMM (K21) between moving data,
converting the weights and the MMAs, on one card.

  python3 scripts/probe_wfp8a16_split.py

Builds four variants of csrc/wfp8a16_gemm.cu under build/wfp8a16_split/
(nvcc, as _build.py builds the kernel) and times each through the port's
wrapper at chip_smoke.py's phase-12 shapes, in turns (full first and last):

  full      the kernel as it is;
  no_conv   the consumer warps pass the raw e4m3 bytes on as A fragments
            instead of converting and scaling them (loads, ldmatrix and
            wgmma stay);
  no_mma    the wgmmas are replaced by one add a K step (loads, ldmatrix and
            the conversion stay);
  neither   both: TMA, the barriers and ldmatrix alone.

The variants compute wrong products; only `full` is checked (bit-equal
across its two turns). Shapes: DeepSeek-V3's gate_proj (7168 x 18432) at
M 128 and 4096, down_proj (18432 x 7168) at M 128, GMM1 over 8 experts x
128 rows (7168 x 4096). ms per call by replaying a CUDA graph of the calls
(median of 5). Prints one line per variant, then the card's name and power
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

CALL = "Wgmma<TOK>::rs(acc, cur[kk], sw128_desc(xs + kk * 32, 16, 1024));"
NO_MMA = "acc[kk] += __uint_as_float(cur[kk][0] & 0x3f000000u);"
CONV = ("dequant_pair(r[2 * j], scale, f[0], f[1]);",
        "dequant_pair(r[2 * j + 1], scale, f[2], f[3]);")
NO_CONV = ("f[0] = r[2 * j]; f[1] = r[2 * j] ^ 1u;",
           "f[2] = r[2 * j + 1]; f[3] = r[2 * j + 1] ^ 1u;")


def _variants(src):
    def sub(s, old, new):
        if old not in s:
            raise SystemExit(f"probe_wfp8a16_split: '{old}' is no longer in the source")
        return s.replace(old, new)
    no_conv = sub(sub(src, CONV[0], NO_CONV[0]), CONV[1], NO_CONV[1])
    return {"full": src, "no_conv": no_conv, "no_mma": sub(src, CALL, NO_MMA),
            "neither": sub(no_conv, CALL, NO_MMA)}


def main() -> int:
    import torch

    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops import matmul as mm
    import compare_prefill_fp8_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_wfp8a16_split: no CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "wfp8a16_split")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, name)) as f, \
                    open(os.path.join(out_dir, name), "w") as g:
                g.write(f.read())
    with open(os.path.join(_build.CSRC, "wfp8a16_gemm.cu")) as f:
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
        lib.skt_wfp8a16_gemm_error.restype = ctypes.c_char_p
        lib.skt_wfp8a16_gemm_error.argtypes = [ctypes.c_int]
        libs[name] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    w, s, _ = cmp._fp8_bank(torch, mm, gen, (7168, 18432))
    wd, sd, _ = cmp._fp8_bank(torch, mm, gen, (18432, 7168))
    wg, sg, _ = cmp._fp8_bank(torch, mm, gen, (8, 7168, 4096))
    x128 = torch.randn((128, 7168), generator=gen, device="cuda").to(torch.bfloat16)
    x4096 = torch.randn((4096, 7168), generator=gen, device="cuda").to(torch.bfloat16)
    xd = torch.randn((128, 18432), generator=gen, device="cuda").to(torch.bfloat16)
    xg = torch.randn((1024, 7168), generator=gen, device="cuda").to(torch.bfloat16)
    eid = torch.arange(8, dtype=torch.int32, device="cuda")
    cases = {"gate M128": (lambda: mm.mm_wfp8a16(x128, w, s), 30),
             "gate M4096": (lambda: mm.mm_wfp8a16(x4096, w, s), 10),
             "down M128": (lambda: mm.mm_wfp8a16(xd, wd, sd), 30),
             "GMM1": (lambda: mm.gmm_wfp8a16_aligned(xg, wg, sg, eid), 20)}
    first = {}
    for turn, name in enumerate(("full", "no_conv", "no_mma", "neither", "full")):
        _build._libs["wfp8a16_gemm"] = libs[name]
        row = {}
        for key, (fn, iters) in cases.items():
            if name == "full":
                got = fn().clone()
                if key in first and not torch.equal(got, first[key]):
                    raise AssertionError(f"probe_wfp8a16_split: {key} differs between turns")
                first[key] = got
            row[key] = cmp._graph_ms(torch, fn, iters)
        print(name, json.dumps(row), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
