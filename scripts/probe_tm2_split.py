#!/usr/bin/env python3
"""Split the time of kernels K3 (the tm2 int8 decode) and K14 (the v6
deferred decode over hm pages, bf16 and int8), both on kernel C's loop
(csrc/decode_tm_core.cuh), between their copies, their score products and
their p . v products: K3 at chip_smoke.py's phase 1 and phase 4 shapes and
at rows of four whole pages (2,048 tokens; a byte bound of 0.1653 ms), K14
at the bench shape (128 sequences, 32 / 8 heads, one page of 512, 256..383
cached), on one card.

  python3 scripts/probe_tm2_split.py

Builds variants of csrc/decode_tm_core.cuh with csrc/decode_tm2.cu and
csrc/decode_v6.cu under build/tm2_split/<variant>/ (nvcc, as _build.py
builds the kernels) and times each through the port's wrappers, in turns
(full first and last):

  full       the kernels as they are;
  no_k_mma   the score products go (and the K widening they read);
  no_v_mma   the p . v products go (and the V widening they read);
  loads      both: the copy ring, the softmax and the merge alone;
  stages4    a ring of 4 stages instead of 3 (2 blocks an SM instead of 3);
  recompute  K3 without kept scores: its p . v rounds load K and V and
             recompute the scores, as kernel C's do (K3 only).

full and recompute compute the right output (K3 held within chip_smoke.py's
ATTN_TOL of its plain version, K14 within one bf16 ulp + K14_SHARE of
max|plain|). ms per call by replaying a CUDA graph of 50 calls (median of
5). Prints one line per variant and shape, then the card's name and power
limit. Needs one CUDA card and nvcc; about two minutes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# each product as the core writes it: the int8 and the bf16 branch
K_MMA = ("      mma(c, a, qb[kk][0], qb[kk][1]);", 2)
V_MMA = ("                mma(acc[2 * u + j], va, pb0, pb1);", 1)
V_MMA_BF16 = ("              mma(acc[mt], va, pb0, pb1);", 1)
STAGES = ("constexpr int STAGES = 3;", 1)
KEEP = ("decode_body<HeadMajor, true>(a)", "launch<true>(")
SOURCES = ("decode_tm2", "decode_v6")


def _sub(s, pat, new):
    old, n = pat
    if s.count(old) != n:
        raise SystemExit(f"probe_tm2_split: '{old.strip()[:60]}' is no longer in the source "
                         f"{n} time(s)")
    return s.replace(old, new)


def _variants(core, k3):
    """name -> (core header, K3's source, whether K14 runs)"""
    def cut(s, *pats):
        for pat in pats:
            s = _sub(s, pat, ";")
        return s
    recompute = k3
    for old in KEEP:
        recompute = _sub(recompute, (old, 1), old.replace("true", "false"))
    return {"full": (core, k3, True), "no_k_mma": (cut(core, K_MMA), k3, True),
            "no_v_mma": (cut(core, V_MMA, V_MMA_BF16), k3, True),
            "loads": (cut(core, K_MMA, V_MMA, V_MMA_BF16), k3, True),
            "stages4": (_sub(core, STAGES, "constexpr int STAGES = 4;"), k3, True),
            "recompute": (core, recompute, False)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_tm2_split: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import compare_builds as cmpb
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v6, decode_v11

    with open(os.path.join(_build.CSRC, "decode_tm_core.cuh")) as f:
        core = f.read()
    with open(os.path.join(_build.CSRC, "decode_tm2.cu")) as f:
        k3 = f.read()
    variants = _variants(core, k3)
    procs = {}
    for name, (hdr, src, _) in variants.items():
        d = os.path.join(ROOT, "build", "tm2_split", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("*.cu"))
        with open(os.path.join(d, "decode_tm_core.cuh"), "w") as f:
            f.write(hdr)
        with open(os.path.join(d, "decode_tm2.cu"), "w") as f:
            f.write(src)
        shutil.copy(os.path.join(_build.CSRC, "decode_v6.cu"), d)
        for source in SOURCES:
            so = os.path.join(d, f"{source}.so")
            procs[(name, source)] = (subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                 os.path.join(d, f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (name, source), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
        err = getattr(lib, f"skt_{source}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        libs[(name, source)] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    k3_shapes = {"phase 1": cmpb.k3_inputs(torch, gen, 2),
                 "phase 4": cmpb.k3_inputs(torch, gen, 1),
                 "4 full pages": cmpb.k3_inputs(torch, gen, 4, full=True)}
    cases = {}
    for key, args in k3_shapes.items():
        cases[f"K3 {key}"] = (
            lambda args=args: decode_v11.decode_gqa_v11_int8_defer(*args, layer_idx=1),
            decode_v11.decode_gqa_v11_int8_defer_ref(*args, layer_idx=1), False)
    for int8 in (False, True):
        args = cmpb.k14_inputs(torch, gen, "bench", int8)
        fn = decode_v6.decode_gqa_v6_int8_defer if int8 else decode_v6.decode_gqa_v6_defer
        sc = dict(k_scales=args[5], v_scales=args[6]) if int8 else {}
        ref = decode_v6.decode_gqa_v6_defer_ref(*args[:5], *args[-4:-1], **sc)
        cases[f"K14 {'int8' if int8 else 'bf16'} bench"] = (
            lambda fn=fn, args=args: fn(*args), ref, True)
    cs._warm_up_card(torch)
    times = {}
    order = list(variants) + ["full"]
    for name in order:
        for source in SOURCES:
            _build._libs[source] = libs[(name, source)]
        for key, (fn, ref, k14) in cases.items():
            if k14 and not variants[name][2]:
                continue
            if name in ("full", "recompute"):
                if k14:
                    cs._bf16_check(f"{name} {key}", fn(), ref, cs.K14_SHARE)
                else:
                    err = (fn().float() - ref.float()).abs().max().item()
                    if not err <= cs.ATTN_TOL:
                        raise AssertionError(f"{name} {key}: max-abs {err}")
            times.setdefault((name, key), []).append(cmpb._graph_ms(torch, fn, 50))
    for name in variants:
        line = ", ".join(f"{key} {statistics.median(times[(name, key)]):.4f} ms"
                         for key in cases if (name, key) in times)
        print(f"{name:10s} {line}", flush=True)
    print(cs._gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
