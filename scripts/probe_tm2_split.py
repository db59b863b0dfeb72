#!/usr/bin/env python3
"""Split the time of kernel K3 (the tm2 int8 decode on kernel C's loop,
csrc/decode_tm_core.cuh) between its copies, its score products and its
p . v products, at chip_smoke.py's phase 1 and phase 4 shapes and at rows of
four whole pages (2,048 tokens; a byte bound of 0.1653 ms), on one card.

  python3 scripts/probe_tm2_split.py

Builds variants of csrc/decode_tm_core.cuh with csrc/decode_tm2.cu under
build/tm2_split/<variant>/ (nvcc, as _build.py builds the kernels) and
times each through the port's wrapper, in turns (full first and last):

  full       the kernel as it is;
  no_k_mma   the score products go (and the K widening they read);
  no_v_mma   the p . v products go (and the V widening they read);
  loads      both: the copy ring, the softmax and the merge alone;
  stages4    a ring of 4 stages instead of 3 (2 blocks an SM instead of 3);
  recompute  K3 without kept scores: its p . v rounds load K and V and
             recompute the scores, as kernel C's do.

All but no_k_mma, no_v_mma, loads and stages4 compute the right output (held within
chip_smoke.py's ATTN_TOL of the plain version). ms per call by replaying
a CUDA graph of 50 calls (median of 5). Prints one line per variant and shape, then the
card's name and power limit. Needs one CUDA card and nvcc; about a minute.
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

K_MMA = "    mma(c, a, qb[kk][0], qb[kk][1]);"
V_MMA = "              mma(acc[2 * u + j], va, pb0, pb1);"
STAGES = "constexpr int STAGES = 3;"
KEEP = ("decode_body<HeadMajor, true>(a)", "launch<true>(")


def _variants(core, k3):
    def sub(s, old, new):
        if s.count(old) != 1:
            raise SystemExit(f"probe_tm2_split: '{old[:60]}' is no longer in the source once")
        return s.replace(old, new)
    recompute = k3
    for old in KEEP:
        recompute = sub(recompute, old, old.replace("true", "false"))
    return {"full": (core, k3), "no_k_mma": (sub(core, K_MMA, "    ;"), k3),
            "no_v_mma": (sub(core, V_MMA, "              ;"), k3),
            "loads": (sub(sub(core, K_MMA, "    ;"), V_MMA, "              ;"), k3),
            "stages4": (sub(core, STAGES, "constexpr int STAGES = 4;"), k3),
            "recompute": (core, recompute)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_tm2_split: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import compare_builds as cmpb
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v11

    with open(os.path.join(_build.CSRC, "decode_tm_core.cuh")) as f:
        core = f.read()
    with open(os.path.join(_build.CSRC, "decode_tm2.cu")) as f:
        k3 = f.read()
    variants = _variants(core, k3)
    procs = {}
    for name, (hdr, src) in variants.items():
        d = os.path.join(ROOT, "build", "tm2_split", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns("*.cu"))
        with open(os.path.join(d, "decode_tm_core.cuh"), "w") as f:
            f.write(hdr)
        with open(os.path.join(d, "decode_tm2.cu"), "w") as f:
            f.write(src)
        so = os.path.join(d, "decode_tm2.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, os.path.join(d, "decode_tm2.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(so)
        lib.skt_decode_tm2_error.restype = ctypes.c_char_p
        lib.skt_decode_tm2_error.argtypes = [ctypes.c_int]
        libs[name] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    shapes = {"phase 1": cmpb.k3_inputs(torch, gen, 2), "phase 4": cmpb.k3_inputs(torch, gen, 1),
              "4 full pages": cmpb.k3_inputs(torch, gen, 4, full=True)}
    refs = {k: decode_v11.decode_gqa_v11_int8_defer_ref(*a, layer_idx=1) for k, a in shapes.items()}
    cs._warm_up_card(torch)
    times = {}
    order = list(variants) + ["full"]
    for name in order:
        _build._libs["decode_tm2"] = libs[name]
        for key, args in shapes.items():
            def fn(args=args):
                return decode_v11.decode_gqa_v11_int8_defer(*args, layer_idx=1)
            if name not in ("no_k_mma", "no_v_mma", "loads", "stages4"):
                err = (fn().float() - refs[key].float()).abs().max().item()
                if not err <= cs.ATTN_TOL:
                    raise AssertionError(f"{name} {key}: max-abs {err}")
            times.setdefault((name, key), []).append(cmpb._graph_ms(torch, fn, 50))
    for name in variants:
        line = ", ".join(f"{key} {statistics.median(times[(name, key)]):.4f} ms"
                         for key in shapes)
        print(f"{name:10s} {line}", flush=True)
    print(cs._gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
