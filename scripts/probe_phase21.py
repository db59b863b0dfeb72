#!/usr/bin/env python3
"""Run chip_smoke.py's phase 21 alone: the attentions surface at public
models' widths (K17's two routes, K18 and K19 at the head dims and dtypes of
WIDTH_LA, WIDTH_EST and WIDTH_TOPK).

  python3 scripts/probe_phase21.py [--ptxas] [--phase1] [--device cpu]

On one H100 it builds K17-K19's libraries (one nvcc each, all at once) and
runs chip_smoke.run_attention_widths; with --ptxas it first compiles those
sources to cubins with -Xptxas -v and prints each kernel's registers,
shared memory and spills; with --phase1 it first runs phase 1's checks of
K17-K19 at their earlier widths (check_laser, check_laser_edges: K17's two
routes at LASER_EDGES, check_sparse_estimate, check_topk, check_topk_edges). With --device cpu it rehearses the phase's
control flow at small shapes on the plain versions (no launch expected,
nothing timed). Exits 1 if the phase fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402

SOURCES = ("laser_attention", "laser_attention_general", "sparse_estimate", "topk_sparse")


def ptxas_report():
    """Each kernel's registers, shared memory and spills, from ptxas."""
    from compare_sass import compile_sass
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES:
            usage = compile_sass(ROOT, name, tmp)[1]
            for k in sorted(u for u in usage if not u.endswith(" spills")):
                print(f"  {name}.cu {k}: {usage[k]}; {usage.get(k + ' spills', '')}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--phase1", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from sgl_kernel_npu_tpu_torch import _build, compat
    from sgl_kernel_npu_tpu_torch.ops.attention import prefill, sparse

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("probe_phase21: no CUDA device", file=sys.stderr)
            return 2
        gpu = cs._gpu_line()
        print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        if args.ptxas:
            ptxas_report()
        t0 = time.perf_counter()
        times = _build.build(SOURCES)
        print(f"builds {time.perf_counter() - t0:.1f} s: {times}")
        cs._warm_up_card(torch)
    else:
        gpu = "cpu"
    parts = []
    if args.phase1 and dev.type == "cuda":
        parts += [("phase 1 K17", lambda: cs.check_laser(torch, prefill)),
                  ("phase 1 K17 edges", lambda: cs.check_laser_edges(torch, prefill)),
                  ("phase 1 K18", lambda: cs.check_sparse_estimate(torch, sparse)),
                  ("phase 1 K19", lambda: cs.check_topk(torch, sparse)),
                  ("phase 1 K19 edges", lambda: cs.check_topk_edges(torch, sparse))]
    parts.append(("phase 21", lambda: cs.run_attention_widths(
        torch, _build, compat, prefill, sparse, dev, gpu, small=dev.type == "cpu")))
    failed = []
    for name, part in parts:
        t0 = time.perf_counter()
        try:
            part()
        except Exception:  # noqa: BLE001 - report every part
            failed.append(name)
            traceback.print_exc()
        print(f"{name} {time.perf_counter() - t0:.1f} s")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"failed: {failed}" if failed else "every part passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
