#!/usr/bin/env python3
"""Run chip_smoke.py's phase-1 rows of K9 (the bench shape, the f32 pool at
Qwen3-Next-80B-A3B's GDN shape, D 32 and D 64) and its phase 19 alone on one
H100: (a) and (b) on phase 18 (c)'s f32 tree (which runs (c) too), then (c),
the default QwenNextConfig, and (d), the GDN / conv / qkv_fusion surface.

  python3 scripts/probe_phase19.py [PART ...]

PART is any of k9, ab, c, d (all by default). Builds the kernels these parts
launch, then runs each part through chip_smoke.py's own functions; unlike
chip_smoke.py it goes on after a part fails (printing the failure), and
exits 1 if any part failed.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_phase19: no CUDA device", file=sys.stderr)
        return 2
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.models import loader, qwen_next
    from sgl_kernel_npu_tpu_torch.ops.gdn import recurrent_pallas

    gpu = cs._gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, f32 matmul "
          f"precision {torch.get_float32_matmul_precision()!r}")
    t0 = time.perf_counter()
    times = _build.build(["gdn_recurrent", "decode_hm", "w8a8_gemm_tiled", "w8a8_gemm"])
    print(f"builds {time.perf_counter() - t0:.1f} s: {times}")
    want = set(sys.argv[1:]) or {"k9", "ab", "c", "d"}

    def k9():
        rng = torch.Generator(device="cuda")
        rng.manual_seed(0)
        cs.check_gdn(torch, recurrent_pallas, cs.qwen_bench_config(qwen_next), rng)
        rng.manual_seed(19)
        cs.check_gdn_widths(torch, recurrent_pallas, rng)

    def ab():
        def f32_paths(cfg, params):
            print("phase 19 (a), (b)")
            cs.run_qwen_f32(torch, qwen_next, _build, cfg, params, gpu)
        cs.run_hf_qwen_next(torch, qwen_next, loader, _build, gpu, f32_paths=f32_paths)

    parts = [("k9", k9), ("ab", ab),
             ("c", lambda: cs.run_qwen_default(torch, qwen_next, _build, gpu)),
             ("d", lambda: cs.run_gdn_surface(torch, _build, gpu))]
    failed = []
    for name, part in parts:
        if name not in want:
            continue
        t0 = time.perf_counter()
        try:
            part()
        except Exception:  # noqa: BLE001 - report every part
            failed.append(name)
            traceback.print_exc()
        torch.cuda.empty_cache()
        print(f"  part ({name}) {time.perf_counter() - t0:.1f} s")
    print(f"failed: {failed}" if failed else "every part passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
