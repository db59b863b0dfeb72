#!/usr/bin/env python3
"""Run chip_smoke.py's phase 17 alone on one H100: the rest of the Llama
serving surface (sampling, grammar bitmasks, multi-LoRA, pause / resume,
the step functions, speculative decoding) at Llama-3-8B width.

  python3 scripts/probe_serving_surface.py

Builds the kernels and the scheduler, draws the seed-0 Llama-3-8B weights,
serves phase 2's prompts greedily (phase 2's run, its launches checked
call by call), then runs each part of phase 17 in turn through
chip_smoke.py's own functions. Unlike chip_smoke.py it goes on after a
part fails (printing the failure), so that one call shows every part's
figures; it exits 1 if any part failed. About 3 minutes, 50 s of them the
builds and 50 s the weights.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_serving_surface: no CUDA device", file=sys.stderr)
        return 2
    from sgl_kernel_npu_tpu_torch import _build, runtime, serving
    from sgl_kernel_npu_tpu_torch.models import llama
    from sgl_kernel_npu_tpu_torch.utils import env

    gpu = cs._gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    runtime.build_native()
    print(f"builds {time.perf_counter() - t0:.1f} s")
    cfg = llama.LlamaConfig(int8_kv=True)
    params = llama.init_params(cfg, 0, "cuda")
    prompts, late = cs._prompts(np.random.default_rng(0), cfg.vocab_size)
    new_tokens = 16
    greedy, st, _, reused, _ = cs.run_engine(torch, serving, _build, cfg, params, prompts, late,
                                             new_tokens, expect=cs.LLAMA_SERVING)
    print(f"phase 2's run: radix reuse {reused}, {cs._ms_per_decode(st):.2f} ms a decode step")
    _build.reset_launches()
    failed = []
    gap = 0.0
    parts = [
        ("a", lambda: cs.check_sampling(torch, serving, _build, cfg, params, prompts, late,
                                        new_tokens, greedy)),
        ("b", lambda: cs.check_grammar(torch, serving, _build, cfg, params, prompts, late,
                                       new_tokens, greedy)),
        ("c", lambda: cs.check_lora(torch, serving, llama, env, _build, cfg, params, prompts,
                                    late, new_tokens, greedy)),
        ("d", lambda: cs.check_pause_resume(torch, serving, _build, cfg, params, prompts, late,
                                            new_tokens, greedy, gpu)),
        ("e", lambda: cs.check_step_functions(torch, serving, llama, _build, params, gpu)),
        ("f", lambda: cs.check_speculative(torch, serving, llama, params, prompts[0], gap, gpu)),
    ]
    for name, part in parts:
        t0 = time.perf_counter()
        try:
            out = part()
            if name == "e":
                gap = out[0]
        except Exception:  # noqa: BLE001 - report every part
            failed.append(name)
            traceback.print_exc()
        torch.cuda.empty_cache()
        print(f"  part ({name}) {time.perf_counter() - t0:.1f} s")
    print(f"launches: { {k: n for k, n in _build.launches.items() if n} }")
    print(gpu)
    print(f"failed parts: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
