#!/usr/bin/env python3
"""Run chip_smoke.py's phase-1 rows of this slice and its phase 18 alone on
one H100: K10 at head dim 256, K2 at wo's, w2's and lm_head's shapes, then
the HF checkpoints of the four model families, Qwen3-Next at its published
widths, Llama TP and the two K2 routes.

  python3 scripts/probe_phase18.py [PART ...]

PART is any of k10, k2, a (with e, which runs on a's checkpoint), b, c, d,
f (all by default). Builds the kernels and the scheduler, then runs each
part through chip_smoke.py's own functions; unlike
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
        print("probe_phase18: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from sgl_kernel_npu_tpu_torch import _build, parallel, runtime, serving
    from sgl_kernel_npu_tpu_torch.models import deepseek_mla, llama, loader, qwen_next
    from sgl_kernel_npu_tpu_torch.ops import matmul, rmsq_gemm
    from sgl_kernel_npu_tpu_torch.ops.attention import decode, decode_v3

    gpu = cs._gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    runtime.build_native()
    print(f"builds {time.perf_counter() - t0:.1f} s")
    cfg = llama.LlamaConfig(int8_kv=True)
    mcfg = deepseek_mla.MlaConfig(vocab_size=102400, hidden_size=2048, num_layers=27,
                                  num_heads=16, kv_lora_rank=512, qk_rope_dim=64,
                                  qk_nope_dim=128, v_head_dim=128, q_lora_rank=1536,
                                  intermediate_size=10944, page_size=128)
    prompts, late = cs._prompts(np.random.default_rng(0), cfg.vocab_size)
    mprompts, mlate = cs._prompts(np.random.default_rng(0), mcfg.vocab_size)

    def routes():
        params = llama.pretile_big_weights(llama.init_params(cfg, 0, "cuda"), block_n=512)
        return cs.run_k2_routes(torch, llama, _build, params, gpu)
    want = set(sys.argv[1:]) or {"k10", "k2", "a", "b", "c", "d", "f"}
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)
    parts = [
        ("k10", lambda: (cs.check_decode_hm256(torch, decode, rng),
                         cs.check_decode_hm_edges(torch, decode, decode_v3, d=256),
                         cs.check_decode_hm_edges(torch, decode, decode_v3))),
        ("k2", lambda: cs.check_rmsq_routes(torch, matmul, rmsq_gemm, cfg, rng)),
        ("a", lambda: cs.run_hf_llama(torch, serving, llama, loader, _build, prompts, late, 16,
                                      gpu)),
        ("b", lambda: cs.run_hf_mla(torch, serving, deepseek_mla, loader, _build, mcfg,
                                    mprompts, mlate, 16, gpu)),
        ("c", lambda: cs.run_hf_qwen_next(torch, qwen_next, loader, _build, gpu)),
        ("d", lambda: cs.run_hf_moe_bank(torch, parallel, loader, _build, gpu)),
        ("f", routes),
    ]
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
    print(f"launches: { {k: n for k, n in _build.launches.items() if n} }")
    print(f"failed: {failed}" if failed else "every part passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
