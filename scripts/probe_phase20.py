#!/usr/bin/env python3
"""Run chip_smoke.py's phase 20 alone on one H100: (a) quant_ref's accuracy
delta, (b) the MLA cache modes, (c) attention with sinks, (d) the lightning
indexer, (e) MemorySaver on Llama-3-8B's seed-0 weights (drawn first, as
phase 2 draws them), (f) the compat names.

  python3 scripts/probe_phase20.py [PART ...]

PART is any of a, b, c, d, e, f (all by default). Builds every kernel, then
runs each part through chip_smoke.py's own functions, printing its seconds
and peak device memory; unlike chip_smoke.py it goes on after a part fails
(printing the failure), and exits 1 if any part failed.
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
        print("probe_phase20: no CUDA device", file=sys.stderr)
        return 2
    from sgl_kernel_npu_tpu_torch import _build, compat, memsaver, serving
    from sgl_kernel_npu_tpu_torch.models import deepseek_mla, llama, quant_ref
    from sgl_kernel_npu_tpu_torch.ops import mla_preprocess
    from sgl_kernel_npu_tpu_torch.ops.attention import decode, lightning_indexer, sinks

    gpu = cs._gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    times = _build.build()
    print(f"builds {time.perf_counter() - t0:.1f} s: {times}")
    want = set(sys.argv[1:]) or set("abcdef")
    dev = torch.device("cuda")
    cfg = llama.LlamaConfig(int8_kv=True)
    mcfg = deepseek_mla.MlaConfig(vocab_size=102400, hidden_size=2048, num_layers=27,
                                  num_heads=16, kv_lora_rank=512, qk_rope_dim=64,
                                  qk_nope_dim=128, v_head_dim=128, q_lora_rank=1536,
                                  intermediate_size=10944, page_size=128)

    def memsaver_part():
        t1 = time.perf_counter()
        saver = memsaver.MemorySaver()
        saver.track(llama.init_params(cfg, 0, "cuda"), tag="llama weights")
        torch.cuda.synchronize()
        print(f"  init_params {time.perf_counter() - t1:.1f} s")
        cs.run_memsaver(torch, serving, saver, "llama weights", cfg, dev)

    parts = [
        ("a", lambda: cs.run_quant_accuracy(torch, quant_ref, llama, deepseek_mla, _build, mcfg,
                                            dev)),
        ("b", lambda: cs.run_mla_cache_modes(torch, mla_preprocess, decode, deepseek_mla, _build,
                                             mcfg, dev)),
        ("c", lambda: cs.run_sinks(torch, sinks, _build, dev)),
        ("d", lambda: cs.run_lightning_indexer(torch, lightning_indexer, _build, dev)),
        ("e", memsaver_part),
        ("f", lambda: cs.run_compat(torch, compat, deepseek_mla, _build, dev)),
    ]
    failed = []
    for name, part in parts:
        if name not in want:
            continue
        try:
            cs._part(torch, dev, name, part)
        except Exception:  # noqa: BLE001 - report every part
            failed.append(name)
            traceback.print_exc()
        torch.cuda.empty_cache()
    print(f"failed: {failed}" if failed else "every part passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
