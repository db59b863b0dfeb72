#!/usr/bin/env python3
"""The checkpoint-free quantisation delta of the PyTorch port on one card:
the twin of scripts/accuracy_delta.py, at its two configs, seed and token
counts, through sgl_kernel_npu_tpu_torch/models/quant_ref.py (f32 forwards
against the int8 engines' prefill_step on the same tokens).

  python3 scripts/accuracy_delta_torch.py [--device cuda|cpu] [--full]

Prints the table scripts/accuracy_delta.py writes to ACCURACY.md, and on the
card the card's name and power limit; writes no file. --full adds the rows
of chip_smoke.py phase 20 (a): Meta-Llama-3-8B's widths and bench.py's
DeepSeek-V2-Lite MlaConfig, each cut to 2 layers, T 512.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LLAMA = dict(vocab_size=4096, hidden_size=1024, num_layers=8, num_heads=8, num_kv_heads=4,
             head_dim=128, intermediate_size=2816, page_size=128, max_position=2048)
MLA = dict(vocab_size=4096, hidden_size=1024, num_layers=6, num_heads=8, kv_lora_rank=512,
           qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128, q_lora_rank=768,
           intermediate_size=2048, page_size=128, max_position=2048)
# bench.py --config mla (bench.py:281-284): DeepSeek-V2-Lite with V2's q-LoRA
MLA_BENCH = dict(vocab_size=102400, hidden_size=2048, num_layers=27, num_heads=16,
                 kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
                 q_lora_rank=1536, intermediate_size=10944, page_size=128)


def main() -> int:
    import torch
    from sgl_kernel_npu_tpu_torch.models import deepseek_mla, llama, quant_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("accuracy_delta_torch: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    rows = [("llama_w8a8", "llama", llama.LlamaConfig(**LLAMA), 512),
            ("mla_w8a8_pertensor", "mla", deepseek_mla.MlaConfig(**MLA), 384)]
    if args.full:
        rows += [("llama_w8a8 (Meta-Llama-3-8B widths, 2 layers)", "llama",
                  llama.LlamaConfig(num_layers=2), 512),
                 ("mla_w8a8_pertensor (DeepSeek-V2-Lite widths, 2 layers)", "mla",
                  dataclasses.replace(deepseek_mla.MlaConfig(**MLA_BENCH), num_layers=2), 512)]
    print(f"Device: {card}; torch {torch.__version__}; f32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}, allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print()
    print("| engine | ppl f32 | ppl int8 | Δppl | KL mean | KL max | greedy agree | s |")
    print("|---|---|---|---|---|---|---|---|")
    for name, kind, cfg, t in rows:
        t0 = time.perf_counter()
        m = quant_ref.quant_delta(kind, cfg, t, 0, dev)
        print(f"| {name} | {m['ppl_f32']:.2f} | {m['ppl_int8']:.2f} | "
              f"{m['ppl_delta_pct']:+.2f}% | {m['kl_mean']:.4f} | {m['kl_max']:.4f} | "
              f"{m['greedy_agreement'] * 100:.1f}% | {time.perf_counter() - t0:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
