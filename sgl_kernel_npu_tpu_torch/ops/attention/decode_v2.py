"""Flash-decode v2 over head-major pages (counterpart of the JAX package's
ops/attention/decode_v2.py, whose Pallas kernel decode_gqa_pallas_v2 streams
a sequence's own pages through a double-buffered DMA ring).

The port has one wrapper for that contract: `decode_gqa_pallas_v2` is
ops/attention/decode.py::decode_gqa_hm, kernel K10 on a CUDA tensor (bf16
pages at head dim 128 or 256, f32 pages at 128; csrc/decode_hm.cu,
csrc/decode_hm_f32.cu), its plain version on a CPU tensor. q [B, Hq, Dk];
caches head-major [Hkv, P, ps, D]; seq_lens [B] includes the current token.
Returns [B, Hq, Dv] in q's dtype.
"""

from __future__ import annotations

from .decode import decode_gqa_hm

decode_gqa_pallas_v2 = decode_gqa_hm
