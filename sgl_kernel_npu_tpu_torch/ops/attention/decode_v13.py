"""The tm2 decode under the name of the JAX package's
ops/attention/decode_v13.py::decode_gqa_pallas_v13_int8_defer, the default of
its tm2 decode path.

v13 has decode_v11's contract and numbers: it only batches several sequences
per TPU loop body, and takes one page per online-softmax step as v11 does. So
the name is decode_v11's wrapper itself: one kernel, K3 (csrc/decode_tm2.cu),
one plain version and one launch counter serve both.
"""

from __future__ import annotations

from .decode_v11 import decode_gqa_v11_int8_defer as decode_gqa_v13_int8_defer

__all__ = ["decode_gqa_v13_int8_defer"]
