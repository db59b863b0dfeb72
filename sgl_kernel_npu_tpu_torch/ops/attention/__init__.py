"""Paged int8 attention. Token-major ("tm") pages: decode (decode_v9, and
decode_v8's per-page contract), chunked prefill (paged_prefill_tm), the KV
append and scale updates (decode_v8). Head-major-within-page ("tm2") pages:
decode (decode_v11, decode_v13), append and scale update (decode_v11). MLA
latent pages: combined-cache decode, append and scale update
(decode_mla_v2), split-cache decode (decode)."""
