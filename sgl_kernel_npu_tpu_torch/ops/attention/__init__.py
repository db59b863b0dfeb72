"""Attention. Token-major ("tm") pages: decode (decode_v9, and
decode_v8's per-page contract), chunked prefill (paged_prefill_tm), the KV
append and scale updates (decode_v8). Head-major-within-page ("tm2") pages:
decode (decode_v11, decode_v13), append and scale update (decode_v11). MLA
latent pages: combined-cache decode, append and scale update
(decode_mla_v2), split-cache decode (decode). Page-major ("hm") pages, bf16
or int8: the scatters and the v3 decode (decode_v3), the v6 deferred decode
(decode_v6), the chunk prefill and its block-sparse drive (paged_prefill);
int8 head-major pages: the decode of decode.py (decode_gqa_int8kv). Dense
tensors: laser attention and the varlen causal prefill (prefill). The sparse
family (sparse): the sparse-block estimator, the dense block-sparse tier and
top-k sparse decode over a shared paged cache. Beside them, plain: attention
with sinks (sinks) and the lightning indexer (lightning_indexer); decode_v2
names K10's wrapper as the JAX package's v2 decode."""
