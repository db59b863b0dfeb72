"""Token-major paged attention: decode (decode_v9), chunked prefill
(paged_prefill_tm) and the KV append and scale updates (decode_v8)."""
