"""decode_v4 (fused scatter + attend over stacked caches), decode_v5
(grid-pipelined deferred decode) and decode_v7 (two-tier int8 pages + bf16
sidecar window), each a Hopper kernel beside its plain version."""
