#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sgl_kernel_npu_tpu_torch) on one NVIDIA H100.

  python3 chip_smoke.py

Builds the CUDA kernels (one nvcc per source, all at once) and the native
scheduler (g++) from the checkout into build/torch_kernels/, then:

1. Holds every kernel against its plain PyTorch version on the card at the
   shapes of its main path: the Llama serving path's A-D (Llama-3-8B, decode
   batch 8), the Llama bench path's K1-K4 (batch 128, 512-token tm2 pages,
   pretiled banks; K1 also at M 1, 8, 16, 17, 100, 129 and 672, on panels
   of 128, 384 and 1024 and at K 64, bf16 and f32 out, a second call
   bit-identical; B also at the engine's largest call, 256 tokens over a
   512-token prefix, and at prefixes 200, 63, 64, 0 with an empty chunk,
   one launch per call), the two contracts that reuse A and C (matmul.py:71 at
   L = 1, decode_v8.py:388), and the MLA paths' kernels at DeepSeek-V2-Lite
   width: K2 in its per_tensor mode, K5 (int8 and bf16 latent rows; also
   at the edges of its cluster split, passes and steps: pages of 16 to 256,
   cp 1, 3 and 4 over 6 pages, lengths 0, 1, ps - 1, ps, ps + 1 and across
   steps, batches of 10, 64 and 128, steps of 1,792 to 8,192 tokens whose
   shares split over clusters of 2, 4 and 8 CTAs; and at a sharper score
   spread: rows of 3,072 with q of 1.5 randn, rows of 576 with q of 1.5
   sqrt(3072 / 576) randn; a second call bit-identical), K6 (also at its
   edges on 0x7f-filled caches: L 1, B 1, every row dropped, pages -1 and
   P, slots 0 and ps - 1, bf16 rows of 1,152 bytes, batches below and
   above the SM count; a second call bit-identical) and
   K7 (also at the edges of its split plan: 8 sequences of 1 token, one of
   4,097, 8 equal ones, lengths beside a round or a split, 4 and 20 heads
   with krope 16 and 6; a second call bit-identical); and the Qwen3-Next bench path's kernels at its shapes: K8 (the
   grouped expert GEMM, 5,376 aligned rows of 128 tokens routed top-10 over
   128 experts), K9 (the recurrent gated-delta-rule step on the bf16 pool;
   also on an f32 pool at Qwen3-Next-80B-A3B's GDN shape, 128 sequences of
   16 / 32 heads of 128, and at the default QwenNextConfig's head dim 32,
   bf16 and f32 pools, and D 64 checked) and K10 (head-major bf16 paged
   decode; also at head dim 256, G 8, at
   phase 18 (c)'s Qwen3-Next-80B-A3B shape and at its edges); K2 where
   phase 18 (f)'s routes put it (wo and w2 with apply_norm=False at M 128,
   lm_head at K 4096, N 128,256, f32 out); and the MoE layer's kernels at
   `bench.py --config moe`'s shapes: K11 (the single-launch fused layer,
   8 experts of 7168 x 4096 and 2048 x 7168, 1,024 routed rows; also with
   every copy on one expert and with -1 slots), K12 (the chunked ragged
   scatter, the quantising dispatch and the bf16 combine), K8 at that
   layer's shapes (GMM1 and GMM2 on the aligned compaction of the first
   round at chunk_rounds 1, 2 and 4, exact; one kernel a call) and K13
   (swiglu_quant on GMM1's 2,048 x 4096 output, on no main path); K11 also
   at maxT 8 and 72 (8 and 72 tokens: a window's one 128-row m-tile
   partial), there also with every copy on one expert; K8 also at its
   edges (32-row expert tiles with 17-32 live rows, padding tiles of 32 and
   128 rows, expert ids past the bank, split K at both tile heights with
   repeats, plain and pretiled banks, bf16 and f32 out); and the hm Llama
   path's kernels at Llama-3-8B's heads: K14 (deferred decode with bf16
   products, bf16 and int8 pages) at the bench shape (128 sequences of
   256..383 cached tokens, 512-token pages) and the engine's (8 sequences,
   128-token pages; also G 1, 2, 4, 8 and 16, pages of 16, 100 and 512,
   cached 0, 1, ps - 1, ps, ps + 1 and over 4 pages, a second call
   bit-identical), K15 (paged chunk prefill: 512 tokens over 256 cached,
   bf16 and int8 pages, and a page_sel drive with an empty tile) and K16's
   five contracts (v3 decode bf16 / int8, current token in the cache or
   deferred; int8 head-major decode) at the bench shape, and K16's and
   K23's edges (G 1, 4, 8, 16, a batch of 7 split over blocks, pages of
   16, 100, 512 and 8,192, lengths 0, 1, ps - 1, ps, ps + 1, cached 0;
   decode_int8kv, decode_v4b_int8 and the fused pair at G 4 and 16, the
   fused writes bit-equal, second calls bit-identical); and the
   `attentions` surface's kernels: K17 (laser attention at Llama-3-8B's
   heads, B 1: causal T 8192, not causal T 4096, causal T 8000; held, not
   timed, at T 96 and 1000, causal and not), K18 (the
   sparse-block estimator's scores at [1, 8, 8192, 128] and bench_ops.py's
   [4, 16, 4096, 128], blocks of 128; the keep-0.25 masks equal), K19 (top-k
   block-sparse decode at bench_ops.py's shape, B 64, H 16, D = Dv = 128, and
   at DeepSeek-V2-Lite's latent rows, B 128, D 576, Dv 512; 256 blocks a row,
   one row all -1; also at KB 251, no multiple of its split count, with a
   split of only -1 ids, chunk 1 and 64, a second call bit-identical) and K20 (add_rmsnorm_bias's quant pass at hidden 4096,
   N 8192 and 128 in bf16, and its f32 instantiation at N 128: h exact,
   int8 within a flip bar; also at N 1, 127, 129 and 8192 by d 8 and
   8192, bf16 and f32, on 0x7f-filled outputs, a second call
   bit-identical); phase 1 also times an empty kernel by the same graph
   replay (the card's launch floor, printed beside the bounds, folded into
   none); and the last nine TPU kernels' ports: K21 (the
   soft-FP8 W8A16 GEMM at DeepSeek-V3's fp8 widths: gate_proj, down_proj and
   kv_a_proj_with_mqa at M 128, gate_proj at M 4096, the grouped GEMM on
   phase 8's routed rows; also at M 8, a ragged K and N, 32-row tiles), K22
   (helloworld, exact, also at n 1, 8, 1,001 and 8,003; its time over
   torch.add's printed), K23's five contracts (the attic's v5, v4b and fused
   v4 decodes; the fused writes bit-equal) and K24 (the attic's v7 two-tier
   decode) at Llama-3-8B's heads, batch 64, 256..383 cached tokens; K21
   within calc_diff 1e-5 and one bf16 ulp plus 1e-4 of max|plain|, K23 one
   ulp plus 1e-4, K24 one ulp plus 2e-3. K11's recv
   and rs and K12 must agree exactly, K11's returned rows and K13's int8
   within a flip bar (MOE_FLIP_SHARE), K13's scales within one ulp (also
   with f32 x, with do_limit, at N 1,003, 64, 8,192 and 8,200, at totals 0 and
   S, on cumulative group lists, an empty list of counts and a list of
   type 2, rows past the total zero on 0x7f-filled outputs). D is also held at
   a prefill chunk's shape (8 sequences of 512 padded rows over 32
   layers, the live rows of phase 2's first prefill) on 0x7f-filled
   caches, and D (both shapes) and K4 are timed cold too: their calls
   cycle over enough buffers that a replay touches more than twice the
   card's 50 MB L2, as the model's caches are found. The
   GEMMs and appends must agree
   exactly, the fused RMSNorm-quant GEMM within 4 quant flips with >= 99% of
   rows exact (also at the edges of its plan: M 1, 8, 17, 200, 256, a ragged
   N, K % 128 == 64, split and unsplit K; a second call bit-identical), the Llama attention kernels within 2e-2 max-abs, K5, K7 and
   K10 (on O(1) outputs of a peaked softmax) within one bf16 ulp plus 2e-3
   (K5, K14) or 1e-4 (K7, K10, K15, K16, K17, K19) of max|plain|, K9's output within 1e-4 of
   max|plain| and its pool within one bf16 ulp, rows it must not write
   untouched. C is also held at cached 0, 1, 15, 16, 17 (shorter than a
   split's share), 200, 700 and 1500 over a block table of 128 pages, both
   contracts, a second call bit-identical. Tie-prone inputs (keys in tied
   pairs whose values sit a unit apart; for K21 sums on a bf16 midpoint)
   hold B, K5, K17, K15's int8 body and K21, whose tensor-core sums are not
   promoted to f32 round-to-nearest, to their phase-1 bars and print the
   share of outputs off the plain version's.
   Times the kernel, the plain version and a PyTorch library yardstick with
   CUDA events, and computes each kernel's bound from its bytes and
   operations.
2. Serves 8 greedy requests through LlamaEngine at Llama-3-8B width (int8 KV,
   seed-0 random weights) with all launch counters set to 0 first, checks
   the tokens, the logits, the scheduler and every call's launches (prefill
   A 128, B 32, D 1, A at L = 1 1; decode A 128, C 32, D 1, A at L = 1 1), and
   serves them again to check that the tokens repeat.
3. Runs small configurations on the card and on the CPU (plain versions)
   and compares logits and caches: Llama prefill and decode on tm pages,
   a LlamaEngine on tm pages (four requests, two sharing a prefix with the
   first two, contexts across C's softmax step: every greedy token equal,
   and no CPU decision on a tie of the two best logits),
   Llama decode on tm2 pages with pretiled banks, a 2-layer MLA config on
   both MLA paths, a 4-layer Qwen3-Next config (head dims 128, 8
   experts top-2) through decode_step_q, and a 2-layer Llama config on hm
   pages, bf16 and int8: prefill, v6 decode, then one step each of v3 and
   SKT_DECODE_DEFER=0 (layer-0 bf16 caches bit-equal)
   and an hm engine (equal greedy tokens).
4. Runs the decode path of `python bench.py` (tm2 pages, pretiled banks,
   batch 128, context 256, 32 greedy steps per call) at Llama-3-8B width on
   phase 2's weights with the counters set to 0 first: checks the logits,
   the exact launches per step of K1-K4 (65, 64, 32, 1) and that a second
   run from the same state repeats its tokens; prints ms per step, tok/s,
   the share of bench.py's byte roofline, and a profiler split of a step.
5. Serves phase 2's prompts through MlaEngine at DeepSeek-V2-Lite width
   (seed-0 weights, split latent caches): every decode call launches
   exactly K2 per_tensor 54, A 81, A at L = 1 1 and K7 27, every prefill
   call the same without an attention kernel; the tokens repeat; prints a
   profiler split of a decode call (K2, A, K7, glue).
6. Runs the decode path of `python bench.py --config mla` (an int8 combined
   latent cache, banks pretiled at 1024, batch 128, context 256, 16 greedy
   steps per call) on phase 5's weights: exact launches per step (K2 27 and
   54 per_tensor, K1 54, A at L = 1 1, K5 27, K6 1), finite logits, repeat
   tokens; prints ms per step, tok/s, the roofline share and a profiler
   split.
7. Runs the decode path of `python bench.py --config qwen` (init_params_q
   int8 weights from seed 0, a bf16 SSM pool, batch 128, context 256,
   128-token pages, 8 greedy steps per call) at its full width: exact
   launches per step (K1 55, K8 24, K9 9, K10 3), finite logits, repeat
   tokens; prints ms per step, tok/s, the share of bench.py's byte roofline
   and a profiler split. Its state holds seeded random values where
   bench.py leaves zeros.
8. Runs the MoE layer of `python bench.py --config moe` at EP = 1
   (bench.py:378-494, seed-0 data in its order): its four variants
   (Buffer.fused_deep_moe at chunk_rounds 1, 2, 4 through the default
   strategy, and the pallas strategy's single launch), the pallas
   strategy's capacity tier (capacity_rows=1024) and its dispatch ->
   combine. Every variant: exact launches per call (K8 2 / 4 / 8; K11 1;
   K12 2 + K8 2; K12 2), a bit-identical second call, finite, within
   calc_diff 1e-5 of the same call through the plain versions on the same
   card tensors (SKT_IMPL=ref), within the JAX package's tier bound
   (rtol = atol = 0.05) of rounds = 1 (dispatch -> combine: of x * sum of
   the weights); prints the device time per call by
   CUDA graph replay, tok/s, bench.py's roofline share and a profiler split.

9. Runs (right after phase 4, on its pretiled weights) the decode path of
   `python bench.py --bf16-kv`: bf16 hm pages of 512, batch 128, context
   256, 32 greedy steps per call, one warm and three timed: exact launches
   per step (K1 65, K2 64, K14 32), a repeat run; ms per step, tok/s, the
   share of bench.py's byte roofline with kv_elt 2, a profiler split. From
   the v6 run's state, fed its tokens, 4 steps each of v6,
   SKT_DECODE_ATTN=v3 and SKT_DECODE_DEFER=0 (K16), each step also through
   the plain versions (SKT_IMPL=ref) from the same state: logits within
   calc_diff 8e-3 of them, DEFER=0 within 8e-3 of v3 (the distance of v3
   to v6, which rounds p to bf16, is printed); and 8 steps of bench.py's
   SKT_KV_LAYOUT=hm on an int8 cache (K14 int8 32 per step), then 4 steps
   each of v3 and DEFER=0 from its state (K16 int8, 32 per step each),
   each held to its plain versions the same way, and a profiled step of
   each (K16's device ms a step).
10. Serves phase 2's prompts through LlamaEngine on hm pages at Llama-3-8B
   width on the same weights: int8_kv=False, then int8 with
   kv_layout="hm"; every model call's launches exact (prefill K1 129, K15
   32; decode K1 65, K2 64, K14 32), all requests finish, the prefix is
   reused, a rerun repeats the tokens; a steady decode call's device time
   by kernel and its idle share.
11. Drives the `attentions` surface through its public functions at full
   width, the counters set to 0 first: (a) prefill.laser_attention at
   phase 1's three cases (K17 1 per call); (b) the sparse prefill at T 8192,
   prefix 0, bf16 hm pages of 128: sparse_block_estimate_dispatch (K18 1)
   -> block_mask_to_page_lists -> block_sparse_paged_attention (K15 1), at
   keep 0.25 and 1.0 (then the mask is full causal and the output equals
   (a)'s causal laser output); (c) topk_block_sparse_attention at phase 1's
   two shapes (K19 1), also held to topk_sparse_attention over the same
   tokens; (d) norm.add_rmsnorm_bias with quant, N 8192 and 128 (K20 1).
   Every call: exact launches and no other kernel, finite, a second call
   bit-identical, within phase 1's bars of the same call under SKT_IMPL=ref
   (but (b) at keep 1.0, whose plain K15 loop is too long); prints ms per
   call and the sparse prefill's time against the dense ones.
12. Drives the soft-FP8 surface through its public functions at
   DeepSeek-V3's widths (weights from per_block_quant_fp8 of seeded bf16
   banks, 128 x 128 blocks), the counters set to 0 first: mm_wfp8a16 at M
   128 (gate_proj, down_proj, kv_a_proj_with_mqa) and M 4096 (gate_proj),
   gmm_wfp8a16 on phase 8's 1,024 routed rows (GMM1, GMM2; GMM1 also with
   every row on one expert and with sum(group_list) < S, rows past it zero),
   helloworld on [4096, 7168]. Every call: exact launches (K21 1, K22 1, no
   other kernel), finite, a second call bit-identical, within K21's bar of
   the same call under SKT_IMPL=ref (helloworld equal).
13. Drives the attic's port at Llama-3-8B's heads (64 sequences of 256..383
   cached tokens, 128-token pages), the counters set to 0 first: the v5
   decodes, a 32-layer step of scatter_stacked_int8 + decode_v4b_int8 and of
   each fused v4 decode on stacked caches (2.2 GB of int8 K and V; the layer
   a device tensor), 70 steps of the v7 loop (decode, sidecar append, window
   flush: every sequence crosses one). Every call or step: exact launches,
   finite, a repeat from the same state bit-identical, the caches it writes
   equal to the same step's under SKT_IMPL=ref, the outputs within K23's or
   K24's bar of that run.

14. Drives the EP layer's normal-mode surface through Buffer(None, 256) at
   DeepSeek-V3's prefill shape (4,096 tokens of 7168 bf16, top-8 of 256
   experts, seeded routing with weights summing to 1): dispatch -> combine
   under "default" and "alltoall", bf16 and int8 (received rows equal the
   source rows or their int8 quantisation; the round trip within the JAX
   tests' bars), notify_verify (equal to the dispatch's counts), the
   long-sequence rounds (SKT_NORMAL_LONG_SEQ_ROUND=4, equal to one round),
   the layered normal and low-latency strategies over (EPGroup(None),
   EPGroup(None)) (equal to the flat ones bit for bit), and the fp8, mxfp8
   and mxfp4 low-latency modes at 128 tokens (the round trip within the
   JAX bars). Every call twice, bit-identical; no kernel launch.
15. Runs models/deepseek_v3.py at DeepSeek-V3's published widths (vocab
   129,280, hidden 7168, 128 heads, q / kv LoRA 1536 / 512, 256 experts
   top-8 of 2048, one shared expert, routed scaling 2.5), depth cut from 61
   to 2 layers, EP = 1, weights drawn on the card by a seeded
   torch.Generator in init_params' shapes and scales: batch 128, 256..383
   cached tokens on 16-token pages, 8 greedy steps with exact launches (A
   at L = 1 1 and K8 2 a layer), finite logits, a repeat from the same
   state bit for bit, and each step against the same step under
   SKT_IMPL=ref within calc_diff 8e-3; ms per step, tok/s, a profiler split.
16. The same for models/moe.py at Qwen1.5-MoE-A2.7B's widths (vocab
   151,936, hidden 2048, 24 layers, 16 heads of 128 over 16 kv heads, 60
   experts top-4 of 1408, a shared expert of 5632), f32 caches: K10 on f32
   pages 1 and K8 2 a layer. Phase 1 holds K10's f32 form at this phase's
   attention shape and at its edges.
17. Runs right after phase 2, on its seed-0 weights (untiled banks), the
   counters set to 0 first, the rest of the Llama serving surface at
   Llama-3-8B width: (a) a tm engine sampling at temperature 0.8, top_k 50,
   top_p 0.95 serves phase 2's prompts twice from seed 0 (the same
   tokens), and at top_k 1 gives phase 2's greedy tokens up to each
   request's first exact tie of its two best (bf16) logits; (b) half the
   requests under the even-ids bitmask emit only even ids, the others
   phase 2's tokens; (c) 4 LoRA adapters of rank 16, ids -1..3 in one
   batch: the -1 requests give phase 2's tokens, one decode_step_kv call
   with lora_ids within calc_diff 8e-3 of SKT_IMPL=ref, its -1 rows equal
   to the call without adapters, the others moved; (d) a request paused
   mid-decode, a new request taking its page, the request resumed: all 8
   requests give phase 2's tokens; (e) a 512-token prompt through
   prefill_chunk_step in chunks of 128 on bf16 hm pages and decode_step
   gives the hm engine's tokens, and decode_verify_step on a 4-token chain
   is held to decode_step's logits and to itself a token a call by
   calc_diff 8e-3; (f) speculative_generate with a 2-layer draft (seed 1),
   draft_len 4, 64 new tokens, and with the target as its own draft, each
   held to the target's judgement of its output (the first token the
   prefill's argmax; every later one, by one decode_verify_step over the
   output, within a margin whose bound (e) measures of its row's best
   logit); prints the accept counts; (g)
   A, B, C, D, K14 and K15 each launched. Every engine call's launches
   exact (phase 2's on tm pages; A 128, K15 or K14 32, A at L = 1 1 on hm
   pages). Prints the engines' decode ms a step beside phase 2's.
18. HF checkpoints, Qwen3-Next at its published widths, Llama TP and the
   K2 routes. Each checkpoint is written in bf16 from a seeded
   torch.Generator on the card into its own directory under
   build/hf_checkpoints/, loaded with models/loader.py and deleted; write
   and load seconds printed. (a) Meta-Llama-3-8B's widths, 2 of 32 layers:
   load_llama_w8a8 on the card (layer 0's banks and lm_head bit-equal to
   the CPU load), phase 2's 8 requests through LlamaEngine (16 tokens each,
   exact launches a call, a repeat identical; A-D launched). (e) on (a)'s
   weights: decode_step_tp at tp 1 on a one-rank NCCL group bit-identical
   to decode_step_kv, then tp 2 in two processes sharing the card over a
   gloo group, 3 steps within calc_diff 5e-3 of decode_step_kv, per-shard
   launches printed. (b) bench.py's MlaConfig, 2 of 27 layers, through
   MlaEngine (as (a); K2 per_tensor, A, K7 launched). (c)
   Qwen/Qwen3-Next-80B-A3B-Instruct's config.json (hidden 2048, 16 / 2
   heads of 256, GDN 16 / 32 heads of 128, 512 experts top-10 of 512),
   4 of 48 layers: load_qwen_next (its seed-0 template draw timed) ->
   quantize_qwen_weights -> 8 greedy decode_step_q steps at batch 128 over
   256..383 cached tokens on 128-token pages (exact launches a step: K1 19,
   K8 8, K9 3, K10 at D 256 1), a repeat bit-identical, step 1 within
   calc_diff 8e-3 of SKT_IMPL=ref. (d) DeepSeek-V3's expert names for phase
   8's layer, load_moe_expert_bank, phase 8's rounds=1 and pallas_fused
   calls on it (exact launches, repeats identical, within 1e-5 of
   SKT_IMPL=ref, the tier bound). (f) runs after phase 10 on phase 4's
   pretiled weights: 4 steps each with the knobs off, SKT_FUSED_LM=1, and
   both SKT_FUSED_LM=1 and SKT_FUSED_QGEMM=1 (a step's K1 65 / 64 / 0, K2
   64 / 65 / 129), logits within calc_diff 8e-3 of the knobs off.
19. Qwen3-Next's f32 paths and the GDN / conv surface. (a) and (b) run in
   phase 18 (c) on its loaded f32 tree before it is quantised (TF32 must be
   off; the peak device memory printed): (a) the f32 decode_step at (c)'s
   traffic (batch 128, 8 greedy steps, an f32 SSM pool; exact launches a
   step: K9 on the f32 pool 3, K10 at D 256 1, nothing else), a repeat
   bit-identical, step 1 within calc_diff 1e-4 of SKT_IMPL=ref, its device
   split; (b) forward_full at B 2, T 192 (three chunks of 64) held at every
   position within calc_diff 1e-3 of decode_step fed the same tokens a
   token at a time from an empty state, and prefill_gdn_layer's final
   state of GDN layer 0 within calc_diff 1e-5 of that run's f32 pool rows.
   (c) bench.py --smoke's default QwenNextConfig (batch 4, context 64):
   decode_step on an f32 pool and decode_step_q on bf16 and f32 pools, each
   with lora_indices over the 2 adapters, 12 greedy steps (exact launches:
   K9 at D 32; K1 19 and K8 8 for decode_step_q), a repeat bit-identical,
   step 1 against SKT_IMPL=ref. (d) at Qwen3-Next-80B-A3B's GDN widths:
   causal_conv1d_fn, _varlen, chunk_gated_delta_rule_varlen over 4
   sequences of 37-300 tokens, recurrent_gated_delta_rule with
   num_accepted_tokens and an intermediate state, the [B, dim, S] conv
   update with its windows, conv_state_rollback, move_intermediate_cache
   and the five qkv_fusion functions at its attention widths, each on CUDA
   tensors against the same call on CPU copies; no kernel launched.
20. The last modules of the port (each part timed, with its peak device
   memory). (e) runs after phase 17 on phase 2's weights: MemorySaver's
   pause frees the tracked bytes on the card and resume brings them back,
   bit-equal, one engine prefill and decode call giving the same tokens
   before and after. The rest runs last: (a) models/quant_ref.py's f32
   forwards against the int8 prefill_step on the same tokens, at
   scripts/accuracy_delta.py's two configs (ppl_f32 within 1e-3 of
   ACCURACY.md's CPU-JAX row, every metric printed beside it) and at
   Meta-Llama-3-8B's and bench.py's DeepSeek-V2-Lite widths cut to 2 layers,
   T 512, each within tests/test_accuracy_delta.py's gates (|ppl delta| <=
   2 %, KL mean <= 0.02, MLA 0.05), exact launches of A and K2 (TF32 must
   be off); (b) mla_preprocess's "full" mode bit-equal to "krope_ctkv"'s
   caches and q joined, and "int8_nzcache" through decode_mla_int8_ref
   within calc_diff 1e-3 of K7 over the bf16 caches, at the MLA bench
   widths, batch 128, 256 cached; (c) attention with sinks at
   gpt-oss-120b's widths (64 / 8 heads of 64, window 128 and off), decode
   batch 128 over 4,096 tokens and a 4,096-token prefill in 4 sequences,
   against SDPA with an extra key column that carries the sink; (d) the
   lightning indexer at DeepSeek-V3.2-Exp's widths (64 heads of 128, top
   2048), batched, paged (batch 8, 8,192 cached) and varlen, its top-k sets
   equal to float64's after ties are removed; (f) every compat.py name
   resolves, and each one that reaches a kernel, called once at a small
   shape, launches exactly its kernel and agrees with SKT_IMPL=ref within
   phase 1's bar.
21. The attentions surface at public models' widths, last, B 1, seeded
   inputs (run_attention_widths). Pass 1 sets every count to 0 and drives
   each case once through its entry point and again (bit-identical), held
   to the same call under SKT_IMPL=ref: compat.attentions.la (K17) at
   DeepSeek-V3's MLA prefill (128 heads, D 192, Dv 128, T 4096, causal),
   Qwen3-Next-80B-A3B's attention (16 / 2 heads of 256, T 8192, causal),
   SD3's joint attention (24 heads of 64, T 4429, not causal, bf16 and
   fp16) on the bf16 / fp16 kernel at its own widths, Phi-3-mini (32 heads
   of 96, T 4096, causal, bf16), Phi-2 (32 heads of 80, T 2048, causal,
   fp16) and D 96 at GQA 8 / 2, T 1000 on it padded to its (128, 128) tile,
   Phi-3-mini in f32 and D 32 f32 at T 1000 on the split-TF32 kernel
   (laser_attention_general); compat.attentions.sparse_block_estimate (K18,
   keep 0.25) on (a)'s and (b)'s q and k in blocks of 128, SD3's in fp16 in
   blocks of 64 on padded lengths, Phi-3's in f32 (each on its laser
   case's q and k); and
   topk_block_sparse_attention (K19, 256 blocks of 8 a row, pages of 128,
   row 2 all -1: block 0's mean) at Falcon-7B (71 heads of 64, B 64),
   Gemma-3-1B (4 heads of 256, B 128, bf16 and fp16) and DeepSeek-V3.2-Exp's
   latent rows (128 heads, 576 / 512, B 32). Bars: bf16 one bf16 ulp + 1e-4
   of max|plain|, fp16 one fp16 ulp + 1e-4, f32 2e-5 of max|plain|, K18's
   masks equal or flipped at the threshold. Pass 2 times each kernel alone
   (graph replay), its plain version, SDPA where it takes the shape, and
   the bound (K17 in f32: three TF32 products at the TF32 rate, beside one
   at the CUDA cores' f32 rate; a padded row also at its tile's width), and
   holds K18's scores within 1e-5 of block_scores_ref; then
   a width outside every route (la at D 320, K19 at 96 and in f32) must
   raise, naming the widths it takes, and launch nothing. Each case is a
   row of the kernels line, its launches from pass 1.

Prints the kernels' JSON line, the card's name and power limit, and last the
result line. Any failure raises, and the exit code is not 0. Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ATTN_TOL = 2e-2                # bf16 output rounding + summation order
# K5 and K7 (`_bf16_check`): one bf16 ulp of the plain version's value plus
# this share of max|plain|; K7's math is all f32, K5 rounds p to bf16 (an
# ulp apart at most)
K5_SHARE = 2e-3
K7_SHARE = 1e-4


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2, graph: bool = False) -> float:
    """ms per call of fn by CUDA events, after `warmup` calls. With `graph`
    (the kernels and the library calls), the `iters` calls are captured in
    one CUDA graph whose replays are timed, so that the host's launch time,
    which exceeds a small kernel's, does not count. Without (the plain
    versions, some of which sync the host), the host enqueues `iters`
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = 1
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run, reps = g.replay, 3
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# An empty kernel: timed as the kernels are, its time is the least a launch
# of any kernel takes on the card by graph replay (the launch floor)
LAUNCH_FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void skt_empty_kernel() {}
extern "C" int skt_empty(int blocks, int threads, void* stream) {
  skt_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
# (blocks, threads) of the empty launches: one warp, K20's grid at a decode
# batch of 128 rows of 4096, K6's at phase 6's batch of 128 (two layer
# groups), D's at the decode step's 8 rows (a block a row of each of 32
# layers) and K13's at its bench shape (1,024 blocks of two rows)
LAUNCH_FLOOR_GRIDS = {"one warp": (1, 32), "K20 N 128": (128, 512), "K6 B 128": (256, 256),
                      "D B 8": (256, 64), "K13 2,048 rows": (1024, 256)}


def start_launch_floor_build(build):
    """Start nvcc on the empty kernel, into build/launch_floor/ of this
    checkout; returns (process, library path)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "launch_floor")
    os.makedirs(d, exist_ok=True)
    src, so = os.path.join(d, "empty.cu"), os.path.join(d, "empty.so")
    with open(src, "w") as f:
        f.write(LAUNCH_FLOOR_SRC)
    proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def launch_floor(torch, started) -> dict:
    """{name: ms per launch} of the empty kernel at each of
    LAUNCH_FLOOR_GRIDS, by the graph replay that times the kernels.
    `started`: what start_launch_floor_build returned."""
    proc, so = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the empty kernel failed:\n{log}")
    fn = ctypes.CDLL(so).skt_empty
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    floors = {}
    for name, (blocks, threads) in LAUNCH_FLOOR_GRIDS.items():
        def call(blocks=blocks, threads=threads):
            code = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"the empty kernel: CUDA error {code}")
        floors[name] = _time_ms(call, 50, graph=True)
    print("  launch floor (an empty kernel, graph replay of 50 launches): "
          + ", ".join(f"{name} ({b} x {t}) {floors[name]:.4f} ms"
                      for name, (b, t) in LAUNCH_FLOOR_GRIDS.items())
          + "; folded into no bound")
    return floors


def _warm_up_card(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for a while so that its clocks have ramped up
    before the first kernel is timed."""
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()


def _bound_ms(nbytes: float, ops: float, rate: str):
    """Least time on an H100 (data-sheet rates at 700 W): the larger of the
    bytes over its memory rate and the operations over its `rate` peak."""
    from sgl_kernel_npu_tpu_torch.utils import H100
    t_bytes = nbytes / H100.hbm_bytes_per_s
    t_ops = ops / getattr(H100, rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _int_mm_yardstick(torch, xq, w, xs, ws, m):
    """torch._int_mm + the epilogue (rows padded to 32 below 17, as _int_mm
    asks) on a [K, N] weight; returns (fn, output of the first call)."""
    k = xq.shape[1]
    xp = xq if m > 16 else torch.cat([xq, xq.new_zeros((32 - m, k))])
    sc = xs if m > 16 else torch.cat([xs, xs.new_ones((32 - m, 1))])

    def library():
        acc = torch._int_mm(xp, w)
        return (acc.float() * sc * ws[None]).to(torch.bfloat16)
    return library, library()[:m]


def _calc_diff(a, b):
    x, y = a.double().ravel(), b.double().ravel()
    return 1 - 2 * float((x * y).sum()) / float((x * x).sum() + (y * y).sum())


class _Launches:
    """Counts per kernel between construction and .delta()."""

    def __init__(self, build):
        self._build = build
        self._start = dict(build.launches)

    def delta(self):
        return {k: v - self._start[k] for k, v in self._build.launches.items()}


# ----------------------------------------------------------- kernel checks


# Kernel A's row counts: the engines' decode (8), the bench paths' batch
# (128), the longest prefill chunk (672), and the edges of the stage's plan:
# one row, the last single 16-row tile (16), the first (17) and last (32) of
# two
A_MS = (1, 8, 16, 17, 32, 128, 672)


def a_widths(cfg, mcfg):
    """(name, K, N) of every stacked bank kernel A takes on the main paths:
    Llama-3-8B's four layer GEMMs (phase 2's engine) and DeepSeek-V2-Lite's
    wo, w13 and w2 (phase 5's engine); N = 21,888 ends in half a 256-column
    tile."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    mh, mf = mcfg.hidden_size, mcfg.intermediate_size
    return [("wqkv", h, cfg.q_size + 2 * cfg.kv_size), ("wo", cfg.q_size, h),
            ("w13", h, 2 * f), ("w2", f, h),
            ("mla wo", mcfg.num_heads * mcfg.v_head_dim, mh), ("mla w13", mh, 2 * mf),
            ("mla w2", mf, mh)]


def check_gemm(torch, mm, quant, cfg, mcfg, rng):
    """Kernel A (the int8 stage with one panel, bn = N) exact at every row
    count of A_MS on every bank width of a_widths, bf16 and f32 out, a
    second call bit-identical; every width also at M 256, wqkv at M = 40,
    64, 100, 2048. Timed at
    M = 8 and 128 on Llama-3-8B's four GEMMs (the JSON row: the M 8 sum),
    with the plain version, torch._int_mm + epilogue and the bound."""
    rows = []
    dev = "cuda"
    for name, k, n in a_widths(cfg, mcfg):
        li = 1
        w = torch.randint(-127, 128, (2, k, n), generator=rng, dtype=torch.int8, device=dev)
        ws = torch.rand((2, n), generator=rng, device=dev) * 1e-3
        extra = (40, 64, 100, 256, 2048) if name == "wqkv" else (256,)
        for m in A_MS + extra:
            x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
            xq, xs = quant.per_token_quant_int8(x)
            for od in (torch.float32, torch.bfloat16):    # bf16 last: `ref` below
                out = mm.quant_matmul_int8_stacked(xq, w, li, xs, ws, out_dtype=od)
                again = mm.quant_matmul_int8_stacked(xq, w, li, xs, ws, out_dtype=od)
                ref = mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li], out_dtype=od)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    bad = (out != ref).sum().item()
                    raise AssertionError(f"w8a8_gemm {name} M={m} {od}: {bad} elements "
                                         "differ")
                if not torch.equal(again, out):
                    raise AssertionError(f"w8a8_gemm {name} M={m} {od}: a second call "
                                         "differs")
            if m not in (8, 128) or name.startswith("mla"):
                continue
            ms = _time_ms(lambda: mm.quant_matmul_int8_stacked(xq, w, li, xs, ws), 20, graph=True)
            plain = _time_ms(lambda: mm.quant_matmul_int8_ref(xq, w[li], xs, ws[li]), 3, 1)
            lib = None
            try:
                library, got = _int_mm_yardstick(torch, xq, w[li], xs, ws[li], m)
                if not torch.equal(got, ref):
                    raise AssertionError("torch._int_mm + epilogue disagrees")
                lib = _time_ms(library, 20, graph=True)
            except (RuntimeError, AssertionError) as e:
                print(f"  library yardstick for {name} M={m} unavailable: {e}")
            nbytes = m * k + k * n + 4 * m + 4 * n + 2 * m * n
            bound, by = _bound_ms(nbytes, 2.0 * m * n * k, "int8_ops")
            rows.append(dict(name=name, m=m, k=k, n=n, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bound, bound_by=by,
                             max_abs_err=0.0))
            print(f"  w8a8_gemm {name:8s} M={m:4d} K={k:5d} N={n:6d}: exact; "
                  f"kernel {ms:.4f} ms, plain {plain:.3f} ms, library "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {bound:.4f} ms ({by})")
        del w, ws
    for m in (8, 128):
        r = _sum_rows([r for r in rows if r["m"] == m])
        print(f"  w8a8_gemm wqkv + wo + w13 + w2 M={m}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms")
    print(f"  w8a8_gemm exact at M = {', '.join(map(str, A_MS))} on "
          f"{', '.join(n for n, _, _ in a_widths(cfg, mcfg))} (and 256; wqkv also at 40, "
          "64, 100, 2048), bf16 and f32 out, second calls bit-identical")
    return rows


def _tm_cache(torch, rng, layers, pages, ps, hkv, d):
    shape = (layers, pages, ps * hkv, d)
    kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    ks = torch.rand((layers, pages, 1, ps * hkv), generator=rng, device="cuda") * 0.02
    vs = torch.rand((layers, pages, 1, ps * hkv), generator=rng, device="cuda") * 0.02
    return kc, vc, ks, vs


def _block_tables(torch, rng, lens, mp, pages, ps):
    """Engine-style tables [len(lens), mp]: distinct pages for the tokens of
    each row (lens), pad entries 0."""
    need = [-(-int(n) // ps) for n in lens]
    perm = torch.randperm(pages - 1, generator=rng, device="cuda") + 1
    bt = torch.zeros((len(lens), mp), dtype=torch.int32, device="cuda")
    at = 0
    for i, k in enumerate(need):
        bt[i, :k] = perm[at:at + k]
        at += k
    return bt


def check_decode(torch, dv9, dv8, cfg, rng):
    """Kernel C: 8 sequences, cached lengths 40..700 (page edges included);
    then the per-page contract of decode_v8.py:388 on the same inputs, which
    launches kernel C too. Returns the rows of both."""
    b, hq, hkv, d, ps = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    pages, mp, layers, li = 512, 64, 2, 1
    kc, vc, ks, vs = _tm_cache(torch, rng, layers, pages, ps, hkv, d)
    cached = torch.tensor([40, 127, 128, 129, 255, 384, 511, 700], dtype=torch.int32,
                          device="cuda")
    bt = _block_tables(torch, rng, (cached + 1).tolist(), mp, pages, ps)
    q = torch.randn((b, hq, d), generator=rng, device="cuda").to(torch.bfloat16)
    kn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    vn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    sm = d ** -0.5
    args = (q, kn, vn, kc, vc, ks, vs, cached, bt, sm, ps)
    out = dv9.decode_gqa_v9_int8_defer(*args, layer_idx=li)
    ref = dv9.decode_gqa_v9_int8_defer_ref(*args, layer_idx=li)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"decode_tm max-abs {err} > {ATTN_TOL}")
    ms = _time_ms(lambda: dv9.decode_gqa_v9_int8_defer(*args, layer_idx=li), 50, graph=True)
    plain = _time_ms(lambda: dv9.decode_gqa_v9_int8_defer_ref(*args, layer_idx=li), 5)

    # yardstick: SDPA over the dequantized, gathered cache plus the current token
    n = int(cached.max()) + 1
    kd, ksd = dv9._gather_layer(kc, ks, li, bt, hkv)
    vd, vsd = dv9._gather_layer(vc, vs, li, bt, hkv)
    kf = (kd[:, :, :n].float() * ksd[:, :, :n, None]).to(torch.bfloat16)
    vf = (vd[:, :, :n].float() * vsd[:, :, :n, None]).to(torch.bfloat16)
    idx = cached.long()
    kf[torch.arange(b), :, idx] = kn
    vf[torch.arange(b), :, idx] = vn
    g = hq // hkv
    kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    mask = torch.arange(n, device="cuda")[None, :] <= cached[:, None]
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qs, kf, vf, attn_mask=mask, scale=sm)[:, :, 0]
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    lib = _time_ms(lambda: sdpa(qs, kf, vf, attn_mask=mask, scale=sm), 50, graph=True)

    c = cached.double().sum().item()
    nbytes = (c * hkv * (2 * d + 8) + 2 * (2 * b * hq * d) + 2 * (2 * b * hkv * d)
              + 4 * b + 4 * b * mp)
    ops = 4.0 * (c + b) * hq * d
    bound, by = _bound_ms(nbytes, ops, "bf16_flops")
    print(f"  decode_tm B=8 cached={cached.tolist()}: max-abs {err:.3g}; kernel "
          f"{ms:.4f} ms, plain {plain:.3f} ms, SDPA {lib:.4f} ms (max-abs vs plain "
          f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
    row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
               max_abs_err=err)

    out8 = dv8.decode_gqa_v8_int8_defer(*args, layer_idx=li)
    ref8 = dv8.decode_gqa_v8_int8_defer_ref(*args, layer_idx=li)
    torch.cuda.synchronize()
    err8 = (out8.float() - ref8.float()).abs().max().item()
    if not err8 <= ATTN_TOL:
        raise AssertionError(f"decode_v8 contract (kernel C) max-abs {err8} > {ATTN_TOL}")
    ms8 = _time_ms(lambda: dv8.decode_gqa_v8_int8_defer(*args, layer_idx=li), 50, graph=True)
    plain8 = _time_ms(lambda: dv8.decode_gqa_v8_int8_defer_ref(*args, layer_idx=li), 5)
    print(f"  decode_v8 contract (kernel C vs the per-page plain version), same inputs: "
          f"max-abs {err8:.3g}; kernel {ms8:.4f} ms, plain {plain8:.3f} ms")
    return row, dict(row, ms=ms8, plain_ms=plain8, max_abs_err=err8)


# kernel B's cases (prefix lens, valid lens, T): phase 1's bucket of two
# chunks; the engine's largest call, a 256-token chunk (its token_budget)
# over a 512-token prefix; prefixes off the 64-key tile and an empty chunk
PREFILL_CASES = (((0, 256), (256, 200), 256), ((512,), (256,), 256),
                 ((200, 63, 64, 0), (256, 1, 37, 0), 256))
PREFILL_TIMED = 2          # the first two cases are timed


def check_prefill(torch, pp, cfg, rng):
    """Kernel B at PREFILL_CASES, every row (padded ones too) within ATTN_TOL
    of the plain version, exactly one launch per call. Returns the rows of
    the timed cases."""
    hq, hkv, d, ps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    pages, mp, layers, li = 512, 64, 2, 1
    kc, vc, ks, vs = _tm_cache(torch, rng, layers, pages, ps, hkv, d)
    sm = d ** -0.5
    rows = []
    for n, (plens, vlens, t) in enumerate(PREFILL_CASES):
        # the later cases draw from their own seeds: rng's stream stays as it was
        gen = rng if n == 0 else torch.Generator(device="cuda").manual_seed(400 + n)
        s = len(plens)
        plen = torch.tensor(plens, dtype=torch.int32, device="cuda")
        vlen = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        bt = _block_tables(torch, gen, (plen + vlen).tolist(), mp, pages, ps)
        q = torch.randn((s, t, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        ck = torch.randn((s, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        cv = torch.randn((s, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        args = (q, ck, cv, kc, vc, ks, vs, bt, plen, vlen, sm, ps)
        calls = _Launches(pp._build)
        out = pp.paged_prefill_attention_tm(*args, layer_idx=li)
        launched = {k: v for k, v in calls.delta().items() if v}
        if launched != {"prefill_tm": 1}:
            raise AssertionError(f"prefill_tm call launched {launched}")
        ref = pp.paged_prefill_attention_tm_ref(*args, layer_idx=li)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        label = f"prefill_tm S={s} T={t} prefix={list(plens)} valid={list(vlens)}"
        if not err <= ATTN_TOL:
            raise AssertionError(f"{label}: max-abs {err} > {ATTN_TOL}")
        if n >= PREFILL_TIMED:
            print(f"  {label}: max-abs {err:.3g}, launches prefill_tm 1")
            continue
        ms = _time_ms(lambda: pp.paged_prefill_attention_tm(*args, layer_idx=li), 20,
                      graph=True)
        plain = _time_ms(lambda: pp.paged_prefill_attention_tm_ref(*args, layer_idx=li), 3)

        # yardstick: SDPA over the dequantized prefix + chunk with the same mask
        from sgl_kernel_npu_tpu_torch.ops.attention.decode_v9 import _gather_layer
        npre = int(plen.max())
        kd, ksd = _gather_layer(kc, ks, li, bt, hkv)
        vd, vsd = _gather_layer(vc, vs, li, bt, hkv)
        kf = torch.cat([(kd[:, :, :npre].float() * ksd[:, :, :npre, None]).to(torch.bfloat16),
                        ck.permute(0, 2, 1, 3)], dim=2)
        vf = torch.cat([(vd[:, :, :npre].float() * vsd[:, :, :npre, None]).to(torch.bfloat16),
                        cv.permute(0, 2, 1, 3)], dim=2)
        g = hq // hkv
        kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
        col = torch.arange(npre + t, device="cuda")
        row = torch.arange(t, device="cuda")
        pre = col[None, None, :] < plen[:, None, None]
        chunk = ((col[None, None, :] - npre <= row[None, :, None])
                 & (col[None, None, :] - npre < vlen[:, None, None])
                 & (col[None, None, :] >= npre))
        mask = (pre | chunk)[:, None]
        qs = q.permute(0, 2, 1, 3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = _time_ms(lambda: sdpa(qs, kf, vf, attn_mask=mask, scale=sm), 20, graph=True)

        pairs = sum(int(vlen[i]) * int(plen[i]) + int(vlen[i]) * (int(vlen[i]) + 1) // 2
                    for i in range(s))
        pre_tok = int(plen.sum())
        nbytes = (2 * s * t * hq * d * 2 + 2 * s * t * hkv * d * 2
                  + pre_tok * hkv * (2 * d + 8) + 4 * s * (mp + 2))
        bound, by = _bound_ms(nbytes, 4.0 * pairs * hq * d, "bf16_flops")
        print(f"  {label}: max-abs {err:.3g}, launches prefill_tm 1; kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound {bound:.4f} ms ({by})")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
        del kd, vd, kf, vf, mask
    return rows


# a cold timing cycles its calls over enough sets of buffers that one replay
# of the graph touches more than twice the H100's 50 MB L2, so that no call
# finds its rows left in L2 by the one before, as a model step finds them
COLD_BYTES = 100e6
# D at a prefill chunk: phase 2's first prefill call, the seven prompts of
# _prompts (and one empty sequence) padded to 512 rows each
APPEND_PREFILL_LENS = (40, 127, 129, 255, 384, 511, 300, 0)
APPEND_PREFILL_T = 512


def _cold_ms(torch, make_call, touched, calls=20):
    """ms per call by graph replay with the L2 cold: n sets of buffers
    (make_call(i) -> a call on set i; n = COLD_BYTES over `touched`, the
    bytes one call moves, rounded up), the replayed calls cycling through
    them, at least `calls` of them. Returns (ms, n)."""
    n = max(1, -(-int(COLD_BYTES) // int(touched)))
    sets = [make_call(i) for i in range(n)]
    at = [0]

    def call():
        sets[at[0] % n]()
        at[0] += 1
    return _time_ms(call, n * -(-calls // n), graph=True), n


def append_tm_decode_inputs(torch, gen, cfg, b=8, pages=512):
    """D's inputs at the decode step's shape: kq, vq [L, b, hkv, D] int8,
    b distinct pages of `pages` (the last row padded: sentinel P) and random
    slots, on the card."""
    layers, hkv, d, ps = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    kq, vq = (torch.randint(-127, 128, (layers, b, hkv, d), generator=gen, dtype=torch.int8,
                            device="cuda") for _ in range(2))
    pg = torch.randperm(pages, generator=gen, device="cuda")[:b].to(torch.int32)
    pg[-1] = pages
    off = torch.randint(0, ps, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return kq, vq, pg, off


def append_tm_prefill_inputs(torch, gen, cfg, pages=64):
    """D's inputs at a prefill chunk: APPEND_PREFILL_LENS sequences of
    APPEND_PREFILL_T rows over all layers, each sequence's live rows at
    consecutive slots of its own pages from slot 0, the padded rows at the
    sentinel P. Returns (kq, vq, pages, slots)."""
    layers, hkv, d, ps = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    t, lens = APPEND_PREFILL_T, APPEND_PREFILL_LENS
    b = len(lens) * t
    kq, vq = (torch.randint(-127, 128, (layers, b, hkv, d), generator=gen, dtype=torch.int8,
                            device="cuda") for _ in range(2))
    perm = torch.randperm(pages, generator=gen, device="cuda").tolist()
    pg = torch.full((b,), pages, dtype=torch.int32)
    off = torch.zeros((b,), dtype=torch.int32)
    for si, n in enumerate(lens):
        own, perm = perm[:-(-n // ps)], perm[-(-n // ps):]
        i = torch.arange(n)
        pg[si * t:si * t + n] = torch.tensor(own, dtype=torch.int32)[i // ps]
        off[si * t:si * t + n] = (i % ps).to(torch.int32)
    return kq, vq, pg.cuda(), off.cuda()


def _append_tm_case(torch, dv8, cfg, label, kq, vq, pg, off, pages, make_set):
    """D on one shape: exact against its plain version and index_copy_ x2 on
    caches of 0x7f bytes, a second call bit-identical; timed warm, cold
    (make_set(i) -> the inputs of set i) and beside its yardsticks."""
    layers, b, hkv, d = kq.shape
    ps = cfg.page_size
    shape = (layers, pages, ps * hkv, d)
    dirty = _DirtyEmpty(torch)
    kc, vc = dirty.empty(shape, dtype=torch.int8, device="cuda"), \
        dirty.empty(shape, dtype=torch.int8, device="cuda")
    kc2, vc2 = kc.clone(), vc.clone()
    for _ in range(2):
        dv8.append_tm_int8(kq, vq, kc, vc, pg, off)
        dv8.append_tm_int8_ref(kq, vq, kc2, vc2, pg, off)
        torch.cuda.synchronize()
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise AssertionError(f"append_tm {label} differs from its plain version")
    live = (pg >= 0) & (pg < pages)
    slots = (pg[live].long() * ps + off[live].long())
    kv3, vv3 = kc2.view(layers, pages * ps, hkv * d), vc2.view(layers, pages * ps, hkv * d)
    ksrc = kq[:, live].reshape(layers, -1, hkv * d)
    vsrc = vq[:, live].reshape(layers, -1, hkv * d)

    def library():
        kv3.index_copy_(1, slots, ksrc)
        vv3.index_copy_(1, slots, vsrc)
    library()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError(f"append_tm {label}: the index_copy_ yardstick disagrees")
    ms = _time_ms(lambda: dv8.append_tm_int8(kq, vq, kc, vc, pg, off), 20, graph=True)
    nrow = int(live.sum())
    nbytes = 2 * 2 * layers * nrow * hkv * d + 8 * b

    def make_call(i):
        a = make_set(i) if i else (kq, vq, pg, off)
        return lambda: dv8.append_tm_int8(a[0], a[1], kc, vc, a[2], a[3])
    cold, nset = _cold_ms(torch, make_call, nbytes)
    plain = _time_ms(lambda: dv8.append_tm_int8_ref(kq, vq, kc2, vc2, pg, off), 5)
    lib = _time_ms(library, 20, graph=True)
    bound, by = _bound_ms(nbytes, 0.0, "bf16_flops")
    print(f"  append_tm {label} L={layers} B={b} ({nrow} live): exact on 0x7f caches; kernel "
          f"{ms:.4f} ms warm, {cold:.4f} cold ({nset} sets, {nset * nbytes / 1e6:.0f} MB a "
          f"cycle), plain {plain:.3f} ms, index_copy_ x2 {lib:.4f} ms, bound {bound:.5f} ms "
          f"({by}; {bound / cold:.2f} of it cold)")
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by,
                max_abs_err=0.0)


def check_append(torch, dv8, cfg, rng, floor):
    """Kernel D at the decode step's shape (all 32 layers, 8 rows, one
    padded) and at a prefill chunk's (APPEND_PREFILL_LENS), each row timed
    warm (ms) and cold (cold_ms). `floor`: the card's launch floor at D's
    decode grid, in ms, printed beside it. Returns (decode row, prefill
    row)."""
    pages = 512
    kq, vq, pg, off = append_tm_decode_inputs(torch, rng, cfg, pages=pages)
    dec = _append_tm_case(torch, dv8, cfg, "decode", kq, vq, pg, off, pages,
                          lambda i: append_tm_decode_inputs(torch, rng, cfg, pages=pages))
    print(f"  (launch floor at D's decode grid {floor:.4f} ms)")
    del kq, vq
    torch.cuda.empty_cache()
    kq, vq, pg, off = append_tm_prefill_inputs(torch, rng, cfg)
    pre = _append_tm_case(torch, dv8, cfg, "prefill", kq, vq, pg, off, 64,
                          lambda i: (kq, vq, pg, off))
    return dec, pre


def compare_split_policy(torch, mm, quant, cfg, rng):
    """Kernel A at M = 8, 128 and 256, where the stage's plan
    (matmul.gemm_plan) splits K, timed with that split and unsplit, in turns
    (split, unsplit, unsplit, split); both give the same output."""
    from unittest import mock
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = [("wqkv", h, cfg.q_size + 2 * cfg.kv_size), ("wo", cfg.q_size, h),
              ("w13", h, 2 * f), ("w2", f, h)]
    real = mm.gemm_plan

    def unsplit(*a):
        return real(*a)[:3] + (1,)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (8, 128, 256):
        for name, k, n in shapes:
            splits = real(m, n, k, sms)[3]
            if splits == 1:
                continue
            w = torch.randint(-127, 128, (1, k, n), generator=rng, dtype=torch.int8,
                              device="cuda")
            ws = torch.rand((1, n), generator=rng, device="cuda") * 1e-3
            x = torch.randn((m, k), generator=rng, device="cuda").to(torch.bfloat16)
            xq, xs = quant.per_token_quant_int8(x)

            def run():
                return mm.quant_matmul_int8_stacked(xq, w, 0, xs, ws)
            split = run()
            with mock.patch.object(mm, "gemm_plan", unsplit):
                if not torch.equal(run(), split):
                    raise AssertionError(f"w8a8_gemm {name} M={m}: split-K changed the output")
            times = {"split": [], "unsplit": []}
            for mode in ("split", "unsplit", "unsplit", "split"):
                if mode == "split":
                    times[mode].append(_time_ms(run, 20, graph=True))
                else:
                    with mock.patch.object(mm, "gemm_plan", unsplit):
                        times[mode].append(_time_ms(run, 20, graph=True))
            t = {k: sum(v) / len(v) for k, v in times.items()}
            print(f"  w8a8_gemm {name:5s} M={m} K={k:5d} N={n:6d}: split-K x{splits} "
                  f"{t['split']:.4f} ms, unsplit {t['unsplit']:.4f} ms")
            del w, ws


# K1's row counts: the engines' decode (8), the bench paths' batch (128), a
# prefill chunk (672), and the edges of its plan: one row, the last single
# 16-row tile (16), two of them (17), a partial 128-row tile (100) and a
# second 128-row tile of one row (129)
K1_MS = (1, 8, 16, 17, 100, 128, 129, 672)
# 256-column tiles that straddle panels (bn 128, 384), DeepSeek's panels of
# 1024, and the shortest K the kernel takes (64, under one 128-byte stage):
# (name, K, N, bn)
K1_PANELS = (("bn128", 4096, 2048, 128), ("bn384", 4096, 3072, 384),
             ("bn1024", 2048, 3072, 1024), ("K64", 64, 256, 128))


def check_gemm_tiled(torch, mm, quant, cfg, rng, bn=512):
    """Kernel K1, exact at every row count of K1_MS, bf16 and f32 out, with
    a second call bit-identical: on the bench path's banks (wo and w2
    pretiled at 512, lm_head at 768) and on the panel widths of K1_PANELS.
    Timed at M 128 (the JSON row: wo + w2 + lm_head, with the plain version
    and torch._int_mm + epilogue), and at M 8 and 672."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = [("wo", cfg.q_size, h, 2, bn), ("w2", f, h, 2, bn), ("lm_head", h, v, 1, 768)]
    shapes += [(name, k, n, 2, pbn) for name, k, n, pbn in K1_PANELS]
    rows, dev, other = [], "cuda", []
    for name, k, n, layers, pbn in shapes:
        li = layers - 1
        w = torch.randint(-127, 128, (layers, k, n), generator=rng, dtype=torch.int8,
                          device=dev)
        ws = torch.rand((layers, n), generator=rng, device=dev) * 1e-3
        wt = mm.pretile_weight_bank(w, pbn)
        for m in K1_MS:
            x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
            xq, xs = quant.per_token_quant_int8(x)
            for od in (torch.float32, torch.bfloat16):    # bf16 last: `ref` below
                out = mm.quant_matmul_int8_stacked(xq, wt, li, xs, ws, out_dtype=od)
                again = mm.quant_matmul_int8_stacked(xq, wt, li, xs, ws, out_dtype=od)
                ref = mm.quant_matmul_int8_stacked_tiled_ref(xq, wt, li, xs, ws, out_dtype=od)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    bad = (out != ref).sum().item()
                    raise AssertionError(f"w8a8_gemm_tiled {name} M={m} {od}: {bad} elements "
                                         "differ")
                if not torch.equal(again, out):
                    raise AssertionError(f"w8a8_gemm_tiled {name} M={m} {od}: a second call "
                                         "differs")
            if pbn not in (bn, 768) or m not in (8, 128, 672):
                continue

            def kernel():
                return mm.quant_matmul_int8_stacked(xq, wt, li, xs, ws)
            ms = _time_ms(kernel, 20, graph=True)
            if m != 128:
                other.append(f"{name} M {m} {ms:.4f}")
                continue
            plain = _time_ms(lambda: mm.quant_matmul_int8_stacked_tiled_ref(
                xq, wt, li, xs, ws), 3, 1)
            library, got = _int_mm_yardstick(torch, xq, w[li], xs, ws[li], m)
            if not torch.equal(got, ref):
                raise AssertionError("torch._int_mm + epilogue disagrees")
            lib = _time_ms(library, 20, graph=True)
            nbytes = m * k + k * n + 4 * m + 4 * n + 2 * m * n
            bound, by = _bound_ms(nbytes, 2.0 * m * n * k, "int8_ops")
            rows.append(dict(name=name, m=m, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by))
            print(f"  w8a8_gemm_tiled {name:8s} M={m} K={k:5d} N={n:6d} bn={pbn}: exact; "
                  f"kernel {ms:.4f} ms, plain {plain:.3f} ms, _int_mm {lib:.4f} ms, "
                  f"bound {bound:.4f} ms ({by})")
        del w, ws, wt
    print(f"  w8a8_gemm_tiled exact at M = {', '.join(map(str, K1_MS))} on wo, w2, lm_head, "
          f"at bn 128, 384, 1024 and at K 64, bf16 and f32 out, second calls bit-identical; "
          f"kernel ms "
          + ", ".join(other))
    return _sum_rows(rows)


def _sum_rows(rows):
    """One JSON row for a kernel timed at several shapes: the sums."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)
    return dict(ms=total("ms"), plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                bound_ms=total("bound_ms"),
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations", max_abs_err=max(r.get("max_abs_err", 0.0) for r in rows))


def check_rmsq(torch, mm, rq, quant, cfg, rng, bn=512):
    """Kernel K2 at the bench path's shapes (M = 128, pretiled 512-wide
    banks): wqkv and w13, bf16 gamma, zero beta, bf16 out. Flip-aware:
    every element within 4 quant flips of its row (max|w| * max w_scale *
    max row scale each), and >= 99% of rows bit-exact."""
    h, f, m = cfg.hidden_size, cfg.intermediate_size, 128
    shapes = [("wqkv", h, cfg.q_size + 2 * cfg.kv_size), ("w13", h, 2 * f)]
    rows, dev = [], "cuda"
    for name, k, n in shapes:
        w = torch.randint(-127, 128, (2, k, n), generator=rng, dtype=torch.int8, device=dev)
        ws = torch.rand((2, n), generator=rng, device=dev) * 1e-3
        wt = mm.pretile_weight_bank(w, bn)
        x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
        gamma = (1 + 0.1 * torch.randn((k,), generator=rng, device=dev)).to(torch.bfloat16)
        beta = torch.zeros((k,), device=dev)
        kw = dict(li=1, quant_mode="per_token", eps=cfg.rms_eps, out_dtype=torch.bfloat16)
        out = rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw)
        ref = rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, ws, **kw)
        torch.cuda.synchronize()
        _, scale = rq._row_stats(x, gamma, beta, True, cfg.rms_eps)
        flip = float(w[1].abs().max()) * float(ws[1].max()) * float(scale.max())
        a, b = out.double(), ref.double()
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 1e-3 * b.abs() + 4 * flip).all()):
            raise AssertionError(f"rmsq_gemm {name}: max-abs {err} beyond 4 flips ({flip})")
        exact = float(torch.isclose(a, b, rtol=1e-6, atol=1e-6).all(dim=-1).double().mean())
        if exact < 0.99:
            raise AssertionError(f"rmsq_gemm {name}: only {exact:.4f} of rows exact")
        ms = _time_ms(lambda: rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw), 20, graph=True)
        plain = _time_ms(lambda: rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, ws, **kw), 3, 1)
        # yardstick: the GEMM part alone, torch._int_mm on the plain quant
        rstd, _ = rq._row_stats(x, gamma, beta, True, cfg.rms_eps)
        xq = torch.round((x.float() * rstd * gamma.float()[None] + beta[None]) / scale) \
            .clamp(-128, 127).to(torch.int8)
        library, _ = _int_mm_yardstick(torch, xq, w[1], scale, ws[1], m)
        lib = _time_ms(library, 20, graph=True)
        nbytes = 2 * m * k + k * n + 4 * n + 8 * k + 2 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * n * k, "int8_ops")
        rows.append(dict(name=name, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by, max_abs_err=err))
        print(f"  rmsq_gemm {name:5s} M={m} K={k} N={n:6d} bn={bn}: {exact:.4f} of rows "
              f"exact, max-abs {err:.3g} (one flip {flip:.3g}); kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, _int_mm (GEMM part only) {lib:.4f} ms, bound {bound:.4f} ms "
              f"({by})")
        del w, ws, wt
    return _sum_rows(rows)


def check_decode_tm2(torch, dv11, dv13, cfg, rng):
    """Kernel K3 at the bench path's widths (128 sequences, 8 kv heads of 4
    query heads, D = 128, 512-token pages) in two shapes: 2 pages each with
    cached lengths over 0..1023 (0, 1, 511, 512 and 513 among them), and
    phase 4's, one page each with 256..383 cached. Within ATTN_TOL of the
    plain version, a second call bit-identical. decode_v13's name is
    decode_v11's wrapper. Returns the two shapes' rows."""
    b, hq, hkv, d, ps, layers, li = 128, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, 512, 2, 1
    rows = []
    for label, mp in (("0..1023 over 2 pages", 2), ("phase 4: 256..383, one page", 1)):
        pages = b * mp + 1
        shape = (layers, pages, hkv, ps, d)
        kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
        vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
        ks = torch.rand(shape[:-1], generator=rng, device="cuda") * 0.02 + 0.001
        vs = torch.rand(shape[:-1], generator=rng, device="cuda") * 0.02 + 0.001
        if mp == 2:
            cached = torch.randint(0, mp * ps, (b,), generator=rng, device="cuda",
                                   dtype=torch.int32)
            cached[:5] = torch.tensor([0, 1, 511, 512, 513], dtype=torch.int32)
        else:
            cached = torch.randint(256, 384, (b,), generator=rng, device="cuda",
                                   dtype=torch.int32)
        bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        q = torch.randn((b, hq, d), generator=rng, device="cuda").to(torch.bfloat16)
        kn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
        vn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
        sm = d ** -0.5
        args = (q, kn, vn, kc, vc, ks, vs, cached, bt, sm, ps)
        ref = dv11.decode_gqa_v11_int8_defer_ref(*args, layer_idx=li)
        out = dv13.decode_gqa_v13_int8_defer(*args, layer_idx=li)
        again = dv13.decode_gqa_v13_int8_defer(*args, layer_idx=li)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"decode_tm2 ({label}) max-abs {err} > {ATTN_TOL}")
        if not torch.equal(again, out):
            raise AssertionError(f"decode_tm2 ({label}): a second call differs")
        ms = _time_ms(lambda: dv13.decode_gqa_v13_int8_defer(*args, layer_idx=li), 50,
                      graph=True)
        plain = _time_ms(lambda: dv11.decode_gqa_v11_int8_defer_ref(*args, layer_idx=li), 5)

        # yardstick: SDPA over the dequantized, gathered cache plus the current token
        n = mp * ps + 1
        kd, ksd = dv11._gather_layer_tm2(kc, ks, li, bt)
        vd, vsd = dv11._gather_layer_tm2(vc, vs, li, bt)
        pad = torch.zeros((b, hkv, 1, d), dtype=torch.bfloat16, device="cuda")
        kf = torch.cat([(kd.float() * ksd[..., None]).to(torch.bfloat16), pad], 2)
        vf = torch.cat([(vd.float() * vsd[..., None]).to(torch.bfloat16), pad], 2)
        idx = cached.long()
        kf[torch.arange(b), :, idx] = kn
        vf[torch.arange(b), :, idx] = vn
        g = hq // hkv
        kf, vf = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
        mask = (torch.arange(n, device="cuda")[None, :] <= cached[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = (sdpa(qs, kf, vf, attn_mask=mask, scale=sm)[:, :, 0].float()
                   - ref.float()).abs().max().item()
        lib = _time_ms(lambda: sdpa(qs, kf, vf, attn_mask=mask, scale=sm), 20, graph=True)
        del kf, vf, kc, vc

        c = cached.double().sum().item()
        nbytes = (c * hkv * (2 * d + 8) + 2 * (2 * b * hq * d) + 2 * (2 * b * hkv * d)
                  + 4 * b + 4 * b * mp)
        bound, by = _bound_ms(nbytes, 4.0 * (c + b) * hq * d, "bf16_flops")
        print(f"  decode_tm2 (v13 = v11) B={b} MP={mp} ps={ps} cached {label} (sum "
              f"{int(c)}): max-abs {err:.3g}, second call identical; kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, SDPA {lib:.4f} ms (max-abs vs plain {lib_err:.3g}), "
              f"bound {bound:.4f} ms ({by})")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
    return rows


def check_decode_tm2_edges(torch, dv11):
    """Kernel K3 where its page steps and kept scores meet their edges: one,
    two, four and eight query heads a kv head (mma's n of 8), pages of 16,
    100 (not a power of 2) and 512 tokens, and cached 0, 1, ps - 1, ps,
    ps + 1 and 2 ps + 3 over a block table of 4 pages; within ATTN_TOL of
    the plain version, a second call bit-identical."""
    rng = torch.Generator(device="cuda")
    rng.manual_seed(600)
    hkv, d, layers, li, mp = 2, 128, 2, 1, 4
    for ps in (16, 100, 512):
        lens = [0, 1, ps - 1, ps, ps + 1, 2 * ps + 3]
        b = len(lens)
        pages = b * mp + 1
        shape = (layers, pages, hkv, ps, d)
        kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
        vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
        ks = torch.rand(shape[:-1], generator=rng, device="cuda") * 0.02 + 0.001
        vs = torch.rand(shape[:-1], generator=rng, device="cuda") * 0.02 + 0.001
        cached = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        kn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
        vn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
        errs = []
        for g in (1, 2, 4, 8):
            q = torch.randn((b, hkv * g, d), generator=rng, device="cuda").to(torch.bfloat16)
            args = (q, kn, vn, kc, vc, ks, vs, cached, bt, d ** -0.5, ps)
            out = dv11.decode_gqa_v11_int8_defer(*args, layer_idx=li)
            again = dv11.decode_gqa_v11_int8_defer(*args, layer_idx=li)
            ref = dv11.decode_gqa_v11_int8_defer_ref(*args, layer_idx=li)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= ATTN_TOL:
                raise AssertionError(f"decode_tm2 edges ps {ps} G {g}: max-abs {err} > "
                                     f"{ATTN_TOL}")
            if not torch.equal(out, again):
                raise AssertionError(f"decode_tm2 edges ps {ps} G {g}: a second call differs")
            errs.append(f"G {g} {err:.3g}")
        print(f"  decode_tm2 edges ps={ps} MP={mp} cached {lens}: max-abs {', '.join(errs)}; "
              f"second calls bit-identical")
        del kc, vc


def check_append_tm2(torch, dv11, cfg, rng):
    """Kernel K4 at the bench path's shape: 32 layers x 128 rows (one padded)
    into 129 pages of 512 tokens; timed warm (ms) and cold (cold_ms)."""
    layers, b, hkv, d, ps = cfg.num_layers, 128, cfg.num_kv_heads, cfg.head_dim, 512
    pages = b + 1
    kq = torch.randint(-127, 128, (layers, b, hkv, d), generator=rng, dtype=torch.int8,
                       device="cuda")
    vq = torch.randint(-127, 128, (layers, b, hkv, d), generator=rng, dtype=torch.int8,
                       device="cuda")
    pg = (torch.randperm(pages - 1, generator=rng, device="cuda")[:b] + 1).to(torch.int32)
    pg[-1] = pages                                    # a padded row: sentinel P
    off = torch.randint(0, ps, (b,), generator=rng, device="cuda", dtype=torch.int32)
    shape = (layers, pages, hkv, ps, d)
    kc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    vc = torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    kc2, vc2 = kc.clone(), vc.clone()
    dv11.append_tm2_int8(kq, vq, kc, vc, pg, off)
    dv11.append_tm2_int8_ref(kq, vq, kc2, vc2, pg, off)
    torch.cuda.synchronize()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError("append_tm2 differs from its plain version")
    ms = _time_ms(lambda: dv11.append_tm2_int8(kq, vq, kc, vc, pg, off), 50, graph=True)
    plain = _time_ms(lambda: dv11.append_tm2_int8_ref(kq, vq, kc2, vc2, pg, off), 10)
    live = pg < pages
    idx = (pg[live].long(), off[live].long())
    ksrc = kq[:, live].permute(1, 0, 2, 3).contiguous()
    vsrc = vq[:, live].permute(1, 0, 2, 3).contiguous()
    kv5, vv5 = kc2.permute(1, 3, 0, 2, 4), vc2.permute(1, 3, 0, 2, 4)

    def library():
        kv5.index_put_(idx, ksrc)
        vv5.index_put_(idx, vsrc)
    library()
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError("index_put_ yardstick disagrees")
    lib = _time_ms(library, 50, graph=True)
    nrow = int(live.sum())
    nbytes = 2 * 2 * layers * nrow * hkv * d + 8 * b

    def make_call(i):
        if not i:
            return lambda: dv11.append_tm2_int8(kq, vq, kc, vc, pg, off)
        a = [torch.randint(-127, 128, kq.shape, generator=rng, dtype=torch.int8, device="cuda")
             for _ in range(2)]
        p = (torch.randperm(pages - 1, generator=rng, device="cuda")[:b] + 1).to(torch.int32)
        p[-1] = pages
        o = torch.randint(0, ps, (b,), generator=rng, device="cuda", dtype=torch.int32)
        return lambda: dv11.append_tm2_int8(a[0], a[1], kc, vc, p, o)
    cold, nset = _cold_ms(torch, make_call, nbytes)
    bound, by = _bound_ms(nbytes, 0.0, "bf16_flops")
    print(f"  append_tm2 L={layers} B={b} (1 padded): exact; kernel {ms:.4f} ms warm, "
          f"{cold:.4f} cold ({nset} sets, {nset * nbytes / 1e6:.0f} MB a cycle), plain "
          f"{plain:.3f} ms, index_put_ x2 {lib:.4f} ms, bound {bound:.5f} ms ({by}; "
          f"{bound / cold:.2f} of it cold)")
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by,
                max_abs_err=0.0)


def check_matmul_l1(torch, mm, quant, cfg, mcfg, rng):
    """The contract of matmul.py:71 (kernel A on a plain [K, N] weight, a
    one-layer view): Llama-3-8B's and DeepSeek-V2-Lite's lm_head, exact at
    M = 1, 8, 16, 17, 128 (the engines' decode and the MLA bench path's
    batch) and 256, bf16 and f32 out, a second call bit-identical; timed at
    the serving path's M = 8 on Llama's."""
    for name, k, n in (("lm_head", cfg.hidden_size, cfg.vocab_size),
                       ("mla lm_head", mcfg.hidden_size, mcfg.vocab_size)):
        w = torch.randint(-127, 128, (k, n), generator=rng, dtype=torch.int8, device="cuda")
        ws = torch.rand((n,), generator=rng, device="cuda") * 1e-3
        for m in (1, 16, 17, 128, 256, 8):                # M 8 last: timed below
            x = torch.randn((m, k), generator=rng, device="cuda").to(torch.bfloat16)
            xq, xs = quant.per_token_quant_int8(x)
            for od in (torch.float32, torch.bfloat16):    # bf16 last: `ref` below
                out = mm.quant_matmul_int8(xq, w, xs, ws, out_dtype=od)
                again = mm.quant_matmul_int8(xq, w, xs, ws, out_dtype=od)
                ref = mm.quant_matmul_int8_ref(xq, w, xs, ws, out_dtype=od)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"quant_matmul_int8 (L = 1) {name} M={m} {od} "
                                         "differs from its plain version")
                if not torch.equal(again, out):
                    raise AssertionError(f"quant_matmul_int8 (L = 1) {name} M={m} {od}: a "
                                         "second call differs")
        if name == "lm_head":
            keep = (w, ws, xq, xs, ref, m, k, n)
        else:
            del w, ws
    print("  quant_matmul_int8 (kernel A, L = 1) exact at M = 1, 8, 16, 17, 128, 256 on "
          "both lm_heads, bf16 and f32 out, second calls bit-identical")
    w, ws, xq, xs, ref, m, k, n = keep
    ms = _time_ms(lambda: mm.quant_matmul_int8(xq, w, xs, ws), 20, graph=True)
    plain = _time_ms(lambda: mm.quant_matmul_int8_ref(xq, w, xs, ws), 3, 1)
    library, got = _int_mm_yardstick(torch, xq, w, xs, ws, m)
    if not torch.equal(got, ref):
        raise AssertionError("torch._int_mm + epilogue disagrees")
    lib = _time_ms(library, 20, graph=True)
    bound, by = _bound_ms(m * k + k * n + 4 * m + 4 * n + 2 * m * n, 2.0 * m * n * k,
                          "int8_ops")
    print(f"  quant_matmul_int8 (kernel A, L = 1) lm_head M={m}: exact; kernel {ms:.4f} ms, "
          f"plain {plain:.3f} ms, _int_mm {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=0.0)


# ------------------------------------------------------ the MLA kernels


def _flip_check(name, out, ref, flip):
    """K2's bar: every element within 4 quant flips of its row, and >= 99% of
    rows bit-exact. Returns (max-abs error, exact fraction of rows)."""
    import torch
    a, b = out.double(), ref.double()
    err = float((a - b).abs().max())
    if not bool(((a - b).abs() <= 1e-3 * b.abs() + 4 * flip).all()):
        raise AssertionError(f"{name}: max-abs {err} beyond 4 flips ({flip})")
    exact = float(torch.isclose(a, b, rtol=1e-6, atol=1e-6).all(dim=-1).double().mean())
    if exact < 0.99:
        raise AssertionError(f"{name}: only {exact:.4f} of rows exact")
    return err, exact


def check_rmsq_pt(torch, mm, rq, mcfg, rng):
    """K2 in its per_tensor mode (static scale and offset, int32 bias, fp16
    rounding) at the MLA path's shapes: wdqkv (bf16 x) and wuq (an f32 column
    slice of stage 1's output) at M = 128 on banks pretiled to 1024-wide
    panels (N padded as pretile_mla_weights pads it), and wdqkv on a plain
    [K, N] weight at M = 8 (the engine's decode) and at M = 128 (its N
    unpadded, beside the pretiled bank). Returns the sum of the two bench
    rows and the M = 8 row."""
    h, mm1 = mcfg.hidden_size, mcfg.mm1_out
    c = mcfg.kv_lora_rank + mcfg.qk_rope_dim
    qdim = mcfg.num_heads * (mcfg.qk_nope_dim + mcfg.qk_rope_dim)
    cases = [("wdqkv", 128, h, mm1, 1024, "bf16"), ("wuq", 128, mcfg.q_lora_rank, qdim, 1024,
                                                      "f32 slice"),
             ("wdqkv plain", 8, h, mm1, None, "bf16"),
             ("wdqkv plain", 128, h, mm1, None, "bf16")]
    rows, dev = [], "cuda"
    for name, m, k, n, bn, xkind in cases:
        n_pad = -(-n // bn) * bn if bn else n
        w = torch.zeros((2, k, n_pad), dtype=torch.int8, device=dev)
        w[..., :n] = torch.randint(-127, 128, (2, k, n), generator=rng, dtype=torch.int8,
                                   device=dev)
        ds = torch.rand((2, n_pad), generator=rng, device=dev) * 1e-3
        bias = torch.randint(-50, 50, (2, n_pad), generator=rng, dtype=torch.int32,
                             device=dev)
        if xkind == "f32 slice":
            wide = torch.randn((m, 2 * c + k), generator=rng, device=dev)
            x = wide[:, c:c + k]
        else:
            x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
        gamma = (1 + 0.1 * torch.randn((k,), generator=rng, device=dev))
        beta = 0.05 * torch.randn((k,), generator=rng, device=dev)
        qs = torch.tensor([0.05], device=dev)
        qo = torch.tensor([0.5], device=dev)
        if bn:
            wt, dsl, bl, li = mm.pretile_weight_bank(w, bn), ds, bias, 1
        else:
            wt, dsl, bl, li = w[1], ds[1], bias[1], None
        kw = dict(li=li, quant_mode="per_tensor", eps=mcfg.rms_eps, quant_cast="fp16")
        out = rq.rmsnorm_quant_gemm(x, gamma, beta, wt, dsl, bl, qs, qo, **kw)
        ref = rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, dsl, bl, qs, qo, **kw)
        torch.cuda.synchronize()
        flip = float(w[1].abs().max()) * float(ds[1].max())
        err, exact = _flip_check(f"rmsq_gemm per_tensor {name}", out, ref, flip)
        ms = _time_ms(lambda: rq.rmsnorm_quant_gemm(x, gamma, beta, wt, dsl, bl, qs, qo,
                                                    **kw), 20, graph=True)
        plain = _time_ms(lambda: rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, dsl, bl, qs,
                                                           qo, **kw), 3, 1)
        # yardstick: the GEMM part alone, torch._int_mm on the plain quant + epilogue
        rstd = rq._rstd(x, True, mcfg.rms_eps)
        xq = torch.round(((x.float() * rstd * gamma[None] + beta[None]) / qs + qo)
                         .to(torch.float16).float()).clamp(-128, 127).to(torch.int8)
        xp = xq if m > 16 else torch.cat([xq, xq.new_zeros((32 - m, k))])
        wn, bn_, dn = w[1][:, :n].contiguous(), bias[1][:n], ds[1][:n]

        def library():
            return ((torch._int_mm(xp, wn) + bn_).float() * dn).to(torch.float32)
        lib = _time_ms(library, 20, graph=True)

        def bound_at(nn):
            nbytes = x.element_size() * m * k + k * nn + 4 * nn * 2 + 8 * k + 4 * m * nn
            return _bound_ms(nbytes, 2.0 * m * nn * k, "int8_ops")
        # the bound counts the N the model needs; the panels' zero columns
        # are a cost of the layout, printed apart
        bound, by = bound_at(n)
        pad = f", bound at the padded N {bound_at(n_pad)[0]:.4f} ms" if n_pad != n else ""
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
        print(f"  rmsq_gemm per_tensor {name:11s} M={m:3d} K={k} N={n} (stored {n_pad}, "
              f"{'bn ' + str(bn) if bn else 'plain'}, x {xkind}): {exact:.4f} of rows exact, "
              f"max-abs {err:.3g} (one flip {flip:.3g}); kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, _int_mm (GEMM part only, N {n}) {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}){pad}")
        del w, wt
    return _sum_rows(rows[:2]), rows[2]


# K2's plan edges: (M, K, N, bank panel width or None for a plain weight,
# mode, x): one row; M 17 over 128-wide panels; a ragged N and K % 128 == 64
# on an f32 column slice; two row tiles over split K; K of one stage
K2_EDGES = ((1, 256, 384, None, "per_token", "bf16"), (17, 512, 640, 128, "per_tensor", "bf16"),
            (200, 1088, 2112, None, "per_tensor", "f32 slice"),
            (256, 2048, 3072, 1024, "per_token", "bf16"), (8, 64, 16, None, "per_tensor", "bf16"))


def check_rmsq_edges(torch, mm, rq):
    """K2 at the edges of its plan (ops/matmul.py::gemm_plan): both
    loops (mma.sync at M <= 16, wgmma above), partial row and column tiles,
    a half K stage, split and unsplit K; each within K2's flip bar, a second
    call bit-identical."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    notes = []
    for m, k, n, bn, mode, xkind in K2_EDGES:
        pt = mode == "per_tensor"
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        bias = (torch.randint(-50, 50, (2, n), generator=gen, dtype=torch.int32, device="cuda")
                if pt else None)
        if xkind == "f32 slice":
            x = torch.randn((m, k + 96), generator=gen, device="cuda")[:, 32:32 + k]
        else:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        g = 1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
        b = 0.05 * torch.randn((k,), generator=gen, device="cuda")
        if bn:
            wt, dsl, bl, li = mm.pretile_weight_bank(w, bn), ws, bias, 1
        else:
            wt, dsl, bl, li = w[1], ws[1], None if bias is None else bias[1], None
        qs = torch.tensor([0.05], device="cuda") if pt else None
        qo = torch.tensor([0.5], device="cuda") if pt else None
        kw = dict(li=li, quant_mode=mode, quant_cast="fp16" if pt else "f32")
        out = rq.rmsnorm_quant_gemm(x, g, b, wt, dsl, bl, qs, qo, **kw)
        ref = rq.rmsnorm_quant_gemm_ref(x, g, b, wt, dsl, bl, qs, qo, **kw)
        torch.cuda.synchronize()
        scale = 1.0 if pt else float(rq._row_stats(x, g, b, True, 1e-6)[1].max())
        label = f"rmsq_gemm M={m} K={k} N={n}"
        _flip_check(label, out, ref, float(w[1].abs().max()) * float(ws[1].max()) * scale)
        if not torch.equal(rq.rmsnorm_quant_gemm(x, g, b, wt, dsl, bl, qs, qo, **kw), out):
            raise AssertionError(f"{label}: a second call differs")
        bm, tm, tn, splits = mm.gemm_plan(m, n, k, sms)
        notes.append(f"M {m} K {k} N {n} ({'plain' if bn is None else f'bn {bn}'}, {mode}, "
                     f"x {xkind}; tiles {tm} x {tn} of {bm} rows, K split {splits})")
    print("  rmsq_gemm edges within the flip bar, a second call bit-identical: "
          + "; ".join(notes))


def _k2_case(torch, mm, rq, rng, name, m, k, n, bn, apply_norm, out_dtype, eps):
    """K2 per_token on a pretiled one-layer-of-two bank at one shape, against
    its plain version (_flip_check), timed with its plain version, torch._int_mm
    plus the epilogue on the same int8 rows, and its byte / operation bound."""
    dev = "cuda"
    layers = 2
    w = torch.randint(-127, 128, (layers, k, n), generator=rng, dtype=torch.int8, device=dev)
    ws = torch.rand((layers, n), generator=rng, device=dev) * 1e-3
    wt = mm.pretile_weight_bank(w, bn)
    x = torch.randn((m, k), generator=rng, device=dev).to(torch.bfloat16)
    gamma = ((1 + 0.1 * torch.randn((k,), generator=rng, device=dev)).to(torch.bfloat16)
             if apply_norm else torch.ones((k,), device=dev))
    beta = torch.zeros((k,), device=dev)
    kw = dict(li=1, quant_mode="per_token", apply_norm=apply_norm, eps=eps, out_dtype=out_dtype)
    out = rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw)
    ref = rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, ws, **kw)
    again = rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw)
    torch.cuda.synchronize()
    rstd, scale = rq._row_stats(x, gamma, beta, apply_norm, eps)
    flip = float(w[1].abs().max()) * float(ws[1].max()) * float(scale.max())
    err, exact = _flip_check(f"rmsq_gemm {name}", out, ref, flip)
    if out.dtype != out_dtype or not torch.equal(out, again):
        raise AssertionError(f"rmsq_gemm {name}: dtype {out.dtype}, or a second call differs")
    ms = _time_ms(lambda: rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw), 20, graph=True)
    plain = _time_ms(lambda: rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, ws, **kw), 3, 1)
    xq = torch.round((x.float() * rstd * gamma.float()[None] + beta[None]) / scale) \
        .clamp(-128, 127).to(torch.int8)
    library, _ = _int_mm_yardstick(torch, xq, w[1], scale, ws[1], m)
    lib = _time_ms(library, 20, graph=True)
    ob = 4 if out_dtype == torch.float32 else 2
    nbytes = 2 * m * k + k * n + 4 * n + 8 * k + ob * m * n
    bound, by = _bound_ms(nbytes, 2.0 * m * n * k, "int8_ops")
    print(f"  rmsq_gemm {name} M={m} K={k} N={n} bn={bn} apply_norm={apply_norm} out "
          f"{str(out_dtype).split('.')[1]}: {exact:.4f} of rows exact, max-abs {err:.3g} (one "
          f"flip {flip:.3g}), a second call bit-identical; kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, _int_mm + epilogue {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_rmsq_routes(torch, mm, rq, cfg, rng):
    """K2 where phase 18 (f)'s routes put it, at phase 4's M 128: wo and w2
    with apply_norm=False (ones as gamma, bf16 out; SKT_FUSED_QGEMM), and
    lm_head per_token with the final norm (K 4096, N 128,256 on its 768-wide
    panels, f32 out; SKT_FUSED_LM). Returns (the wo + w2 row summed, the
    lm_head row)."""
    h, f, m = cfg.hidden_size, cfg.intermediate_size, 128
    qgemm = [_k2_case(torch, mm, rq, rng, name, m, k, h, 512, False, torch.bfloat16,
                      cfg.rms_eps) for name, k in (("wo", cfg.q_size), ("w2", f))]
    lm = _k2_case(torch, mm, rq, rng, "lm_head", m, h, cfg.vocab_size, 768, True,
                  torch.float32, cfg.rms_eps)
    return _sum_rows(qgemm), lm


def _latent_rows(torch, rng, shape, int8):
    if int8:
        return torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
    return torch.randn(shape, generator=rng, device="cuda").to(torch.bfloat16)


def _bf16_check(name, out, ref, share):
    """Every bf16 value of `out` within one bf16 ulp of `ref`'s (2^-7 of its
    magnitude: two f32 results a summation order apart round to neighbouring
    values) plus `share` * max|ref|. Returns max-abs and the largest error
    over its bound."""
    a, b = out.double(), ref.double()
    err = (a - b).abs()
    ratio = float((err / (2.0 ** -7 * b.abs() + share * b.abs().max())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: max-abs {float(err.max()):.3g} is {ratio:.3g} x its "
                             f"bound (max|plain| {float(b.abs().max()):.3g})")
    return float(err.max()), ratio


def _sdpa_yardstick(torch, q, k, v, mask, scale, **kw):
    """One SDPA call in MQA-as-one-head form (q [B, 1, H, C] over k [B, 1,
    n, C], v [B, 1, n, Cv], a boolean mask [B, 1, 1, n]), or any other that
    SDPA's keywords `kw` (is_causal, enable_gqa) describe, on the first
    fused backend that takes it (flash, memory-efficient, cuDNN), else the
    math one. Returns (call, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional.scaled_dot_product_attention
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(be=be):
            with sdpa_kernel(be):
                return f(q, k, v, attn_mask=mask, scale=scale, **kw)
        try:
            with warnings.catch_warnings():       # a refusing backend says why
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, be.name.lower()
    raise AssertionError("no SDPA backend takes the yardstick")


def check_decode_mla_c(torch, dv2, mcfg, rng):
    """K5 at the bench MLA path's shape, int8 and bf16 latent rows: 128
    sequences, 16 heads, rows of 576 (512 | 64), 128-token pages, 3 pages
    each, cached lengths over 0..319 (0, 1, 127, 128, 129, 256 among them).
    Returns the int8 row (the bench path's) and prints both."""
    b, h, lkv = 128, mcfg.num_heads, mcfg.kv_lora_rank
    c, ps, mp, layers, li = lkv + mcfg.qk_rope_dim, mcfg.page_size, 3, 2, 1
    pages = b * mp + 1
    cached = torch.randint(0, 320, (b,), generator=rng, device="cuda", dtype=torch.int32)
    cached[:6] = torch.tensor([0, 1, 127, 128, 129, 256], dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    # scores of about 2.6 standard deviations: a peaked softmax, O(1) outputs
    q = (1.5 * torch.randn((b, h, c), generator=rng, device="cuda")).to(torch.bfloat16)
    new = torch.randn((b, c), generator=rng, device="cuda").to(torch.bfloat16)
    sm = (mcfg.qk_nope_dim + mcfg.qk_rope_dim) ** -0.5
    row = None
    for kind in ("int8", "bf16"):
        int8 = kind == "int8"
        cache = _latent_rows(torch, rng, (layers, pages, ps, c), int8)
        scales = (torch.rand((layers, pages, 1, ps), generator=rng, device="cuda") * 0.02
                  + 0.005) if int8 else None
        args = (q, new, cache, cached, bt, sm, ps, lkv)
        out = dv2.decode_mla_v3_defer(*args, layer_idx=li, kv_scales=scales)
        ref = dv2._decode_chunks_ref(q, new, cache, scales, cached, bt, sm, ps, lkv, li,
                                     dv2._chunk_pages(mp))
        torch.cuda.synchronize()
        err, ratio = _bf16_check(f"decode_mla_c {kind}", out, ref, K5_SHARE)
        ms = _time_ms(lambda: dv2.decode_mla_v3_defer(*args, layer_idx=li, kv_scales=scales),
                      50, graph=True)
        plain = _time_ms(lambda: dv2._decode_chunks_ref(q, new, cache, scales, cached, bt, sm,
                                                        ps, lkv, li, dv2._chunk_pages(mp)), 5)
        # yardstick: SDPA over the dequantized bf16 latent with the current
        # row appended, MQA as one head: the 16 heads are 16 queries
        n = mp * ps + 1
        rows = cache[li][bt.long()].reshape(b, mp * ps, c).float()
        if int8:
            rows = rows * scales[li][bt.long()].reshape(b, mp * ps, 1)
        kk = torch.cat([rows.to(torch.bfloat16), new[:, None]], 1)[:, None]
        vv = kk[..., :lkv].contiguous()
        col = torch.arange(n, device="cuda")
        mask = ((col[None, :] < cached[:, None]) | (col[None, :] == n - 1))[:, None, None, :]
        library, backend = _sdpa_yardstick(torch, q[:, None], kk, vv, mask, sm)
        lib_err = (library()[:, 0].float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 20, graph=True)
        tok = cached.double().sum().item()
        elt = 1 if int8 else 2
        nbytes = (tok * (c * elt + (4 if int8 else 0)) + 2 * b * h * c + 2 * b * c
                  + 2 * b * h * lkv + 4 * b + 4 * b * mp)
        bound, by = _bound_ms(nbytes, 2.0 * (tok + b) * h * (c + lkv), "bf16_flops")
        print(f"  decode_mla_c {kind} B={b} H={h} C={c} ps={ps} MP={mp} cached 0.."
              f"{int(cached.max())} (sum {int(tok)}): max-abs {err:.3g} ({ratio:.3g} of its "
              f"bound, max|plain| {float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, SDPA ({backend}) {lib:.4f} ms (max-abs vs plain "
              f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
        if int8:
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                       max_abs_err=err)
        del cache
    return row


def _k5_case(torch, dv2, mcfg, rng, ps, cp, b, mp, c, qscale):
    """One K5 edge case: B sequences of MP pages of ps rows of width c,
    cached 0, 1, ps - 1, ps, ps + 1, 4 ps, 4 ps + 1, 17, 113, 2 ps + 45
    (within MP pages; random lengths for the rest of the batch), q of
    qscale randn; int8 and bf16 rows, each within one bf16 ulp + K5_SHARE of
    max|plain| and a second call bit-identical. Returns "int8 r, bf16 r",
    each error over its bound."""
    h, lkv, layers, li = mcfg.num_heads, mcfg.kv_lora_rank, 2, 1
    sm = (mcfg.qk_nope_dim + mcfg.qk_rope_dim) ** -0.5
    lens = [0, 1, ps - 1, ps, ps + 1, 4 * ps, 4 * ps + 1, 17, 113, 2 * ps + 45]
    lens = [min(n, mp * ps) for n in lens]
    if b > len(lens):
        lens += torch.randint(0, mp * ps + 1, (b - len(lens),), generator=rng,
                              device="cuda").tolist()
    pages = b * mp + 1
    cached = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = (qscale * torch.randn((b, h, c), generator=rng, device="cuda")).to(torch.bfloat16)
    new = torch.randn((b, c), generator=rng, device="cuda").to(torch.bfloat16)
    errs = []
    for int8 in (True, False):
        cache = _latent_rows(torch, rng, (layers, pages, ps, c), int8)
        scales = (torch.rand((layers, pages, 1, ps), generator=rng, device="cuda") * 0.02
                  + 0.005) if int8 else None
        args = (q, new, cache, cached, bt, sm, ps, lkv)
        kw = dict(layer_idx=li, kv_scales=scales, chunk_pages=cp)
        out = dv2.decode_mla_v3_defer(*args, **kw)
        again = dv2.decode_mla_v3_defer(*args, **kw)
        ref = dv2._decode_chunks_ref(q, new, cache, scales, cached, bt, sm, ps, lkv, li,
                                     dv2._chunk_pages(mp, cp))
        torch.cuda.synchronize()
        label = f"decode_mla_c edges ps {ps} cp {cp or dv2.CHUNK_PAGES} B {b} C {c}"
        err, ratio = _bf16_check(f"{label} {'int8' if int8 else 'bf16'}", out, ref, K5_SHARE)
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: a second call differs")
        errs.append(f"{'int8' if int8 else 'bf16'} {ratio:.3g}")
        del cache
    return ", ".join(errs)


def check_decode_mla_c_edges(torch, dv2, mcfg):
    """K5 where its cluster split, passes and steps meet their edges, int8
    and bf16 rows at DeepSeek-V2-Lite's latent widths: pages of 16, 64, 128
    and 256 tokens, 6 pages a sequence (two softmax steps at cp = 4), cp 1
    and 3 at ps 64, cached 0, 1, ps - 1, ps, ps + 1, 4 ps, 4 ps + 1 and
    lengths whose 16-token tiles do not divide by the cluster's CTAs (17,
    113, 2 ps + 45), at a batch of 10, 64 and 128 (one CTA a sequence, the
    bench path's; its share in passes through two buffers, the first read
    again for P . V); and where a share does not fit beside the rest, so
    that the cluster grows: steps of 4 pages of 448 at B 128 (2 CTAs), of
    1,024 and of 2,048 at B 10 (4 and 8), and rows of 3,072 (passes of 16
    rows through one buffer; bf16 rows 4 CTAs); within one bf16 ulp +
    K5_SHARE of max|plain|, a second call bit-identical."""
    rng = torch.Generator(device="cuda")
    rng.manual_seed(610)
    lkv, rope = mcfg.kv_lora_rank, mcfg.qk_rope_dim
    notes = []
    for ps, cp, b, mp, c in ((16, None, 10, 6, lkv + rope), (64, None, 10, 6, lkv + rope),
                             (64, 1, 10, 6, lkv + rope), (64, 3, 10, 6, lkv + rope),
                             (128, None, 10, 6, lkv + rope), (256, None, 10, 6, lkv + rope),
                             (128, None, 64, 6, lkv + rope), (64, None, 128, 6, lkv + rope),
                             (448, None, 128, 4, lkv + rope), (1024, None, 10, 4, lkv + rope),
                             (2048, None, 10, 4, lkv + rope), (128, None, 128, 3, 3072)):
        # scores of phase 1's spread (q of 1.5 randn over rows of 576) at any width
        ratios = _k5_case(torch, dv2, mcfg, rng, ps, cp, b, mp, c, 1.5 * (576 / c) ** 0.5)
        notes.append(f"ps {ps} cp {cp or dv2.CHUNK_PAGES} B {b} MP {mp} C {c}: {ratios}")
    print("  decode_mla_c edges (cached 0, 1, ps - 1, ps, ps + 1, 4 ps, 4 ps + 1, 17, 113, "
          "2 ps + 45 within MP pages), errors over their bound: " + "; ".join(notes)
          + "; second calls bit-identical")


def check_decode_mla_c_sharp(torch, dv2, mcfg):
    """K5 at a sharper score spread than phase 1's (the edge cases above
    scale q to it): rows of 3,072 with q of 1.5 randn, and rows of 576 with
    q of 1.5 * sqrt(3072 / 576) randn, both the spread of 1.5 randn over
    3,072-wide rows; 128 sequences of 3 pages of 128, int8 and bf16 rows,
    within one bf16 ulp + K5_SHARE of max|plain|, a second call
    bit-identical."""
    rng = torch.Generator(device="cuda")
    rng.manual_seed(611)
    notes = []
    for c, qscale, label in ((3072, 1.5, "C 3072, q 1.5 randn"),
                             (576, 1.5 * (3072 / 576) ** 0.5,
                              "C 576, q 1.5 sqrt(3072 / 576) randn")):
        notes.append(f"{label}: " + _k5_case(torch, dv2, mcfg, rng, 128, None, 128, 3, c,
                                             qscale))
    print("  decode_mla_c at the sharper spread, errors over their bound: "
          + "; ".join(notes) + "; second calls bit-identical")


def _append_mla_inputs(torch, gen, layers, b, dtype, ps=128, c=576):
    """K6's inputs at check_append_mla's layout: (new rows [layers, b, c],
    cache [layers, 3 b + 1, ps, c], pages, slots), values in [-127, 127]
    drawn from `gen` as int8 and cast to `dtype`; b distinct pages from 1,
    the last row dropped (sentinel P)."""
    pages = 3 * b + 1
    new = torch.randint(-127, 128, (layers, b, c), generator=gen, dtype=torch.int8,
                        device="cuda").to(dtype)
    pg = (torch.randperm(pages - 1, generator=gen, device="cuda")[:b] + 1).to(torch.int32)
    pg[-1] = pages
    off = torch.randint(0, ps, (b,), generator=gen, device="cuda", dtype=torch.int32)
    cache = torch.randint(-127, 128, (layers, pages, ps, c), generator=gen, dtype=torch.int8,
                          device="cuda").to(dtype)
    return new, cache, pg, off


def check_append_mla(torch, dv2, mcfg, rng, floor):
    """K6 at the bench MLA path's shape: 27 layers x 128 int8 latent rows of
    576 (one dropped: page P) into 385 pages of 128. `floor`: the card's
    launch floor in ms, printed beside the bound."""
    layers, b = mcfg.num_layers, 128
    c = mcfg.kv_lora_rank + mcfg.qk_rope_dim
    pages = 3 * b + 1
    new, cache, pg, off = _append_mla_inputs(torch, rng, layers, b, torch.int8,
                                             mcfg.page_size, c)
    cache2 = cache.clone()
    dv2.append_mla(new, cache, pg, off)
    dv2.append_mla_ref(new, cache2, pg, off)
    torch.cuda.synchronize()
    if not torch.equal(cache, cache2):
        raise AssertionError("append_mla differs from its plain version")
    ms = _time_ms(lambda: dv2.append_mla(new, cache, pg, off), 50, graph=True)
    plain = _time_ms(lambda: dv2.append_mla_ref(new, cache2, pg, off), 10)
    live = pg < pages
    idx = (pg[live].long(), off[live].long())
    src = new[:, live].permute(1, 0, 2).contiguous()
    view = cache2.permute(1, 2, 0, 3)

    def library():
        view.index_put_(idx, src)
    library()
    if not torch.equal(cache, cache2):
        raise AssertionError("index_put_ yardstick disagrees")
    lib = _time_ms(library, 50, graph=True)
    nrow = int(live.sum())
    bound, by = _bound_ms(2 * layers * nrow * c + 8 * b, 0.0, "bf16_flops")
    print(f"  append_mla L={layers} B={b} C={c} (1 dropped): exact; kernel {ms:.4f} ms, "
          f"plain {plain:.3f} ms, index_put_ {lib:.4f} ms, bound {bound:.5f} ms ({by}), "
          f"launch floor {floor:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=0.0)


# K6's edges: (label, layers, batch, pages, page size, latent width, dtype
# name, page layout); "mixed": distinct pages with one -1 and one P among
# them, slots 0 and ps - 1 among the rest
K6_EDGES = (
    ("L 1, B 1, slot ps - 1", 1, 1, 4, 128, 576, "int8", "last"),
    ("B 1 over 27 layers, bf16 rows of 1,152 bytes", 27, 1, 4, 128, 576, "bfloat16", "first"),
    ("every row dropped (pages -1 and P)", 27, 128, 385, 128, 576, "int8", "dropped"),
    ("bf16 rows of 1,152 bytes, pages -1 and P, slots 0 and ps - 1", 27, 128, 385, 128, 576,
     "bfloat16", "mixed"),
    ("B 8 (layers split over blocks)", 27, 8, 25, 128, 576, "int8", "mixed"),
    ("B 200 (above the SM count), L 3, pages of 64", 3, 200, 601, 64, 576, "int8", "mixed"),
    ("B 7, L 5, rows of 16 bytes", 5, 7, 9, 16, 16, "int8", "mixed"),
    ("L 3, B 5, int8 rows of 4,608 bytes (wider than the block)", 3, 5, 8, 16, 4608, "int8",
     "mixed"),
    ("L 6, B 140, bf16 rows of 4,608 bytes (wider than the block, layers looped)", 6, 140,
     141, 2, 2304, "bfloat16", "mixed"),
)


def _k6_pages(torch, gen, layout, b, pages, ps):
    """(pages, slots) int32 [b] of a K6 edge's layout."""
    pg = (torch.randperm(pages, generator=gen, device="cuda")[:b]).to(torch.int32)
    off = torch.randint(0, ps, (b,), generator=gen, device="cuda", dtype=torch.int32)
    if layout == "last":
        off[:] = ps - 1
    elif layout == "first":
        off[:] = 0
    elif layout == "dropped":
        pg[::2], pg[1::2] = -1, pages
    else:
        pg[0], pg[-1] = -1, pages
        if b > 3:
            off[1], off[2] = 0, ps - 1
    return pg, off


def check_append_mla_edges(torch, dv2):
    """K6 at K6_EDGES, each on a cache filled with 0x7f bytes (the bf16 one
    with random bytes besides): exact against its plain version, and a
    second call leaves the cache bit-identical."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(606)
    for label, layers, b, pages, ps, c, dt, layout in K6_EDGES:
        dtype = getattr(torch, dt)
        shape = (layers, pages, ps, c * (2 if dt == "bfloat16" else 1))
        if layout == "mixed" and dt == "bfloat16":
            raw = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
        else:
            raw = torch.full(shape, 0x7f, dtype=torch.uint8, device="cuda")
        cache = raw.view(dtype)
        new = torch.randint(-127, 128, (layers, b, c), generator=gen, device="cuda",
                            dtype=torch.int8).to(dtype)
        pg, off = _k6_pages(torch, gen, layout, b, pages, ps)
        want = dv2.append_mla_ref(new, cache.clone(), pg, off)
        dv2.append_mla(new, cache, pg, off)
        torch.cuda.synchronize()
        if not torch.equal(cache.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"append_mla {label}: differs from its plain version")
        dv2.append_mla(new, cache, pg, off)
        torch.cuda.synchronize()
        if not torch.equal(cache.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"append_mla {label}: a second call differs")
    print(f"  append_mla edges ({'; '.join(e[0] for e in K6_EDGES)}): exact on 0x7f caches, "
          "second calls bit-identical")


def check_decode_mla(torch, dec, mcfg, rng):
    """K7 at the MLA engine's decode shape: 8 sequences, 16 heads, split
    caches of 512 and 64 bf16 columns, 128-token pages, 40..700 cached (page
    edges included) plus the current token already in the cache."""
    b, h, lkv, lrope, ps = 8, mcfg.num_heads, mcfg.kv_lora_rank, mcfg.qk_rope_dim, \
        mcfg.page_size
    pages, mp = 512, 64
    seq = torch.tensor([40, 127, 128, 129, 255, 384, 511, 700], dtype=torch.int32,
                       device="cuda") + 1
    bt = _block_tables(torch, rng, seq.tolist(), mp, pages, ps)
    ckv = _latent_rows(torch, rng, (pages, ps, lkv), False)
    kr = _latent_rows(torch, rng, (pages, ps, lrope), False)
    q = (1.5 * torch.randn((b, h, lkv + lrope), generator=rng, device="cuda")).to(torch.bfloat16)
    sm = (mcfg.qk_nope_dim + mcfg.qk_rope_dim) ** -0.5
    args = (q, ckv, kr, seq, bt, sm, ps)
    out = dec.decode_mla(*args)
    ref = dec.decode_mla_ref(*args)
    torch.cuda.synchronize()
    err, ratio = _bf16_check("decode_mla", out, ref, K7_SHARE)
    if not torch.equal(dec.decode_mla(*args), out):
        raise AssertionError("decode_mla: a second call differs")
    ms = _time_ms(lambda: dec.decode_mla(*args), 50, graph=True)
    plain = _time_ms(lambda: dec.decode_mla_ref(*args), 5)
    n = int(seq.max())
    kk = torch.cat([ckv[bt.long()].reshape(b, mp * ps, lkv),
                    kr[bt.long()].reshape(b, mp * ps, lrope)], -1)[:, None, :n].contiguous()
    vv = kk[..., :lkv].contiguous()
    mask = (torch.arange(n, device="cuda")[None, :] < seq[:, None])[:, None, None, :]
    library, backend = _sdpa_yardstick(torch, q[:, None], kk, vv, mask, sm)
    lib_err = (library()[:, 0].float() - ref.float()).abs().max().item()
    lib = _time_ms(library, 50, graph=True)
    tok = seq.double().sum().item()
    nbytes = tok * (lkv + lrope) * 2 + 2 * b * h * (lkv + lrope) + 2 * b * h * lkv + 4 * b \
        + 4 * b * mp
    bound, by = _bound_ms(nbytes, 2.0 * tok * h * (2 * lkv + lrope), "bf16_flops")
    print(f"  decode_mla B={b} H={h} seq {seq.tolist()}: max-abs {err:.3g} ({ratio:.3g} of its "
          f"bound, max|plain| {float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, SDPA ({backend}) {lib:.4f} ms (max-abs vs plain {lib_err:.3g}), "
          f"bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


# K7's split edges: (label, sequence lengths including the current token,
# heads and krope columns, None for DeepSeek-V2-Lite's)
K7_EDGES = (("8 sequences of 1 token", (1,) * 8, None),
            ("one sequence of 4,097 tokens", (4097,), None),
            ("8 equal sequences of 300", (300,) * 8, None),
            ("lengths on split and round edges", (63, 64, 65, 96, 97, 129, 4096, 8192), None),
            ("4 heads, krope 16", (41, 300, 701), (4, 16)),
            ("20 heads, krope 6", (41, 300, 701), (20, 6)))


def check_decode_mla_edges(torch, dec, mcfg):
    """K7 at the edges of its split plan (ops/attention/decode.py::
    mla_split_bounds), 128-token pages, 64 pages a sequence: sequences of
    one split, one sequence over many splits, equal lengths, lengths a
    token either side of a round or a split (16 heads); and head counts
    that leave a 16-head tile part empty (4, 20) with krope widths of 16
    and 6 columns (zero-padded to 64, in 16- and 4-byte copies). Each
    within K7_SHARE of its plain version, a second call bit-identical."""
    lkv, ps, mp = mcfg.kv_lora_rank, mcfg.page_size, 64
    sm = (mcfg.qk_nope_dim + mcfg.qk_rope_dim) ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(71)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    notes = []
    for label, lens, widths in K7_EDGES:
        h, lrope = widths or (mcfg.num_heads, mcfg.qk_rope_dim)
        b = len(lens)
        pages = b * mp + 1
        seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bt = _block_tables(torch, gen, lens, mp, pages, ps)
        ckv = _latent_rows(torch, gen, (pages, ps, lkv), False)
        kr = _latent_rows(torch, gen, (pages, ps, lrope), False)
        q = (1.5 * torch.randn((b, h, lkv + lrope), generator=gen, device="cuda")) \
            .to(torch.bfloat16)
        args = (q, ckv, kr, seq, bt, sm, ps)
        out = dec.decode_mla(*args)
        ref = dec.decode_mla_ref(*args)
        torch.cuda.synchronize()
        _, ratio = _bf16_check(f"decode_mla ({label})", out, ref, K7_SHARE)
        if not torch.equal(dec.decode_mla(*args), out):
            raise AssertionError(f"decode_mla ({label}): a second call differs")
        s = dec.mla_splits(sms, b, h, mp * ps)
        nsplit = max(len(dec.mla_split_bounds(n, s)) for n in lens)
        notes.append(f"{label} (up to {nsplit} of S {s} splits) {ratio:.3f}")
        del ckv, kr
    print("  decode_mla edges, each within its bar (largest error over it) and a second call "
          "bit-identical: " + "; ".join(notes))


# ------------------------------------------------------- Qwen3-Next kernels

# K9's o and K10 (`_bf16_check` on K10's bf16 output): f32 sums taken in
# another order than the plain versions'; this share of max|plain|
GDN_SHARE = 1e-4
K10_SHARE = 1e-4
# K9's f32 pool against its plain version: the state itself, its delta from
# f32 sums taken in another order; this share of max|plain|
GDN_F32_POOL_SHARE = 1e-5


def qwen_bench_config(qn):
    """`bench.py --config qwen`'s configuration (bench.py:515-523)."""
    return qn.QwenNextConfig(vocab_size=32768, hidden_size=2048, num_layers=12,
                             full_attention_interval=4, num_qk_heads=8, num_v_heads=8,
                             head_qk_dim=128, head_v_dim=128, conv_width=4, chunk_size=64,
                             num_heads=16, num_kv_heads=2, head_dim=128, page_size=128,
                             num_experts=128, top_k=10, moe_intermediate_size=512,
                             shared_intermediate_size=512, max_position=8192, num_loras=0,
                             lora_rank=8)


def _expert_groups(eid, live, tile):
    """Host list of (expert, first row, end row) over runs of live tiles with
    one expert."""
    groups = []
    for i, (e, on) in enumerate(zip(eid, live)):
        if not on:
            continue
        if groups and groups[-1][0] == e and groups[-1][2] == i * tile:
            groups[-1][2] = (i + 1) * tile
        else:
            groups.append([e, i * tile, (i + 1) * tile])
    return groups


def check_grouped(torch, mm, quant, qn, qcfg, rng):
    """K8 at the Qwen bench path's two expert GEMMs: 128 tokens routed top-10
    over 128 experts (random router scores), aligned to 32-row tiles (5,376
    rows), the experts of layer 1 of a 2-layer flat bank pretiled at 1024
    (w13: K 2048, N 1024; w2: K 512, N 2048); exact, a second call
    bit-identical, one kernel a call. Returns the row of both GEMMs
    summed."""
    b, e, k = 128, qcfg.num_experts, qcfg.top_k
    h, f = qcfg.hidden_size, qcfg.moe_intermediate_size
    tile, li = qn.MOE_TILE, 1
    topi = torch.topk(torch.rand((b, e), generator=rng, device="cuda"), k, dim=-1).indices
    ok, src, eid = qn.align_routes(topi, e, tile)
    eid = eid + li * e
    m = ok.shape[0]
    live = ok.reshape(-1, tile).any(1).tolist()
    groups = _expert_groups(eid.tolist(), live, tile)
    n_exp = len({g[0] for g in groups})
    tok = src // k
    rows = []
    for name, kk, n in (("w13", h, 2 * f), ("w2", f, h)):
        bank = torch.randint(-127, 128, (2 * e, n // 1024, kk, 1024), generator=rng,
                             dtype=torch.int8, device="cuda")
        ws = torch.rand((2 * e, n), generator=rng, device="cuda") * 1e-3
        x = torch.randn((b, kk), generator=rng, device="cuda").to(torch.bfloat16)
        xq, xs = quant.per_token_quant_int8(x)
        xg = torch.where(ok[:, None], xq[tok], 0).to(torch.int8)
        xsg = torch.where(ok[:, None], xs[tok], 0.0)
        args = (xg, bank, xsg, ws, eid, tile)
        out = mm.grouped_matmul_int8(*args)
        again = mm.grouped_matmul_int8(*args)
        ref = mm.grouped_matmul_int8_tiles_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"w8a8_gemm_grouped {name}: {(out != ref).sum().item()} "
                                 "elements differ")
        if not torch.equal(out, again):
            raise AssertionError(f"w8a8_gemm_grouped {name}: a second call differs")
        kernels = _device_kernels(torch, lambda: mm.grouped_matmul_int8(*args))
        if kernels is not None and len(kernels) != 1:
            raise AssertionError(f"w8a8_gemm_grouped {name}: one call launched {kernels}")
        ms = _time_ms(lambda: mm.grouped_matmul_int8(*args), 20, graph=True)
        plain = _time_ms(lambda: mm.grouped_matmul_int8_tiles_ref(*args), 1, 1)
        wkn = mm.untile_weight_bank(bank).contiguous()

        def library():
            y = torch.zeros((m, n), dtype=torch.bfloat16, device="cuda")
            for g, r0, r1 in groups:
                acc = torch._int_mm(xg[r0:r1], wkn[g])
                y[r0:r1] = (acc.float() * xsg[r0:r1] * ws[g][None]).to(torch.bfloat16)
            return y
        if not torch.equal(library(), ref):
            raise AssertionError("torch._int_mm per expert group disagrees")
        lib = _time_ms(library, 5, graph=True)
        nbytes = n_exp * (kk * n + 4 * n) + m * kk + 4 * m + 2 * m * n + 4 * eid.numel()
        bound, by = _bound_ms(nbytes, 2.0 * b * k * kk * n, "int8_ops")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=0.0))
        print(f"  w8a8_gemm_grouped {name} M={m} (tiles of {tile}, {sum(live)} live, "
              f"{n_exp} experts) K={kk} N={n}: exact; kernel {ms:.4f} ms, plain {plain:.3f} "
              f"ms, _int_mm per expert group {lib:.4f} ms, bound {bound:.4f} ms ({by})")
        del bank, wkn
    return _sum_rows(rows)


def _device_kernels(torch, fn):
    """The device kernels (names) that one call of fn launches, by
    torch.profiler; None where the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return names or None


def check_grouped_edges(torch, mm):
    """K8 at its edges, each exact against grouped_matmul_int8_tiles_ref with
    a second call bit-identical, bf16 and f32 out, on a plain [G, K, N] bank
    and on banks pretiled at 128 (a 256-column tile over two panels) and 256:
    32-row expert tiles with 17-32 live rows (two 16-row tiles, the second
    part padding), a 32-row tile of padding, a 128-row tile of padding, an
    expert id past G and one below 0 (clamped), at block_m 32 and 128; and
    shapes whose plan splits K (16-row and 128-row tiles, with a padding
    tile), each run twice more so that the arrival counters are shown to
    reset. Every call is one kernel."""
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1608)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    notes = []
    # (block_m, tiles' live rows (0: padding), expert ids, K, N)
    cases = (
        (32, (20, 32, 0, 17, 5), (1, 3, 0, 9, -2), 512, 768),
        (128, (128, 0, 77, 1), (2, 0, 7, 1), 512, 768),
        (32, (32, 0, 24), (2, 0, 7), 2048, 256),         # splits K, 16-row tiles
        (128, (100, 0), (3, 1), 2048, 256),              # splits K, 128-row tiles
    )
    for block_m, live, ids, k, n in cases:
        g = 4
        m = block_m * len(live)
        bm, tiles_m, tiles_n, splits = mm.gemm_plan(m, n, k, sms, block_m)
        xq = torch.randint(-128, 128, (m, k), generator=rng, dtype=torch.int8, device="cuda")
        xs = torch.rand((m, 1), generator=rng, device="cuda") * 0.05 + 0.001
        for i, rows in enumerate(live):
            xs[i * block_m + rows:(i + 1) * block_m] = 0.0
            xq[i * block_m + rows:(i + 1) * block_m] = 0
        eid = torch.tensor(ids, dtype=torch.int32, device="cuda")
        w = torch.randint(-127, 128, (g, k, n), generator=rng, dtype=torch.int8, device="cuda")
        ws = torch.rand((g, n), generator=rng, device="cuda") * 1e-3
        for bank_name, bank in (("plain", w), ("bn 128", mm.pretile_weight_bank(w, 128)),
                                ("bn 256", mm.pretile_weight_bank(w, 256))):
            for od in (torch.bfloat16, torch.float32):
                args = (xq, bank, xs, ws, eid, block_m, od)
                out = mm.grouped_matmul_int8(*args)
                again = mm.grouped_matmul_int8(*args)
                third = mm.grouped_matmul_int8(*args)
                ref = mm.grouped_matmul_int8_tiles_ref(*args)
                torch.cuda.synchronize()
                label = (f"w8a8_gemm_grouped edge block_m {block_m} live {live} ids {ids} "
                         f"K {k} N {n} {bank_name} {str(od)[6:]}")
                if not torch.equal(out, ref):
                    raise AssertionError(f"{label}: {(out != ref).sum().item()} elements "
                                         "differ from the plain version")
                if not (torch.equal(out, again) and torch.equal(out, third)):
                    raise AssertionError(f"{label}: a repeat differs")
        kernels = _device_kernels(torch, lambda: mm.grouped_matmul_int8(xq, w, xs, ws, eid,
                                                                         block_m))
        if kernels is not None and len(kernels) != 1:
            raise AssertionError(f"w8a8_gemm_grouped block_m {block_m}: one call launched "
                                 f"{kernels}")
        notes.append(f"block_m {block_m} (tiles of {bm}, {splits} splits) live {live} ids {ids}")
    if mm.gemm_plan(96, 256, 2048, sms, 32)[3] < 2 or mm.gemm_plan(256, 256, 2048, sms,
                                                                     128)[3] < 2:
        raise AssertionError("the small grouped shapes no longer split K")
    print("  w8a8_gemm_grouped edges exact, repeats bit-identical, one kernel a call, plain "
          "and pretiled banks (bn 128, 256), bf16 and f32: " + "; ".join(notes))


def _gdn_inputs(torch, rng, b, h, hv, d, rows, dtype):
    """K9's inputs: a pool of `rows` rows of random state (0.1 N(0, 1)) in
    `dtype`, q, k, v N(0, 1), g in (-2, 0], beta a sigmoid."""
    pool = (0.1 * torch.randn((rows, hv, d, d), generator=rng, device="cuda")).to(dtype)
    q = torch.randn((b, h, d), generator=rng, device="cuda")
    k = torch.randn((b, h, d), generator=rng, device="cuda")
    v = torch.randn((b, hv, d), generator=rng, device="cuda")
    g = -2.0 * torch.rand((b, hv), generator=rng, device="cuda")
    beta = torch.sigmoid(torch.randn((b, hv), generator=rng, device="cuda"))
    return pool, (q, k, v, g, beta)


def _gdn_run(torch, rec, pool, a, idx, nb, label):
    """K9 and its plain version on copies of `pool` with the first nb
    sequences of `a`: o within GDN_SHARE of max|plain|; a bf16 pool within
    one bf16 ulp, an f32 pool within GDN_F32_POOL_SHARE of max|plain|;
    every row no sequence writes untouched. Returns (o's max-abs error, the
    share of the pool bit-equal, the kernel's pool)."""
    p1, p2 = pool.clone(), pool.clone()
    a = tuple(x[:nb] for x in a)
    sc = a[0].shape[-1] ** -0.5
    o = rec.delta_rule_step(*a, p1, idx, sc, True)
    ref = rec.delta_rule_step_ref(*a, p2, idx, sc, True)
    torch.cuda.synchronize()
    err = float((o - ref).abs().max())
    if not err <= GDN_SHARE * float(ref.abs().max()):
        raise AssertionError(f"{label} o: max-abs {err:.3g}, max|plain| "
                             f"{float(ref.abs().max()):.3g}")
    if pool.dtype == torch.bfloat16:
        _bf16_check(f"{label} pool", p1, p2, 1e-6)
    else:
        perr = float((p1 - p2).abs().max())
        if not perr <= GDN_F32_POOL_SHARE * float(p2.abs().max()):
            raise AssertionError(f"{label} f32 pool: max-abs {perr:.3g}, max|plain| "
                                 f"{float(p2.abs().max()):.3g}")
    written = torch.zeros(pool.shape[0], dtype=torch.bool, device="cuda")
    written[idx[idx >= 0].long()] = True
    if not (torch.equal(p1[~written], pool[~written])
            and torch.equal(p2[~written], pool[~written])):
        raise AssertionError(f"{label} wrote a row it must not write")
    return err, float((p1 == p2).float().mean()), p1


def _gdn_row(torch, rec, rng, label, b, h, hv, d, layers, dtype):
    """K9 at B sequences of H qk / HV v heads of D over a pool of `layers`
    GDN layers' rows in `dtype`, the rows of layer 1 (of 4 when layers is 9,
    as the bench path's layer 4): checked (_gdn_run), then 16 sequences with
    idx -1 among them, then timed against its plain version and its byte
    bound (the touched state read once and written once, the f32 inputs and
    outputs once)."""
    li = 4 if layers > 4 else 1
    pool, a = _gdn_inputs(torch, rng, b, h, hv, d, layers * b, dtype)
    idx = (li * b + torch.arange(b, device="cuda")).to(torch.int32)
    err, exact, p1 = _gdn_run(torch, rec, pool, a, idx, b, label)
    idx16 = torch.arange(1, 17, dtype=torch.int32, device="cuda")
    idx16[[3, 7, 8]] = -1
    _gdn_run(torch, rec, pool, a, idx16, 16, label)
    sc = d ** -0.5
    ms = _time_ms(lambda: rec.delta_rule_step(*a, p1, idx, sc, True), 50, graph=True)
    plain = _time_ms(lambda: rec.delta_rule_step_ref(*a, p1, idx, sc, True), 5)
    nbytes = (2 * b * hv * d * d * pool.element_size()
              + 4 * (2 * b * h * d + 2 * b * hv * d + 2 * b * hv + b))
    bound, by = _bound_ms(nbytes, 7.0 * b * hv * d * d, "f32_flops")
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"  {label} B={b} H={h} HV={hv} K=V={d}, {kind} pool {layers * b} rows: o max-abs "
          f"{err:.3g}, pool {exact:.5f} exact (the rest within "
          f"{'one bf16 ulp' if kind == 'bf16' else f'{GDN_F32_POOL_SHARE:g} of max|plain|'}), "
          f"untouched rows equal, idx -1 rows kept; kernel {ms:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_gdn(torch, rec, qcfg, rng):
    """K9 at the Qwen bench shape: 128 sequences, 8 qk and 8 v heads of 128,
    the bf16 pool of all 9 GDN layers (1,152 rows of random state), the rows
    of layer 4; o within GDN_SHARE of max|plain|, the pool within one bf16
    ulp, every other row untouched. Then 16 sequences with idx -1 among them:
    their rows stay as they were."""
    return _gdn_row(torch, rec, rng, "gdn_recurrent", 128, qcfg.num_qk_heads,
                    qcfg.num_v_heads, qcfg.head_qk_dim, qcfg.num_gdn_layers, torch.bfloat16)


def check_gdn_widths(torch, rec, rng):
    """K9's other instantiations: the f32 pool at Qwen3-Next-80B-A3B's
    published GDN shape (128 sequences, 16 qk / 32 v heads of 128, the 3 GDN
    layers of phase 19 (a)'s 4), bf16 and f32 pools at the default
    QwenNextConfig's heads (4 qk / 8 v of 32, 3 GDN layers) at a batch of
    128, each checked and timed (_gdn_row); and D 64 checked (no caller
    runs it: 16 sequences, 4 / 8 heads, both pools). Returns the rows of
    the f32 pool, D 32 and D 32 on an f32 pool."""
    rows = (_gdn_row(torch, rec, rng, "gdn_recurrent (f32 pool)", 128, 16, 32, 128, 3,
                     torch.float32),
            _gdn_row(torch, rec, rng, "gdn_recurrent (D 32)", 128, 4, 8, 32, 3, torch.bfloat16),
            _gdn_row(torch, rec, rng, "gdn_recurrent (D 32, f32 pool)", 128, 4, 8, 32, 3,
                     torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        pool, a = _gdn_inputs(torch, rng, 16, 4, 8, 64, 32, dtype)
        idx = torch.arange(16, 32, dtype=torch.int32, device="cuda")
        idx[5] = -1
        _gdn_run(torch, rec, pool, a, idx, 16, f"gdn_recurrent (D 64, {dtype})")
    print("  gdn_recurrent D 64: bf16 and f32 pools held to their plain version")
    return rows


def check_decode_hm(torch, dec, qcfg, rng):
    """K10 at the Qwen bench shape: 128 sequences, 16 query and 2 kv heads of
    128, head-major bf16 pages of 128, 3 pages each, lengths 250..289 with 1,
    2, 127, 128, 129, 255, 256, 384 among them; layer 2 of 3."""
    b, hq, hkv, d, ps = 128, qcfg.num_heads, qcfg.num_kv_heads, qcfg.head_dim, qcfg.page_size
    mp, layers, li = 3, 3, 2
    pages = b * mp + 1
    kc = torch.randn((layers, hkv, pages, ps, d), generator=rng, device="cuda").to(torch.bfloat16)
    vc = torch.randn((layers, hkv, pages, ps, d), generator=rng, device="cuda").to(torch.bfloat16)
    seq = torch.randint(250, 290, (b,), generator=rng, device="cuda", dtype=torch.int32)
    seq[:8] = torch.tensor([1, 2, 127, 128, 129, 255, 256, 384], dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    # scores of about 1.5 standard deviations: O(1) outputs
    q = (1.5 * torch.randn((b, hq, d), generator=rng, device="cuda")).to(torch.bfloat16)
    return _decode_hm_row(torch, dec, "decode_hm", q, kc[li], vc[li], seq, bt, ps)


def check_decode_hm256(torch, dec, rng):
    """K10 at head dim 256, at Qwen3-Next-80B-A3B's full-attention shape
    (phase 18 (c)): 128 sequences, 16 query and 2 kv heads of 256 (G 8),
    head-major bf16 pages of 128, 3 pages each, 256..383 cached tokens and
    the current one (lengths 257..384, with 1, 2, 127, 128, 129, 255, 256
    among them)."""
    b, hq, hkv, d, ps, mp = 128, 16, 2, 256, 128, 3
    pages = b * mp + 1
    kc, vc = (torch.randn((hkv, pages, ps, d), generator=rng, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    seq = torch.randint(257, 385, (b,), generator=rng, device="cuda", dtype=torch.int32)
    seq[:7] = torch.tensor([1, 2, 127, 128, 129, 255, 256], dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = (1.5 * torch.randn((b, hq, d), generator=rng, device="cuda")).to(torch.bfloat16)
    return _decode_hm_row(torch, dec, "decode_hm256", q, kc, vc, seq, bt, ps)


def _decode_hm_row(torch, dec, name, q, k, v, seq, bt, ps):
    """K10 (`name`, its counter) on one layer's kv-head-major pages against
    its plain version within one bf16 ulp + K10_SHARE of max|plain|, a second
    call bit-identical; times the kernel, the plain version and SDPA over the
    gathered rows (its row of the kernels' line)."""
    b, hq, d = q.shape
    hkv, mp = k.shape[0], bt.shape[1]
    sm = d ** -0.5
    args = (q, k, v, seq, bt, sm, ps)
    out, again = dec.decode_gqa_hm(*args), dec.decode_gqa_hm(*args)
    ref = dec.decode_gqa_hm_ref(*args)
    torch.cuda.synchronize()
    err, ratio = _bf16_check(name, out, ref, K10_SHARE)
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second call differs")
    ms = _time_ms(lambda: dec.decode_gqa_hm(*args), 50, graph=True)
    plain = _time_ms(lambda: dec.decode_gqa_hm_ref(*args), 5)
    n, g = mp * ps, hq // hkv
    btl = bt.long()
    kk = k[:, btl].permute(1, 0, 2, 3, 4).reshape(b, hkv, n, d).contiguous()
    vv = v[:, btl].permute(1, 0, 2, 3, 4).reshape(b, hkv, n, d).contiguous()
    mask = (torch.arange(n, device="cuda")[None, :] < seq[:, None])[:, None, None, :]
    qq = q.reshape(b, hkv, g, d)
    library, backend = _sdpa_yardstick(torch, qq, kk, vv, mask, sm)
    lib_err = (library().reshape(b, hq, d).float() - ref.float()).abs().max().item()
    lib = _time_ms(library, 50, graph=True)
    tok = seq.double().sum().item()
    nbytes = tok * hkv * d * 2 * 2 + 2 * 2 * b * hq * d + 4 * b + 4 * b * mp
    bound, by = _bound_ms(nbytes, 4.0 * tok * hq * d, "f32_flops")
    print(f"  {name} B={b} Hq={hq} Hkv={hkv} D={d} ps={ps} MP={mp} seq 1..{int(seq.max())} "
          f"(sum {int(tok)}): max-abs {err:.3g} ({ratio:.3g} of its bound, max|plain| "
          f"{float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain {plain:.3f} ms, "
          f"SDPA ({backend}) {lib:.4f} ms (max-abs vs plain {lib_err:.3g}), bound {bound:.4f} "
          f"ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_decode_hm_edges(torch, dec, dv3, d=128):
    """K10 where the loop meets its edges, against its plain version within
    one bf16 ulp + K10_SHARE of max|plain|, each second call bit-identical,
    the wrapper's output and workspace allocated on 0x7f bytes: 7 sequences
    over 2 kv heads (rows split over blocks: skt_decode_hm_splits must say S
    > 1), G 1, 2, 4, 8 and 16 (16: two blocks of 8), pages of 16, 100 and
    512 tokens over 4 pages and one of 8,192 (two softmax steps of 4,096
    within it; at head dim 256 four of 2,048), lengths 0, 1, ps - 1, ps, ps
    + 1, 2 ps + 3 and 4 ps (capped at MP ps). d: the head dim, 128 or 256
    (K10's second instantiation, counter decode_hm256)."""
    from sgl_kernel_npu_tpu_torch import _build
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1019)
    hkv, b = 2, 7
    name = "decode_hm" if d == 128 else f"decode_hm{d}"
    sm = d ** -0.5
    worst, calls, least_s = 0.0, 0, 8
    for ps, mp in V3_EDGE_PAGES:
        pages = b * mp + 1
        lens = torch.tensor(_v3_edge_lens(ps, mp), dtype=torch.int32, device="cuda")
        bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        k, v, _, _ = _hm_pages(torch, rng, pages, hkv, ps, d, False, head_major=True)
        for g in (1, 2, 4, 8, 16):
            q = (1.5 * torch.randn((b, hkv * g, d), generator=rng, device="cuda")
                 ).to(torch.bfloat16)
            ng = dv3.v3_groups(g)
            least_s = min(least_s, _build.splits(name, b, hkv, g // ng, ng, mp, ps))
            with _dirty_empty(torch, dv3):
                out, again = (dec.decode_gqa_hm(q, k, v, lens, bt, sm, ps) for _ in range(2))
            ref = dec.decode_gqa_hm_ref(q, k, v, lens, bt, sm)
            torch.cuda.synchronize()
            _, ratio = _bf16_check(f"{name} edges ps {ps} G {g}", out, ref, K10_SHARE)
            if not torch.equal(out, again):
                raise AssertionError(f"{name} edges ps {ps} G {g}: a second call differs")
            worst, calls = max(worst, ratio), calls + 1
        del k, v
        torch.cuda.empty_cache()
    if least_s < 2:
        raise AssertionError(f"{name} edges: a batch of {b} took S = {least_s}, unsplit")
    print(f"  {name} edges ({calls} calls: G 1, 2, 4, 8, 16; ps 16 / 100 / 512 over 4 pages "
          f"and 8192 over one; lengths 0, 1, ps - 1, ps, ps + 1, 2 ps + 3, 4 ps; B {b}, S >= "
          f"{least_s}; output and workspace on 0x7f bytes): at most {worst:.3g} of the bound, "
          f"second calls bit-identical")


# ------------------------------------------------------- the hm Llama kernels

# K14 (`_bf16_check`): p rounded to bf16 before P.V, as in K5, so K5's share;
# K15 and K16 are all f32, so K7's and K10's
K14_SHARE = K5_SHARE
HM_SHARE = K10_SHARE
HM_ENGINE_CACHED = (40, 127, 128, 129, 255, 384, 511, 700)


def _hm_pages(torch, rng, pages, hkv, ps, d, int8, head_major=False):
    """Seeded page-major [P, Hkv, ps, D] (or head-major [Hkv, P, ps, D])
    pages: bf16 randn rows, or int8 rows with f32 scales of 0.005..0.025.
    Returns (k, v, ks, vs), the scales None for bf16."""
    shape = (hkv, pages, ps, d) if head_major else (pages, hkv, ps, d)
    if not int8:
        return (*(torch.randn(shape, generator=rng, device="cuda").to(torch.bfloat16)
                  for _ in range(2)), None, None)
    sshape = shape[:2] + (1, ps)
    return (*(torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8, device="cuda")
              for _ in range(2)),
            *(torch.rand(sshape, generator=rng, device="cuda") * 0.02 + 0.005
              for _ in range(2)))


def _hm_rows(torch, cache, scales, bt, head_major=False):
    """The pages of bt [B, MP] gathered as bf16 [B, Hkv, MP*ps, D],
    dequantised as f32(row * scale) for int8 (the SDPA yardsticks' input)."""
    b, mp = bt.shape
    btl = bt.long()
    if head_major:
        vals, sc = cache[:, btl].transpose(0, 1), (scales[:, btl].transpose(0, 1)
                                                    if scales is not None else None)
    else:
        vals, sc = cache[btl].transpose(1, 2), (scales[btl].transpose(1, 2)
                                                 if scales is not None else None)
        # [B, Hkv, MP, ps, D]
    hkv, ps, d = vals.shape[1], vals.shape[3], vals.shape[4]
    rows = vals.reshape(b, hkv, mp * ps, d).float()
    if sc is not None:
        rows = rows * sc.reshape(b, hkv, mp * ps, 1)
    return rows.to(torch.bfloat16)


def _hm_decode_shape(torch, rng, cfg, shape):
    """"bench": bench.py's decode (128 sequences, 512-token pages, one page
    each; cached 256..383 with 0, 1, 255, 511 among them); "engine": the
    engine's (8 sequences, 128-token pages, 6 each, phase 2's lengths).
    Returns (b, ps, mp, cached [B] int32, block table)."""
    if shape == "bench":
        b, ps, mp = BENCH_BATCH, 512, 1
        cached = torch.randint(256, 384, (b,), generator=rng, device="cuda",
                               dtype=torch.int32)
        cached[:4] = torch.tensor([0, 1, 255, 511], dtype=torch.int32)
    else:
        b, ps, mp = len(HM_ENGINE_CACHED), cfg.page_size, 6
        cached = torch.tensor(HM_ENGINE_CACHED, dtype=torch.int32, device="cuda")
    pages = b * mp + 1
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    return b, ps, mp, cached, bt


def _hm_yardstick(torch, q, rows_k, rows_v, live, new, sm):
    """SDPA over gathered bf16 rows (the kv heads as SDPA heads, their G
    query heads as queries), the new token's row appended when `new`."""
    b, hq, d = q.shape
    hkv = rows_k.shape[1]
    kk, vv = rows_k, rows_v
    if new is not None:
        kk = torch.cat([kk, new[0][:, :, None]], 2)
        vv = torch.cat([vv, new[1][:, :, None]], 2)
        live = torch.cat([live, torch.ones_like(live[:, :1])], 1)
    qq = q.reshape(b, hkv, hq // hkv, d)
    library, backend = _sdpa_yardstick(torch, qq, kk.contiguous(), vv.contiguous(),
                                       live[:, None, None, :], sm)
    return library, backend, (lambda: library().reshape(b, hq, d))


def _hm_decode_bytes(cached, b, hkv, hq, d, mp, int8, new):
    tok = float(cached.clamp_min(0).double().sum())
    elt = 1 if int8 else 2
    return (tok * hkv * (2 * d * elt + (8 if int8 else 0)) + 2 * 2 * b * hq * d
            + (2 * 2 * b * hkv * d if new else 0) + 4 * b + 4 * b * mp), tok


def check_decode_v6(torch, dv6, cfg, rng):
    """K14 (both contracts, bf16 and int8 pages) at the bench decode shape
    (128 sequences of 256..383 cached tokens, 512-token pages) and the
    engine's (8 sequences, 128-token pages, 6 each), against its plain
    version. Returns the bench shape's rows by contract."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sm = d ** -0.5
    rows = {}
    for shape in ("bench", "engine"):
        b, ps, mp, cached, bt = _hm_decode_shape(torch, rng, cfg, shape)
        q = (1.5 * torch.randn((b, hq, d), generator=rng, device="cuda")).to(torch.bfloat16)
        kn, vn = (torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        for int8 in (False, True):
            name = "decode_v6_int8_defer" if int8 else "decode_v6_defer"
            k, v, ks, vs = _hm_pages(torch, rng, b * mp + 1, hkv, ps, d, int8)
            fn = dv6.decode_gqa_v6_int8_defer if int8 else dv6.decode_gqa_v6_defer
            args = (q, kn, vn, k, v, *((ks, vs) if int8 else ()), cached, bt, sm, ps)

            def plain():
                return dv6.decode_gqa_v6_defer_ref(q, kn, vn, k, v, cached, bt, sm,
                                                   k_scales=ks, v_scales=vs)
            out, ref = fn(*args), plain()
            torch.cuda.synchronize()
            err, ratio = _bf16_check(f"{name} {shape}", out, ref, K14_SHARE)
            ms = _time_ms(lambda: fn(*args), 50, graph=True)
            plain_ms = _time_ms(plain, 3)
            live = torch.arange(mp * ps, device="cuda")[None, :] < cached[:, None]
            library, backend, lib_out = _hm_yardstick(
                torch, q, _hm_rows(torch, k, ks, bt), _hm_rows(torch, v, vs, bt), live,
                (kn, vn), sm)
            lib_err = (lib_out().float() - ref.float()).abs().max().item()
            lib = _time_ms(library, 20, graph=True)
            nbytes, tok = _hm_decode_bytes(cached, b, hkv, hq, d, mp, int8, True)
            bound, by = _bound_ms(nbytes, 4.0 * (tok + b) * hq * d, "bf16_flops")
            print(f"  {name} ({shape}) B={b} Hq={hq} Hkv={hkv} ps={ps} MP={mp} cached "
                  f"{int(cached.min())}..{int(cached.max())} (sum {int(tok)}): max-abs "
                  f"{err:.3g} ({ratio:.3g} of its bound, max|plain| "
                  f"{float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, SDPA ({backend}) {lib:.4f} ms (max-abs vs plain "
                  f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
            if shape == "bench":
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)
            del k, v, ks, vs
    return rows


def check_decode_v6_edges(torch, dv6):
    """K14 where its page steps, kept scores and head groups meet their
    edges, bf16 and int8 pages: 1, 2, 4, 8 and 16 query heads a kv head (16:
    two blocks of 8), pages of 16, 100 (not a power of 2) and 512 tokens,
    cached 0, 1, ps - 1, ps, ps + 1, 2 ps + 3 and 4 ps over a block table of
    4 pages, and one page of 44,800 tokens (its kept scores past shared
    memory, in device memory: decode_v6.cu's skt_*_kept must say so there,
    and 0 at the other pages); within one bf16 ulp + K14_SHARE of
    max|plain|, a second call bit-identical."""
    from sgl_kernel_npu_tpu_torch import _build
    rng = torch.Generator(device="cuda")
    rng.manual_seed(620)
    hkv, d = 2, 128
    notes = []
    for ps, mp in ((16, 4), (100, 4), (512, 4), (44800, 1)):
        lens = [min(n, mp * ps) for n in (0, 1, ps - 1, ps, ps + 1, 2 * ps + 3, 4 * ps)]
        b = len(lens)
        pages = b * mp + 1
        cached = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        kn, vn = (torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        errs = []
        for int8 in (False, True):
            k, v, ks, vs = _hm_pages(torch, rng, pages, hkv, ps, d, int8)
            for g in (1, 2, 4, 8, 16):
                q = (1.5 * torch.randn((b, hkv * g, d), generator=rng, device="cuda")
                     ).to(torch.bfloat16)
                if int8:
                    args = (q, kn, vn, k, v, ks, vs, cached, bt, d ** -0.5, ps)
                    fn = dv6.decode_gqa_v6_int8_defer
                else:
                    args = (q, kn, vn, k, v, cached, bt, d ** -0.5, ps)
                    fn = dv6.decode_gqa_v6_defer
                name = "decode_v6_int8_defer" if int8 else "decode_v6_defer"
                kept = _build.query(name, "kept", g // dv6.v6_groups(g), ps)
                if (kept > 0) != (ps == 44800):
                    raise AssertionError(f"{name} ps {ps} G {g}: kept scores take {kept} "
                                         "floats of device memory")
                out, again = fn(*args), fn(*args)
                ref = dv6.decode_gqa_v6_defer_ref(q, kn, vn, k, v, cached, bt, d ** -0.5,
                                                  k_scales=ks, v_scales=vs)
                torch.cuda.synchronize()
                label = f"decode_v6 edges ps {ps} G {g} {'int8' if int8 else 'bf16'}"
                _, ratio = _bf16_check(label, out, ref, K14_SHARE)
                if not torch.equal(out, again):
                    raise AssertionError(f"{label}: a second call differs")
                errs.append(ratio)
            del k, v, ks, vs
        notes.append(f"ps {ps}: at most {max(errs):.3g} of the bound")
    print("  decode_v6 edges (G 1, 2, 4, 8, 16; bf16 and int8; cached 0, 1, ps - 1, ps, "
          "ps + 1, 2 ps + 3, 4 ps within 4 pages, one at ps 44800): " + "; ".join(notes)
          + "; second calls bit-identical")


def check_decode_v3(torch, dv3, dec, cfg, rng):
    """K16's five contracts at the bench decode shape (128 sequences, one
    512-token page each): decode_v3 and decode_v3_int8 (the current token in
    the cache: seq_lens 1..512), the two deferred ones (cached 0..511 plus
    the new token), and decode_int8kv on head-major int8 pages; against
    their plain versions. Returns the rows by contract."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sm = d ** -0.5
    b, ps, mp, cached, bt = _hm_decode_shape(torch, rng, cfg, "bench")
    seq = cached + 1
    q = (1.5 * torch.randn((b, hq, d), generator=rng, device="cuda")).to(torch.bfloat16)
    new = tuple(torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
                for _ in range(2))
    rows = {}
    for name in ("decode_v3", "decode_v3_int8", "decode_v3_defer", "decode_v3_int8_defer",
                 "decode_int8kv"):
        int8, defer, hmaj = "int8" in name, "defer" in name, name == "decode_int8kv"
        k, v, ks, vs = _hm_pages(torch, rng, b * mp + 1, hkv, ps, d, int8, head_major=hmaj)
        lens = cached if defer else seq
        sc = (ks, vs) if int8 else ()
        if hmaj:
            args = (q, k, v, ks, vs, lens, bt, sm, ps)
            fn = dec.decode_gqa_int8kv

            def plain():
                return dec.decode_gqa_int8kv_ref(*args)
        else:
            args = ((q, *new) if defer else (q,)) + (k, v, *sc, lens, bt, sm, ps)
            fn = getattr(dv3, "decode_gqa_" + name[len("decode_"):])

            def plain():
                return dv3.decode_gqa_v3_ref(q, k, v, lens, bt, sm, k_scales=ks, v_scales=vs,
                                             k_new=new[0] if defer else None,
                                             v_new=new[1] if defer else None)
        out, ref = fn(*args), plain()
        torch.cuda.synchronize()
        err, ratio = _bf16_check(name, out, ref, HM_SHARE)
        ms = _time_ms(lambda: fn(*args), 50, graph=True)
        plain_ms = _time_ms(plain, 3)
        live = torch.arange(mp * ps, device="cuda")[None, :] < lens[:, None]
        library, backend, lib_out = _hm_yardstick(
            torch, q, _hm_rows(torch, k, ks, bt, hmaj), _hm_rows(torch, v, vs, bt, hmaj), live,
            new if defer else None, sm)
        lib_err = (lib_out().float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 20, graph=True)
        nbytes, tok = _hm_decode_bytes(lens, b, hkv, hq, d, mp, int8, defer)
        # q . k and three p . v products a (token, head) on the bf16 tensor cores
        bound, by = _bound_ms(nbytes, 8.0 * (tok + (b if defer else 0)) * hq * d, "bf16_flops")
        print(f"  {name} B={b} Hq={hq} Hkv={hkv} ps={ps} lens {int(lens.min())}.."
              f"{int(lens.max())} (sum {int(tok)}){' + the new token' if defer else ''}: "
              f"max-abs {err:.3g} ({ratio:.3g} of its bound, max|plain| "
              f"{float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA ({backend}) {lib:.4f} ms (max-abs vs plain "
              f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                          bound_by=by, max_abs_err=err)
        del k, v, ks, vs
    return rows


# K16's and K23's edges: (ps, MP) over a batch of 7 at 2 kv heads, which
# splits each row over blocks; ps 8192 is two softmax steps of a page
V3_EDGE_PAGES = ((16, 4), (100, 4), (512, 4), (8192, 1))


def _v3_edge_lens(ps, mp):
    """0, 1, ps - 1, ps, ps + 1, 2 ps + 3 and 4 ps, capped at MP ps."""
    return [min(n, mp * ps) for n in (0, 1, ps - 1, ps, ps + 1, 2 * ps + 3, 4 * ps)]


def check_decode_v3_edges(torch, dv3, dec, dv4):
    """K16's and K23's contracts (csrc/decode_v3.cu) where the loop meets its
    edges, against their plain versions within one bf16 ulp + HM_SHARE of
    max|plain|, each second call bit-identical: 7 sequences over 2 kv heads
    (rows split over blocks: skt_*_splits must say S > 1), pages of 16, 100
    and 512 tokens over 4 pages and one of 8,192 (two softmax steps of 4,096
    within it), lengths 0, 1, ps - 1, ps, ps + 1, 2 ps + 3 and 4 ps (capped
    at MP ps; the deferred ones as cached lengths, so cached 0 too). The
    page-major contracts (decode_v3, decode_v3_defer, bf16 and int8) at G 1,
    4, 8 and 16 (16: two blocks of 8); decode_int8kv, decode_v4b_int8 (a
    stacked cache of 3 layers, the layer a device tensor) and both fused
    contracts (the slot at the current token's position; the written caches
    equal to the plain version's) at G 4 and 16."""
    from sgl_kernel_npu_tpu_torch import _build
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1717)
    hkv, d, b, layers = 2, 128, 7, 3
    sm = d ** -0.5
    li = torch.tensor(1, dtype=torch.int32, device="cuda")
    worst, calls, least_s = 0.0, 0, 8
    dev = "cuda"

    def held(label, fn, plain):
        nonlocal worst, calls
        out, again = fn(), fn()
        ref = plain()
        torch.cuda.synchronize()
        _, ratio = _bf16_check(label, out, ref, HM_SHARE)
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: a second call differs")
        worst, calls = max(worst, ratio), calls + 1

    for ps, mp in V3_EDGE_PAGES:
        lens = _v3_edge_lens(ps, mp)
        pages = b * mp + 1
        cached = torch.tensor(lens, dtype=torch.int32, device=dev)
        bt = (torch.randperm(pages - 1, generator=rng, device=dev)[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        kn, vn = (torch.randn((b, hkv, d), generator=rng, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        for int8 in (False, True):
            k, v, ks, vs = _hm_pages(torch, rng, pages, hkv, ps, d, int8)
            sc = (ks, vs) if int8 else ()
            tag = "int8" if int8 else "bf16"
            for g in (1, 4, 8, 16):
                q = (1.5 * torch.randn((b, hkv * g, d), generator=rng, device=dev)
                     ).to(torch.bfloat16)
                name = "decode_v3_int8" if int8 else "decode_v3"
                ng = dv3.v3_groups(g)
                least_s = min(least_s, _build.splits(name, b, hkv, g // ng, ng, mp, ps))
                fin = getattr(dv3, "decode_gqa_v3" + ("_int8" if int8 else ""))
                fde = getattr(dv3, "decode_gqa_v3" + ("_int8" if int8 else "") + "_defer")
                held(f"{name} edges ps {ps} G {g}",
                     lambda: fin(q, k, v, *sc, cached, bt, sm, ps),
                     lambda: dv3.decode_gqa_v3_ref(q, k, v, cached, bt, sm, k_scales=ks,
                                                   v_scales=vs))
                held(f"{name}_defer edges ps {ps} G {g}",
                     lambda: fde(q, kn, vn, k, v, *sc, cached, bt, sm, ps),
                     lambda: dv3.decode_gqa_v3_ref(q, k, v, cached, bt, sm, k_scales=ks,
                                                   v_scales=vs, k_new=kn, v_new=vn))
            del k, v, ks, vs
            # the stacked caches (layer 1 of 3), the fused write's slot at
            # the current token's position, cached < MP ps
            shape = (layers, pages, hkv, ps, d)
            if int8:
                sk, sv = (torch.randint(-127, 128, shape, generator=rng, dtype=torch.int8,
                                        device=dev) for _ in range(2))
                sks, svs = (torch.rand(shape[:3] + (1, ps), generator=rng, device=dev) * 0.02
                            + 0.005 for _ in range(2))
                caches = [sk, sv, sks, svs]
            else:
                caches = [torch.randn(shape, generator=rng, device=dev).to(torch.bfloat16)
                          for _ in range(2)]
            fc = cached.clamp_max(mp * ps - 1)
            seq = fc + 1
            slots = _slots_of(torch, bt, fc, ps)
            for g in (4, 16):
                q = (1.5 * torch.randn((b, hkv * g, d), generator=rng, device=dev)
                     ).to(torch.bfloat16)
                if int8:
                    hk, hv, hks, hvs = _hm_pages(torch, rng, pages, hkv, ps, d, True,
                                                 head_major=True)
                    held(f"decode_int8kv edges ps {ps} G {g}",
                         lambda: dec.decode_gqa_int8kv(q, hk, hv, hks, hvs, cached, bt, sm, ps),
                         lambda: dec.decode_gqa_int8kv_ref(q, hk, hv, hks, hvs, cached, bt, sm))
                    del hk, hv, hks, hvs
                    held(f"decode_v4b_int8 edges ps {ps} G {g}",
                         lambda: dv4.decode_v4b_int8(q, *caches, cached, bt, li, sm, ps)[0],
                         lambda: dv4.decode_v4b_int8_ref(q, *caches, cached, bt, li, sm)[0])
                name = "decode_fused_v4_int8" if int8 else "decode_fused_v4"
                kfn = dv4.decode_fused_v4_int8 if int8 else dv4.decode_fused_v4
                pfn = dv4.decode_fused_v4_int8_ref if int8 else dv4.decode_fused_v4_ref
                twin = [c.clone() for c in caches]
                held(f"{name} edges ps {ps} G {g}",
                     lambda: kfn(q, kn, vn, *caches, seq, bt, slots, li, sm, ps)[0],
                     lambda: pfn(q, kn, vn, *twin, seq, bt, slots, li, sm)[0])
                if not all(torch.equal(a, t) for a, t in zip(caches, twin)):
                    raise AssertionError(f"{name} edges ps {ps} G {g}: the caches differ from "
                                         "the plain version's")
                del twin
            del caches
        torch.cuda.empty_cache()
    if least_s < 2:
        raise AssertionError(f"decode_v3 edges: a batch of {b} took S = {least_s}, unsplit")
    print(f"  decode_v3 / K23 edges ({calls} contract calls: G 1, 4, 8, 16 page-major bf16 and "
          f"int8, in the cache and deferred; decode_int8kv, decode_v4b_int8 and both fused "
          f"contracts at G 4 and 16; ps 16 / 100 / 512 over 4 pages and 8192 over one; lengths "
          f"0, 1, ps - 1, ps, ps + 1, 2 ps + 3, 4 ps; B {b}, S >= {least_s}): at most "
          f"{worst:.3g} "
          f"of the bound, second calls bit-identical, fused writes equal to the plain "
          f"version's")


# K15's edges (each on its own seed): (ps, T, prefix) with a prefix off a
# page edge and on one, the last query tile partial
K15_EDGES = tuple((ps, 200, pre) for ps in (16, 32, 64, 128) for pre in (ps + 5, 2 * ps))


def check_prefill_hm_edges(torch, pp, cfg):
    """K15 at its edges against its plain version, bf16 and int8 pages at
    Llama-3-8B's heads: page sizes 16, 32, 64 and 128 with a prefix off and
    on a page edge (K15_EDGES); per-kv-head page_sel lists over int8 pages
    (out of order, an empty list, a first page invisible to every row); and
    a tile whose whole list lies past its rows (each row keeps the mean of V
    over the masked columns, as the TPU kernel's p = 1 gives it)."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sm = d ** -0.5
    for i, (ps, t, prefix) in enumerate(K15_EDGES):
        gen = torch.Generator(device="cuda").manual_seed(1500 + i)
        mp = -(-(prefix + t) // ps) + 1
        bt = (torch.randperm(2 * mp, generator=gen, device="cuda")[:mp].to(torch.int32) + 1)
        q = (1.5 * torch.randn((t, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
        for int8 in (False, True):
            k, v, ks, vs = _hm_pages(torch, gen, 2 * mp + 1, hkv, ps, d, int8)
            kv = {"k": k, "v": v, "ks": ks, "vs": vs} if int8 else (k, v)
            args = (q, kv, bt, prefix, sm, ps)
            out, ref = pp.paged_prefill_attention(*args), pp.paged_prefill_attention_ref(*args)
            torch.cuda.synchronize()
            _bf16_check(f"prefill_hm ps={ps} T={t} prefix={prefix} int8={int8}", out, ref,
                        HM_SHARE)
    gen = torch.Generator(device="cuda").manual_seed(1520)
    t, prefix, ps, mp = 512, 256, cfg.page_size, 6
    bt = (torch.randperm(2 * mp, generator=gen, device="cuda")[:mp].to(torch.int32) + 1)
    q = (1.5 * torch.randn((t, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    k, v, ks, vs = _hm_pages(torch, gen, 2 * mp + 1, hkv, ps, d, True)
    kv = {"k": k, "v": v, "ks": ks, "vs": vs}
    sel = torch.zeros((hkv, t // ps, 4), dtype=torch.int32, device="cuda")
    cnt = torch.zeros((hkv, t // ps), dtype=torch.int32, device="cuda")
    for h in range(hkv):
        for qi in range(t // ps):
            pages = torch.randperm(mp, generator=gen, device="cuda")[: (h + qi) % 5]
            sel[h, qi, :len(pages)] = pages.to(torch.int32)
            cnt[h, qi] = len(pages)
    sel[0, 0, :2] = torch.tensor([4, 0], dtype=torch.int32)     # the first page hides all
    cnt[0, 0] = 2
    args = (q, kv, bt, prefix, sm, ps)
    out = pp.paged_prefill_attention(*args, page_sel=sel, page_cnt=cnt)
    ref = pp.paged_prefill_attention_ref(*args, page_sel=sel, page_cnt=cnt)
    torch.cuda.synchronize()
    _bf16_check("prefill_hm int8 page_sel per kv head", out, ref, HM_SHARE)
    g = hq // hkv
    for h in range(hkv):
        for qi in range(t // ps):
            if int(cnt[h, qi]) == 0 and float(
                    out[qi * ps:(qi + 1) * ps, h * g:(h + 1) * g].float().abs().max()) != 0.0:
                raise AssertionError("prefill_hm: a tile with an empty page list is not 0")
    # tile 0 (positions 256..383) sees only pages 4 and 5 (512..767): nothing
    sel2 = torch.tensor([[4, 5], [0, 1], [2, 3], [5, 4]], dtype=torch.int32, device="cuda")
    cnt2 = torch.tensor([2, 2, 2, 2], dtype=torch.int32, device="cuda")
    for int8 in (False, True):
        k, v, ks, vs = _hm_pages(torch, gen, 2 * mp + 1, hkv, ps, d, int8)
        kv = {"k": k, "v": v, "ks": ks, "vs": vs} if int8 else (k, v)
        args = (q, kv, bt, prefix, sm, ps)
        out = pp.paged_prefill_attention(*args, page_sel=sel2, page_cnt=cnt2)
        ref = pp.paged_prefill_attention_ref(*args, page_sel=sel2, page_cnt=cnt2)
        torch.cuda.synchronize()
        _bf16_check(f"prefill_hm all-invisible tile int8={int8}", out, ref, HM_SHARE)
        rows_v = _hm_rows(torch, v, vs, bt[None])[0, :, 4 * ps:6 * ps].float()   # [Hkv, 256, D]
        mean_v = rows_v.mean(1).repeat_interleave(g, 0)                          # [Hq, D]
        _bf16_check(f"prefill_hm all-invisible tile = mean of V int8={int8}", out[:ps].float(),
                    mean_v[None].expand(ps, hq, d), 2e-3)
    print(f"  prefill_hm within its bar also at ps 16 / 32 / 64 / 128 with prefixes off and on "
          f"a page edge ({len(K15_EDGES)} cases, bf16 and int8), per-kv-head page_sel over int8 "
          "pages (empty lists 0), and a tile whose whole list is invisible (the mean of V)")


def check_prefill_hm(torch, pp, cfg, rng):
    """K15 on a 512-token chunk over a 256-token prefix (Llama-3-8B's 32 / 8
    heads, 128-token pages, the dense causal schedule of four 128-token
    tiles), bf16 and int8 pages, against its plain version; a page_sel drive
    with an empty tile on the bf16 pages too; then its edges
    (check_prefill_hm_edges). Returns the bf16 and the int8 rows."""
    hq, hkv, d, ps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    g, sm = hq // hkv, d ** -0.5
    t, prefix, mp = 512, 256, 6
    n = prefix + t
    bt = (torch.randperm(2 * mp, generator=rng, device="cuda")[:mp].to(torch.int32) + 1)
    q = (1.5 * torch.randn((t, hq, d), generator=rng, device="cuda")).to(torch.bfloat16)
    rows = {}
    plen = torch.tensor(prefix, dtype=torch.int32, device="cuda")   # no copy in a graph
    for int8 in (False, True):
        k, v, ks, vs = _hm_pages(torch, rng, 2 * mp + 1, hkv, ps, d, int8)
        kv = {"k": k, "v": v, "ks": ks, "vs": vs} if int8 else (k, v)
        args = (q, kv, bt, plen, sm, ps)
        out, ref = pp.paged_prefill_attention(*args), pp.paged_prefill_attention_ref(*args)
        torch.cuda.synchronize()
        kind = "int8" if int8 else "bf16"
        err, ratio = _bf16_check(f"prefill_hm {kind}", out, ref, HM_SHARE)
        if not int8:
            sel = torch.tensor([[3, 0, 1, 0], [0, 0, 0, 0], [5, 4, 2, 0], [1, 0, 0, 0]],
                               dtype=torch.int32, device="cuda")
            cnt = torch.tensor([3, 0, 3, 1], dtype=torch.int32, device="cuda")
            sout = pp.paged_prefill_attention(*args, page_sel=sel, page_cnt=cnt)
            sref = pp.paged_prefill_attention_ref(*args, page_sel=sel, page_cnt=cnt)
            torch.cuda.synchronize()
            _bf16_check("prefill_hm page_sel", sout, sref, HM_SHARE)
            if float(sout[128:256].float().abs().max()) != 0.0:
                raise AssertionError("prefill_hm: a tile with an empty page list is not 0")
        ms = _time_ms(lambda: pp.paged_prefill_attention(*args), 20, graph=True)
        plain_ms = _time_ms(lambda: pp.paged_prefill_attention_ref(*args), 2, 1)
        btr = bt[None]
        kk = _hm_rows(torch, k, ks, btr)[:, :, :n]
        vv = _hm_rows(torch, v, vs, btr)[:, :, :n]
        qq = q.reshape(t, hkv, g, d).permute(1, 0, 2, 3).reshape(1, hkv, t * g, d).contiguous()
        tok = torch.arange(t * g, device="cuda") // g
        mask = (torch.arange(n, device="cuda")[None, :] <= prefix + tok[:, None])[None, None]
        library, backend = _sdpa_yardstick(torch, qq, kk.contiguous(), vv.contiguous(), mask,
                                           sm)
        lib_out = library().reshape(hkv, t, g, d).permute(1, 0, 2, 3).reshape(t, hq, d)
        lib_err = (lib_out.float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 10, graph=True)
        elt = 1 if int8 else 2
        nbytes = n * hkv * (2 * d * elt + (8 if int8 else 0)) + 2 * 2 * t * hq * d + 4 * mp
        keys = sum(prefix + i + 1 for i in range(t))
        bound, by = _bound_ms(nbytes, 4.0 * keys * hq * d, "bf16_flops")
        print(f"  prefill_hm {kind} T={t} prefix={prefix} Hq={hq} Hkv={hkv} ps={ps} "
              f"(block_q 128, dense causal{'; page_sel with an empty tile also held' if not int8 else ''}): "
              f"max-abs {err:.3g} ({ratio:.3g} of its bound, max|plain| "
              f"{float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA ({backend}, causal) {lib:.4f} ms (max-abs vs plain "
              f"{lib_err:.3g}), bound {bound:.4f} ms ({by}; the floor of the three-part P . V "
              f"{2 * bound if by == 'operations' else bound:.4f})")
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                          max_abs_err=err)
        del k, v, ks, vs, kv
    check_prefill_hm_edges(torch, pp, cfg)
    return rows["bf16"], rows["int8"]


# ------------------------------------------------- tie-prone inputs (B, K5, K17, K21, K15)


def _pairs(x, dim):
    """x with every odd index along `dim` a copy of the even one before it:
    every score then has a twin, so a softmax's maximum is a tie."""
    idx = (x.new_ones(x.shape[dim], dtype=x.dtype).long().cumsum(0) - 1) // 2 * 2
    return x.index_select(dim, idx).contiguous()


def _ulp_apart(torch, x, dim):
    """x (bf16 or int8) with every odd index along `dim` one unit (a bf16 ulp,
    or 1 of int8) from the even one before it: each tied pair of keys
    averages two values a unit apart, which lands on a rounding edge."""
    y = _pairs(x, dim)
    odd = torch.arange(x.shape[dim], device=x.device) % 2 == 1
    shape = [1] * x.dim()
    shape[dim] = -1
    odd = odd.reshape(shape)
    if x.dtype == torch.int8:
        return torch.where(odd & (y < 127), y + 1, y).to(torch.int8).contiguous()
    bits = y.view(torch.int16)
    return torch.where(odd, bits + 1, bits).view(torch.bfloat16).contiguous()


def _tie_report(name, out, ref, err, ratio, bar):
    same = float((out.float() == ref.float()).float().mean())
    print(f"  tie-prone {name}: max-abs {err:.3g} ({ratio:.3g} of its phase-1 bar, {bar}); "
          f"{1 - same:.4%} of the outputs differ from the plain version's")


def check_tie_prone(torch, pp_tm, dv2, pf, pp_hm, mm, cfg, mcfg):
    """Each tensor-core kernel whose sums were not promoted to f32
    round-to-nearest, against its plain version on inputs where that would
    show: keys in tied pairs (every softmax maximum a tie; q scaled up so
    that the pairs dominate) whose values sit a unit apart, so the exact
    outputs lie on bf16 rounding edges; for K21, products whose sum sits on
    the midpoint between 1 and the next bf16 value, with residues near an
    f32 ulp. B (int8 tm pages + a bf16 chunk), K5 (int8 and bf16 latent
    rows), K17 (T 1024, causal), K15's int8 body, K21 (M 128, K 256, N
    384). Each must stay within its phase-1 bar; prints the share of outputs
    that differ from the plain version's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(600)
    hq, hkv, d, ps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    sm = d ** -0.5
    # B: the first prefill case's shapes
    pages, mp, layers, li = 64, 8, 2, 1
    kc, vc, ks, vs = _tm_cache(torch, gen, layers, pages, ps, hkv, d)
    tm = (layers, pages, ps, hkv, d)
    kc = _pairs(kc.view(tm), 2).view(kc.shape)
    vc = _ulp_apart(torch, vc.view(tm), 2).view(vc.shape)
    ks = _pairs(ks.view(layers, pages, 1, ps, hkv), 3).view(ks.shape)
    vs = _pairs(vs.view(layers, pages, 1, ps, hkv), 3).view(vs.shape)
    plen = torch.tensor([256, 384], dtype=torch.int32, device="cuda")
    vlen = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
    bt = _block_tables(torch, gen, (plen + vlen).tolist(), mp, pages, ps)
    t = 256
    q = (3 * torch.randn((2, t, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    ck = _pairs(torch.randn((2, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16), 1)
    cv = _ulp_apart(torch, torch.randn((2, t, hkv, d), generator=gen, device="cuda")
                    .to(torch.bfloat16), 1)
    args = (q, ck, cv, kc, vc, ks, vs, bt, plen, vlen, sm, ps)
    out = pp_tm.paged_prefill_attention_tm(*args, layer_idx=li)
    ref = pp_tm.paged_prefill_attention_tm_ref(*args, layer_idx=li)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"tie-prone prefill_tm: max-abs {err} > {ATTN_TOL}")
    _tie_report("prefill_tm (B)", out, ref, err, err / ATTN_TOL, f"{ATTN_TOL} max-abs")
    del kc, vc, ks, vs
    # K5: latent rows in tied pairs (K and V are one row: the pair is exact)
    b, h, lkv = 64, mcfg.num_heads, mcfg.kv_lora_rank
    c, mps = lkv + mcfg.qk_rope_dim, 3
    pages = b * mps + 1
    cached = torch.randint(1, mps * mcfg.page_size, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    btm = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mps]
           .reshape(b, mps).to(torch.int32) + 1)
    qm = (3 * torch.randn((b, h, c), generator=gen, device="cuda")).to(torch.bfloat16)
    new = torch.randn((b, c), generator=gen, device="cuda").to(torch.bfloat16)
    smm = (mcfg.qk_nope_dim + mcfg.qk_rope_dim) ** -0.5
    for int8 in (True, False):
        cache = _pairs(_latent_rows(torch, gen, (2, pages, mcfg.page_size, c), int8), 2)
        scales = (_pairs(torch.rand((2, pages, 1, mcfg.page_size), generator=gen,
                                    device="cuda") * 0.02 + 0.005, 3) if int8 else None)
        margs = (qm, new, cache, cached, btm, smm, mcfg.page_size, lkv)
        out = dv2.decode_mla_v3_defer(*margs, layer_idx=1, kv_scales=scales)
        ref = dv2._decode_chunks_ref(qm, new, cache, scales, cached, btm, smm, mcfg.page_size,
                                     lkv, 1, dv2._chunk_pages(mps))
        torch.cuda.synchronize()
        kind = "int8" if int8 else "bf16"
        err, ratio = _bf16_check(f"tie-prone decode_mla_c {kind}", out, ref, K5_SHARE)
        _tie_report(f"decode_mla_c {kind} (K5)", out, ref, err, ratio,
                    f"one bf16 ulp + {K5_SHARE} of max|plain|")
        del cache
    # K17: causal T 1024 at Llama-3-8B's heads
    tl = 1024
    ql = (3 * torch.randn((1, ATT_HQ, tl, ATT_D), generator=gen, device="cuda")).to(torch.bfloat16)
    kl = _pairs(torch.randn((1, ATT_HKV, tl, ATT_D), generator=gen, device="cuda")
                .to(torch.bfloat16), 2)
    vl = _ulp_apart(torch, torch.randn((1, ATT_HKV, tl, ATT_D), generator=gen, device="cuda")
                    .to(torch.bfloat16), 2)
    out = pf.laser_attention(ql, kl, vl, sm, True)
    ref = pf.laser_attention_blocked_ref(ql, kl, vl, sm, True)
    torch.cuda.synchronize()
    err, ratio = _bf16_check("tie-prone laser_attention", out, ref, ATT_SHARE)
    _tie_report("laser_attention T=1024 causal (K17)", out, ref, err, ratio,
                f"one bf16 ulp + {ATT_SHARE} of max|plain|")
    # K15's int8 body: 512 tokens over a 256-token prefix on int8 hm pages
    th, prefix, mph = 512, 256, 6
    bth = (torch.randperm(2 * mph, generator=gen, device="cuda")[:mph].to(torch.int32) + 1)
    qh = (3 * torch.randn((th, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    k, v, ks, vs = _hm_pages(torch, gen, 2 * mph + 1, hkv, ps, d, True)
    kv = {"k": _pairs(k, 2), "v": _ulp_apart(torch, v, 2), "ks": _pairs(ks, 3),
          "vs": _pairs(vs, 3)}
    hargs = (qh, kv, bth, torch.tensor(prefix, dtype=torch.int32, device="cuda"), sm, ps)
    out, ref = pp_hm.paged_prefill_attention(*hargs), pp_hm.paged_prefill_attention_ref(*hargs)
    torch.cuda.synchronize()
    err, ratio = _bf16_check("tie-prone prefill_hm int8", out, ref, HM_SHARE)
    _tie_report("prefill_hm int8 (K15's int8 body)", out, ref, err, ratio,
                f"one bf16 ulp + {HM_SHARE} of max|plain|")
    # K21: out = 1 + 2^-8 + a residue of about an f32 ulp at 1
    m, kk, n = 128, 256, 384
    x = torch.randint(-4, 5, (m, kk), generator=gen, device="cuda").float() * 2.0 ** -24
    x[:, 0], x[:, 1] = 1.0, 2.0 ** -8
    w = (torch.randint(8, 16, (kk, n), generator=gen, device="cuda").float() / 8.0
         * torch.where(torch.rand((kk, n), generator=gen, device="cuda") < 0.5, -1.0, 1.0))
    w[0], w[1] = 1.0, 1.0
    x = x.to(torch.bfloat16)
    w = w.to(torch.float8_e4m3fn)
    s = torch.ones((2, 3), dtype=torch.float32, device="cuda")
    out, ref = mm.mm_wfp8a16(x, w, s), mm.mm_wfp8a16_ref(x, w, s)
    torch.cuda.synchronize()
    err, ratio = _gemm_check("tie-prone wfp8a16_gemm", out, ref)
    _tie_report("wfp8a16_gemm M=128 K=256 N=384 (K21)", out, ref, err, ratio,
                f"calc_diff {FP8_DIFF} and one bf16 ulp + {FP8_SHARE} of max|plain|")


# ------------------------------------------------------------- the engine


def _prompts(rng, vocab):
    """Six prompts of 40..511 tokens and two that share a 256-token prefix
    (300 and 700 tokens); the second is returned apart, to be added late."""
    prefix = rng.integers(0, vocab, 256).tolist()
    lens = [40, 127, 129, 255, 384, 511]
    first = [rng.integers(0, vocab, n).tolist() for n in lens]
    shared_a = prefix + rng.integers(0, vocab, 44).tolist()        # 300 tokens
    shared_b = prefix + rng.integers(0, vocab, 444).tolist()       # 700 tokens
    return first + [shared_a], shared_b


def _check_call(kind, delta, expect):
    """With `expect` ({"prefill": {...}, "decode": {...}}), the launches of
    one model call must be exactly those listed, and 0 of every other."""
    if expect is None:
        return
    bad = {k: n for k, n in delta.items() if n != expect[kind].get(k, 0)}
    if bad:
        raise AssertionError(f"a {kind} call launched {bad}; expected exactly "
                             f"{expect[kind]} and no other kernel")


def run_engine(torch, serving, build, cfg, params, prompts, late, new_tokens,
               profile=False, engine_cls=None, expect=None, engine_kw=None,
               buckets=None, request_kw=None, on_done=None):
    """Serve `prompts`, then `late` once the first shared-prefix prompt has
    been prefilled (so it reuses the radix-cached prefix). Returns outputs,
    timings, launch counts per step kind and the counts of the whole run;
    with `profile`, afterwards profiles a steady-state decode call split by
    `buckets` (default _ENGINE_BUCKETS; the rest is glue, the largest
    listed); with `expect`, checks the launches of every model call
    (_check_call). request_kw: add_request's keywords for each prompt, then
    for `late`; on_done(eng, stats, decode) is called after the run with the
    engine, the stats (the steady decode call's arguments under
    "steady_args") and the engine's own decode function."""
    kw = dict(num_pages=512, decode_batch=8, token_budget=256)
    kw.update(engine_kw or {})
    eng = (engine_cls or serving.LlamaEngine)(cfg, params=params, device="cuda", **kw)
    req_kw = request_kw or [{}] * (len(prompts) + 1)
    from sgl_kernel_npu_tpu_torch.runtime import NativeScheduler
    if not isinstance(eng.sched, NativeScheduler):
        raise AssertionError("the engine must run on the native scheduler")
    stats = {"prefill_s": 0.0, "prefill_tok": 0, "prefill_steps": 0,
             "decode_s": 0.0, "decode_tok": 0, "decode_steps": 0,
             "per_prefill": None, "per_decode": None}
    inner_pre, inner_dec = eng._prefill_batch, eng._decode

    def prefill(*a):
        torch.cuda.synchronize()
        t0, c = time.perf_counter(), _Launches(build)
        logits, kv = inner_pre(*a)
        torch.cuda.synchronize()
        stats["prefill_s"] += time.perf_counter() - t0
        stats["prefill_tok"] += int(a[1].sum())
        stats["prefill_steps"] += 1
        stats["per_prefill"] = stats["per_prefill"] or c.delta()
        _check_call("prefill", c.delta(), expect)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        return logits, kv

    def decode(*a):
        torch.cuda.synchronize()
        t0, c = time.perf_counter(), _Launches(build)
        logits, kv = inner_dec(*a)
        torch.cuda.synchronize()
        stats["decode_s"] += time.perf_counter() - t0
        stats["decode_tok"] += int((a[4] >= 0).sum())
        stats["decode_steps"] += 1
        stats["per_decode"] = stats["per_decode"] or c.delta()
        _check_call("decode", c.delta(), expect)
        if stats["decode_steps"] == 8:          # a full batch, kept to profile
            stats["steady_args"] = [x.clone() for x in a]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
        return logits, kv

    eng._prefill_batch, eng._decode = prefill, decode
    rids = [eng.add_request(p, new_tokens, **k) for p, k in zip(prompts, req_kw)]
    late_rid = None
    t0 = time.perf_counter()
    for _ in range(1000):
        if late_rid is None and eng.reqs[rids[-1]]["out"]:
            late_rid = eng.add_request(late, new_tokens, **req_kw[-1])
        if not eng.step() and late_rid is not None:
            break
    wall = time.perf_counter() - t0
    launches = dict(build.launches)      # read before anything else launches
    outs = [eng.reqs[r]["out"] for r in rids + [late_rid]]
    reused = eng.reqs[late_rid]["cached"]
    if profile:
        # re-running the call after the engine has finished rewrites only
        # slots nobody reads
        args = stats["steady_args"]
        profile_step(torch, lambda: inner_dec(*args), buckets or _ENGINE_BUCKETS,
                     "decode call (B=8, all rows live)")
    if on_done is not None:
        on_done(eng, stats, inner_dec)
    del eng
    return outs, stats, wall, reused, launches


def check_small_config(torch, llama):
    """Prefill + 2 decode steps of a small config (D = 128, G = 4, so every
    kernel runs) on the card and on the CPU (plain versions), from the same
    CPU-made weights and inputs: logits within the repo's calc_diff bound
    (8e-3, tests/test_llama_model.py), layer-0 caches exact but for
    rounding-boundary flips of 1."""
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512, num_layers=2,
                            num_heads=8, num_kv_heads=2, head_dim=128,
                            intermediate_size=1024, page_size=16,
                            max_position=512, int8_kv=True)
    rng = np.random.default_rng(7)
    lens, s, t, mp, pages, b = [37, 20], 2, 64, 6, 16, 4
    ps = cfg.page_size
    bts = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 10, 0]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    pos = np.zeros((s, t), np.int32)
    for si, n in enumerate(lens):
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[si, :n] = np.arange(n)
        p = np.arange(n)
        slp[si, :n] = bts[si, p // ps] * ps + p % ps
    steps = []
    for step in range(2):
        cur = [n + step for n in lens]
        ids_d = np.zeros(b, np.int32)
        ids_d[:2] = rng.integers(0, cfg.vocab_size, 2)
        bt = np.zeros((b, mp), np.int32)
        bt[:2] = bts
        sl = np.full(b, -1, np.int32)
        sl[:2] = [bts[i, c // ps] * ps + c % ps for i, c in enumerate(cur)]
        steps.append((ids_d, np.array(cur + [0, 0], np.int32),
                      np.array([c + 1 for c in cur] + [1, 1], np.int32), bt, sl))
    cpu_params = llama.init_params(cfg, 3, "cpu")
    results = {}
    for dev in ("cuda", "cpu"):
        params = _to_device(cpu_params, dev)
        kv = llama.init_kv_cache(cfg, pages, device=dev)

        def tt(a):
            return torch.from_numpy(np.array(a)).to(dev)
        lg, kv = llama.prefill_batch_step_kv(
            params, cfg, kv, tt(ids), tt(np.array(lens, np.int32)), tt(pos), tt(slp),
            tt(bts), torch.zeros(s, dtype=torch.int32, device=dev))
        logits = [lg[si, :n].float().cpu() for si, n in enumerate(lens)]
        for args in steps:
            lg, kv = llama.decode_step_kv(params, cfg, kv, *(tt(a) for a in args))
            logits.append(lg[:2].float().cpu())
        results[dev] = (logits, {k: v.cpu() for k, v in kv.items()})
    diffs = []
    for a, ref in zip(results["cuda"][0], results["cpu"][0]):
        if not bool(torch.isfinite(a).all()) or a.shape != ref.shape:
            raise AssertionError("small-config logits are not finite or misshapen")
        diffs.append(_calc_diff(a, ref))
    if max(diffs) >= 8e-3:
        raise AssertionError(f"small-config logits calc_diff {diffs}")
    match = {}
    for k in ("k", "v"):
        a = results["cuda"][1][k].int()
        ref = results["cpu"][1][k].int()
        match[k] = [float((a[li] == ref[li]).float().mean()) for li in range(2)]
        if match[k][0] < 0.999 or int((a[0] - ref[0]).abs().max()) > 1:
            raise AssertionError(f"small-config layer-0 {k} cache: {match[k][0]:.5f} "
                                 f"exact, max |diff| {int((a[0] - ref[0]).abs().max())}")
    print(f"  small config (L=2, D=128, G=4, ps=16): logits calc_diff max "
          f"{max(diffs):.3g}; cache exact fraction per layer k {match['k']} "
          f"v {match['v']}")


def check_small_tm2(torch, llama):
    """Three decode steps of a small config on tm2 pages with pretiled
    128-wide banks (D = 128, hkv = 8, G = 4, ps = 16, L = 2, B = 8, so K1-K4
    all run), on the card and on the CPU (plain versions), from a cache
    pre-filled with the same seeded rows at position ps - 2 (the steps cross
    a page): logits calc_diff < 8e-3 at each step, layer-0 caches and scales
    >= 99.9% exact with |diff| <= 1 (rounding-boundary flips)."""
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512, num_layers=2,
                            num_heads=32, num_kv_heads=8, head_dim=128,
                            intermediate_size=1024, page_size=16,
                            max_position=512, int8_kv=True)
    rng = np.random.default_rng(11)
    b, mp, ps, hkv, d = 8, 2, cfg.page_size, cfg.num_kv_heads, cfg.head_dim
    pages = b * mp + 1
    shape = (cfg.num_layers, pages, hkv, ps, d)
    cache = {"k": rng.integers(-127, 128, shape, dtype=np.int8),
             "v": rng.integers(-127, 128, shape, dtype=np.int8),
             "ks": (rng.random(shape[:-1]) * 0.02 + 0.001).astype(np.float32),
             "vs": (rng.random(shape[:-1]) * 0.02 + 0.001).astype(np.float32)}
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    steps, pos = [], np.full(b, ps - 2, np.int32)
    for _ in range(3):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        steps.append((rng.integers(0, cfg.vocab_size, b).astype(np.int32), pos,
                      pos + 1, bt, slots))
        pos = pos + 1
    cpu_params = llama.pretile_big_weights(llama.init_params(cfg, 5, "cpu"), block_n=128)
    results = {}
    for dev in ("cuda", "cpu"):
        params = _to_device(cpu_params, dev)
        kv = {k: torch.from_numpy(a).to(dev) for k, a in cache.items()}
        logits = []
        for args in steps:
            lg, kv = llama.decode_step_kv(params, cfg, kv, *(torch.from_numpy(np.array(a))
                                                             .to(dev) for a in args))
            logits.append(lg.float().cpu())
        results[dev] = (logits, {k: v.cpu() for k, v in kv.items()})
    diffs = []
    for a, ref in zip(results["cuda"][0], results["cpu"][0]):
        if not bool(torch.isfinite(a).all()) or a.shape != ref.shape:
            raise AssertionError("small tm2 logits are not finite or misshapen")
        diffs.append(_calc_diff(a, ref))
    if max(diffs) >= 8e-3:
        raise AssertionError(f"small tm2 logits calc_diff {diffs}")
    match = {}
    for k in ("k", "v", "ks", "vs"):
        a, ref = results["cuda"][1][k], results["cpu"][1][k]
        match[k] = [float((a[li] == ref[li]).float().mean()) for li in range(2)]
        worst = (int((a[0].int() - ref[0].int()).abs().max()) if k in ("k", "v") else 0)
        if match[k][0] < 0.999 or worst > 1:
            raise AssertionError(f"small tm2 layer-0 {k}: {match[k][0]:.5f} exact, "
                                 f"max |diff| {worst}")
    print(f"  small tm2 config (L=2, D=128, hkv=8, G=4, ps=16, B=8, bn=128): logits "
          f"calc_diff per step {[f'{x:.3g}' for x in diffs]}; exact fraction per layer "
          + ", ".join(f"{k} {v}" for k, v in match.items()))


class _env:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _hm_small_config(llama, int8):
    return llama.LlamaConfig(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=8,
                             num_kv_heads=2, head_dim=128, intermediate_size=1024,
                             page_size=16, max_position=512, int8_kv=int8)


def check_small_hm(torch, llama, serving):
    """A small config (D = 128, G = 4, ps = 16, L = 2) on page-major caches,
    bf16 and int8, on the card and on the CPU (plain versions), from the same
    CPU-made weights: prefill of 2 chunks (K15), 2 decode steps (v6, K14),
    then from that state one step each of SKT_DECODE_ATTN=v3 and
    SKT_DECODE_DEFER=0 (K16; SKT_DECODE_FLAT=0 runs the same loop as
    DEFER=0, so it is not run again); logits calc_diff < 8e-3,
    layer-0 caches bit-equal (bf16) or >= 99.9% exact with |diff| <= 1
    (int8). Then an hm engine (chunked prefill, radix reuse, a padded decode
    batch) on both: equal greedy tokens."""
    for int8 in (False, True):
        cfg = _hm_small_config(llama, int8)
        rng = np.random.default_rng(13)
        lens, s, t, mp, pages, b = [37, 20], 2, 64, 6, 16, 4
        ps = cfg.page_size
        bts = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 10, 0]], np.int32)
        ids = np.zeros((s, t), np.int32)
        slp = np.full((s, t), -1, np.int32)
        pos = np.zeros((s, t), np.int32)
        for si, n in enumerate(lens):
            ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
            pos[si, :n] = np.arange(n)
            slp[si, :n] = bts[si, np.arange(n) // ps] * ps + np.arange(n) % ps
        steps = []
        for step in range(3):
            cur = [n + step for n in lens]
            ids_d = np.zeros(b, np.int32)
            ids_d[:2] = rng.integers(0, cfg.vocab_size, 2)
            bt = np.zeros((b, mp), np.int32)
            bt[:2] = bts
            sl = np.full(b, -1, np.int32)
            sl[:2] = [bts[i, c // ps] * ps + c % ps for i, c in enumerate(cur)]
            steps.append((ids_d, np.array(cur + [0, 0], np.int32),
                          np.array([c + 1 for c in cur] + [1, 1], np.int32), bt, sl))
        cpu_params = llama.init_params(cfg, 3, "cpu")
        results = {}
        for dev in ("cuda", "cpu"):
            params = _to_device(cpu_params, dev)
            kv = llama.init_kv_cache(cfg, pages, layout="hm", device=dev)

            def tt(a):
                return torch.from_numpy(np.array(a)).to(dev)
            lg, kv = llama.prefill_batch_step_kv(
                params, cfg, kv, tt(ids), tt(np.array(lens, np.int32)), tt(pos), tt(slp),
                tt(bts), torch.zeros(s, dtype=torch.int32, device=dev))
            logits = [lg[si, :n].float().cpu() for si, n in enumerate(lens)]
            for args in steps[:2]:
                lg, kv = llama.decode_step_kv(params, cfg, kv, *(tt(a) for a in args))
                logits.append(lg[:2].float().cpu())
            caches = [_leaves_cpu(kv)]
            for flags in ({"SKT_DECODE_ATTN": "v3"}, {"SKT_DECODE_DEFER": "0"}):
                kv2 = tuple(a.clone() for a in kv) if not int8 else {
                    k: a.clone() for k, a in kv.items()}
                with _env(**flags):
                    lg, kv2 = llama.decode_step_kv(params, cfg, kv2, *(tt(a) for a in steps[2]))
                logits.append(lg[:2].float().cpu())
                caches.append(_leaves_cpu(kv2))
            results[dev] = (logits, caches)
        diffs = [_calc_diff(a, r) for a, r in zip(results["cuda"][0], results["cpu"][0])]
        if not all(bool(torch.isfinite(a).all()) for a in results["cuda"][0]):
            raise AssertionError("small hm logits are not finite")
        if max(diffs) >= 8e-3:
            raise AssertionError(f"small hm ({'int8' if int8 else 'bf16'}) logits calc_diff "
                                 f"{diffs}")
        exact = []
        for cc, cr in zip(results["cuda"][1], results["cpu"][1]):
            for a, r in zip(cc, cr):
                if a.dtype == torch.float32 and a.dim() == 5 and a.shape[-2] == 1:
                    ok = float((a[0] == r[0]).float().mean())          # int8 scales
                    bad = ok < 0.999
                elif int8:
                    ok = float((a[0] == r[0]).float().mean())
                    bad = ok < 0.999 or int((a[0].int() - r[0].int()).abs().max()) > 1
                else:
                    ok = float((a[0] == r[0]).float().mean())
                    bad = ok < 1.0
                exact.append(ok)
                if bad:
                    raise AssertionError(f"small hm layer-0 cache: {ok:.5f} exact")
        tokens = {}
        for dev in ("cuda", "cpu"):
            eng = serving.LlamaEngine(cfg, params=_to_device(cpu_params, dev), num_pages=64,
                                      decode_batch=4, token_budget=64, device=dev,
                                      kv_layout="hm" if int8 else None)
            if (isinstance(eng.kv, tuple)) == int8:
                raise AssertionError("the small engine did not pick hm pages")
            prng = np.random.default_rng(17)
            first = [prng.integers(0, cfg.vocab_size, n).tolist() for n in (37, 21)]
            late = first[0][:32] + prng.integers(0, cfg.vocab_size, 5).tolist()
            rids = [eng.add_request(p, 6) for p in first]
            while not eng.reqs[rids[0]]["out"]:
                eng.step()
            rids.append(eng.add_request(late, 6))
            while eng.step():
                pass
            tokens[dev] = ([eng.reqs[r]["out"] for r in rids], eng.reqs[rids[-1]]["cached"])
        if tokens["cuda"] != tokens["cpu"] or tokens["cuda"][1] != 32:
            raise AssertionError(f"small hm engine: card {tokens['cuda']} vs cpu "
                                 f"{tokens['cpu']}")
        print(f"  small hm config ({'int8' if int8 else 'bf16'}, L=2, D=128, G=4, ps=16): "
              f"logits calc_diff (prefill x2, v6 x2, v3, DEFER=0) "
              f"{[f'{x:.3g}' for x in diffs]}; layer-0 cache exact fraction min "
              f"{min(exact):.5f}; engine tokens equal card vs CPU (radix reuse 32)")


# the small tm engine's prompts (seed, lengths, shared prefixes of two more
# and their new tokens) and greedy tokens a request; its CPU run must take no
# decision on an exact tie
TM_ENGINE_SEED, TM_ENGINE_LENS, TM_ENGINE_SHARED = 19, (70, 45), ((48, 9), (32, 20))
TM_ENGINE_NEW = 6


def _count_tied_decisions(torch, eng):
    """Wrap eng's model calls to count decisions (live decode rows, the last
    row of every prefilled sequence) whose two best logits are equal. The
    count excuses no token: a check fails where its reference takes any."""
    dec, pre = eng._decode, eng._prefill_batch
    ties = [0]

    def count(rows):
        top = rows.float().topk(2, dim=-1).values
        ties[0] += int((top[:, 0] == top[:, 1]).sum())

    def decode(*a):
        lg, kv = dec(*a)
        count(lg[a[4] >= 0])
        return lg, kv

    def prefill(ids, vl, *a):
        lg, kv = pre(ids, vl, *a)
        count(lg[torch.arange(lg.shape[0]), (vl.long() - 1).clamp_min(0)][vl > 0])
        return lg, kv
    eng._decode, eng._prefill_batch = decode, prefill
    return ties


def check_small_tm_engine(torch, llama, serving):
    """A LlamaEngine on int8 token-major pages at a small config (D = 128, G
    = 4, ps = 16, L = 2, so that A, B, C and D all run), card against CPU
    (plain versions) from the same CPU-made weights: two prompts of 70 and
    45 tokens, prefilled in 64-token chunks, then two more that share 48
    and 32 of their tokens (radix reuse), 6 greedy tokens each (as
    check_small_hm) through a padded decode batch of 4. Contexts cross C's
    64-token softmax step (4 pages of 16). Every greedy token must be equal:
    logits a rounding apart would not show a flipped token, this does (B
    stepping its softmax by 64-key tiles instead of by pages turned request
    0's sixth token). A decision on an exact tie of the two best logits is
    made by argmax's order, not by the numbers (any f32 sum in another order
    may break it either way), so the CPU run must take none."""
    from sgl_kernel_npu_tpu_torch import _build
    cfg = llama.LlamaConfig(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=8,
                            num_kv_heads=2, head_dim=128, intermediate_size=1024,
                            page_size=16, max_position=512, int8_kv=True)
    cpu_params = llama.init_params(cfg, 3, "cpu")
    tokens = {}
    for dev in ("cuda", "cpu"):
        eng = serving.LlamaEngine(cfg, params=_to_device(cpu_params, dev), num_pages=64,
                                  decode_batch=4, token_budget=64, device=dev)
        if not (isinstance(eng.kv, dict) and eng.kv["k"].dim() == 4):
            raise AssertionError("the small engine did not pick int8 token-major pages")
        ties = _count_tied_decisions(torch, eng) if dev == "cpu" else None
        prng = np.random.default_rng(TM_ENGINE_SEED)
        first = [prng.integers(0, cfg.vocab_size, n).tolist() for n in TM_ENGINE_LENS]
        late = [p[:n] + prng.integers(0, cfg.vocab_size, k).tolist()
                for p, (n, k) in zip(first, TM_ENGINE_SHARED)]
        calls = _Launches(_build) if dev == "cuda" else None
        rids = [eng.add_request(p, TM_ENGINE_NEW) for p in first]
        while not eng.reqs[rids[0]]["out"]:
            eng.step()
        rids += [eng.add_request(p, TM_ENGINE_NEW) for p in late]
        while eng.step():
            pass
        tokens[dev] = ([eng.reqs[r]["out"] for r in rids],
                       [eng.reqs[r]["cached"] for r in rids[2:]])
        if calls is not None:
            launched = calls.delta()
    if ties[0]:
        raise AssertionError(f"small tm engine: the CPU run decides {ties[0]} tokens on a tie")
    if tokens["cuda"] != tokens["cpu"] or tokens["cuda"][1] != [48, 32]:
        raise AssertionError(f"small tm engine: card {tokens['cuda']} vs cpu {tokens['cpu']}")
    missing = [k for k in SERVING_KERNELS if k != "w8a8_gemm_l1" and not launched[k]]
    if missing:
        raise AssertionError(f"small tm engine: no launch of {missing}")
    print(f"  small tm engine (int8 tm pages, L=2, D=128, G=4, ps=16; prompts 70 / 45, then "
          f"two sharing 48 / 32): all {sum(len(t) for t in tokens['cuda'][0])} greedy tokens "
          f"equal card vs CPU, none decided on a tie (A, B, C, D launched)")


def _leaves_cpu(kv):
    return [a.cpu() for a in (kv if isinstance(kv, tuple) else kv.values())]


# the kernels of phase 2's serving path
SERVING_KERNELS = ("w8a8_gemm", "w8a8_gemm_l1", "prefill_tm", "decode_tm", "append_tm")
# launches of every LlamaEngine call at Llama-3-8B's 32 layers (tm pages)
LLAMA_SERVING = {"prefill": {"w8a8_gemm": 128, "prefill_tm": 32, "append_tm": 1,
                             "w8a8_gemm_l1": 1},
                 "decode": {"w8a8_gemm": 128, "decode_tm": 32, "append_tm": 1,
                            "w8a8_gemm_l1": 1}}
BENCH_BATCH, BENCH_CTX, BENCH_STEPS, BENCH_REPS = 128, 256, 32, 3
# launches of one tm2 decode step at Llama-3-8B's 32 layers
PER_STEP = {"w8a8_gemm_tiled": 65, "rmsq_gemm": 64, "decode_tm2": 32, "append_tm2": 1}


def run_bench_path(torch, llama, build, params, gpu):
    """What `python bench.py` runs with no flags (bench.py:110-227), on the
    port: int8 Llama-3-8B (W8A8, int8 KV), batch 128, context 256, 512-token
    tm2 pages, pretiled banks, 32 greedy decode steps per call with argmax
    feeding the next id, one warm call then 3 timed. `params` (seed 0) are
    pretiled in place. The cache holds seeded random rows and scales where
    bench.py leaves zeros (same shapes and bytes, so attention works on real
    numbers). Returns the launch counts of the run."""
    cfg = llama.LlamaConfig(int8_kv=True, page_size=512)
    b, ctx, k_steps, reps = BENCH_BATCH, BENCH_CTX, BENCH_STEPS, BENCH_REPS
    t0 = time.perf_counter()
    llama.pretile_big_weights(params, block_n=512)
    torch.cuda.synchronize()
    print(f"  pretile_big_weights (bn 512, lm_head bn {params['lm_head']['q'].shape[-1]}) "
          f"{time.perf_counter() - t0:.1f} s")
    ps = cfg.page_size
    total_new = k_steps * (1 + reps)
    max_pages = -(-(ctx + total_new) // ps)
    num_pages = b * max_pages + 1
    kv = llama.init_kv_cache(cfg, num_pages, layout="tm2", device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for name in ("k", "v"):
        kv[name].copy_(torch.randint(-127, 128, kv[name].shape, generator=gen,
                                     dtype=torch.int8, device="cuda"))
    for name in ("ks", "vs"):
        kv[name].copy_(torch.rand(kv[name].shape, generator=gen, device="cuda") * 0.02
                       + 0.001)
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(num_pages - 1)[: b * max_pages]
                           .reshape(b, max_pages) + 1).astype(np.int32)).cuda()
    pos0 = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    rows = torch.arange(b, device="cuda")

    def run_steps(kv, ids, pos):
        toks, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for _ in range(k_steps):
            slots = bt[rows, pos // ps] * ps + pos % ps
            logits, kv = llama.decode_step_kv(params, cfg, kv, ids, pos, pos + 1, bt, slots)
            finite &= torch.isfinite(logits).all()
            ids = torch.argmax(logits, -1).to(torch.int32)
            toks.append(ids)
            pos = pos + 1
        return kv, ids, pos, torch.stack(toks), finite

    build.reset_launches()
    kv, ids, pos, _, finite = run_steps(kv, ids0, pos0)            # warm
    torch.cuda.synchronize()
    if not bool(finite):
        raise AssertionError("bench path: logits are not finite")
    snap = ({k: v.clone() for k, v in kv.items()}, ids.clone(), pos.clone())
    times, first = [], None
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv, ids, pos, toks, finite = run_steps(kv, ids, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k_steps)
        if not bool(finite):
            raise AssertionError("bench path: logits are not finite")
        first = toks if first is None else first
    launches = dict(build.launches)
    steps = k_steps * (1 + reps)
    for name, n in launches.items():
        want = PER_STEP.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"bench path: {name} launched {n} times in {steps} steps, "
                                 f"not {want} ({PER_STEP.get(name, 0)} per step)")
    # the same state again gives the same tokens
    again = run_steps(*snap)[3]
    if not torch.equal(again, first):
        raise AssertionError("bench path: a second run from the same state gave other tokens")
    dt = float(np.median(times))
    tok_s = b / dt
    h, f, l, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    qs, kvs = cfg.q_size, cfg.kv_size
    weight_bytes = l * (h * (qs + 2 * kvs) + qs * h + h * 2 * f + f * h) + h * v
    ctx_mean = ctx + total_new // 2
    kv_bytes_per_tok = l * 2 * ctx_mean * cfg.num_kv_heads * cfg.head_dim
    from sgl_kernel_npu_tpu_torch.utils import H100
    roofline = H100.hbm_bytes_per_s / (weight_bytes / b + kv_bytes_per_tok)
    print(f"  bench path B={b} ctx={ctx} ps={ps} tm2, {k_steps} steps x (1 warm + {reps}): "
          f"median {1e3 * dt:.3f} ms/step (steps {[round(1e3 * t, 3) for t in times]}), "
          f"{tok_s:.1f} tok/s; byte roofline at 3.35 TB/s {roofline:.1f} tok/s, share "
          f"{tok_s / roofline:.4f} [{gpu}]")
    print(f"  launches in {steps} steps: "
          + ", ".join(f"{k} {n} ({n // steps}/step)" for k, n in launches.items() if n)
          + "; kernels A-D 0; repeat run identical")

    def step():
        slots = bt[rows, pos // ps] * ps + pos % ps
        return llama.decode_step_kv(params, cfg, kv, ids, pos, pos + 1, bt, slots)
    profile_step(torch, step, _BUCKETS, "bench step (B=128)")
    return launches


# launches of one hm decode step at Llama-3-8B's 32 layers (K1: wo, w2 and
# lm_head; K2: wqkv and w13; one attention launch per layer), by variant
HM_PER_STEP = {"w8a8_gemm_tiled": 65, "rmsq_gemm": 64}
HM_INT8_STEPS, HM_VARIANT_STEPS = 8, 4


def _fill_hm(torch, kv, seed):
    """Seeded rows where bench.py leaves zeros: bf16 randn, or int8 rows with
    scales of 0.001..0.021 (same shapes and bytes)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if isinstance(kv, tuple):
        for a in kv:
            for li in range(a.shape[0]):
                a[li].copy_(torch.randn(a.shape[1:], generator=gen, device="cuda"))
        return
    for name in ("k", "v"):
        kv[name].copy_(torch.randint(-127, 128, kv[name].shape, generator=gen,
                                     dtype=torch.int8, device="cuda"))
    for name in ("ks", "vs"):
        kv[name].copy_(torch.rand(kv[name].shape, generator=gen, device="cuda") * 0.02 + 0.001)


def _check_steps(launches, steps, per_step, label):
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"{label}: {name} launched {n} times in {steps} steps, not "
                                 f"{want} ({per_step.get(name, 0)} per step)")


def run_bench_hm(torch, llama, env, build, params, gpu):
    """What `python bench.py --bf16-kv` runs (bench.py:110-227 with
    int8_kv=False), on the port, on phase 4's pretiled seed-0 weights: bf16
    hm pages of 512 (SKT_KV_LAYOUT unset: hm, as tm_layout_ok fails), batch
    128, context 256, the flat deferred decode with v6 attention (K14), 32
    greedy steps per call, one warm call then 3 timed; exact launches per
    step (K1 65, K2 64, K14 32), a repeat from the same state. Then from the
    v6 run's state, fed its tokens, 4 steps each of v6, SKT_DECODE_ATTN=v3
    (K16 deferred) and SKT_DECODE_DEFER=0 (the in-loop write, K16 v3), each
    step also through the plain versions (SKT_IMPL=ref) from the same state:
    each within calc_diff 8e-3 of its plain versions, DEFER=0 within 8e-3 of
    v3. Then 8 steps of bench.py with SKT_KV_LAYOUT=hm on an int8 cache (K14
    int8), and from its state 4 steps each of v3 and DEFER=0 (K16's int8
    contracts), each within 8e-3 of its plain versions, and a profiled step
    of each (K16's device ms a step). Returns the launches of each run."""
    cfg = llama.LlamaConfig(int8_kv=False, page_size=512)
    b, ctx, k_steps, reps = BENCH_BATCH, BENCH_CTX, BENCH_STEPS, BENCH_REPS
    ps = cfg.page_size
    total_new = k_steps * (1 + reps)
    max_pages = -(-(ctx + total_new) // ps)
    num_pages = b * max_pages + 1
    layout = env.kv_layout("tm2" if llama.tm_layout_ok(cfg) else "hm")
    kv = llama.init_kv_cache(cfg, num_pages, layout=layout, device="cuda")
    _fill_hm(torch, kv, 1)
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(num_pages - 1)[: b * max_pages]
                           .reshape(b, max_pages) + 1).astype(np.int32)).cuda()
    pos0 = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    rows = torch.arange(b, device="cuda")

    def run_steps(cfg, kv, ids, pos, steps, forced=None):
        """`steps` greedy steps (argmax feeds the next id, or the ids of
        `forced` [steps, B]); returns kv, ids, pos, tokens, logits, finite."""
        toks, lgs, finite = [], [], torch.ones((), dtype=torch.bool, device="cuda")
        for i in range(steps):
            slots = bt[rows, pos // ps] * ps + pos % ps
            logits, kv = llama.decode_step_kv(params, cfg, kv, ids, pos, pos + 1, bt, slots)
            finite &= torch.isfinite(logits).all()
            ids = torch.argmax(logits, -1).to(torch.int32) if forced is None else forced[i]
            toks.append(torch.argmax(logits, -1).to(torch.int32))
            lgs.append(logits)
            pos = pos + 1
        return kv, ids, pos, torch.stack(toks), lgs, finite

    build.reset_launches()
    kv, ids, pos, _, _, finite = run_steps(cfg, kv, ids0, pos0, k_steps)           # warm
    torch.cuda.synchronize()
    if not bool(finite):
        raise AssertionError("bench hm path: logits are not finite")
    snap = (tuple(a.clone() for a in kv), ids.clone(), pos.clone())
    times, first = [], None
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv, ids, pos, toks, _, finite = run_steps(cfg, kv, ids, pos, k_steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k_steps)
        if not bool(finite):
            raise AssertionError("bench hm path: logits are not finite")
        first = toks if first is None else first
    launches = dict(build.launches)
    steps = k_steps * (1 + reps)
    _check_steps(launches, steps, dict(HM_PER_STEP, decode_v6_defer=32),
                 "bench hm path")
    for a, sa in zip(kv, snap[0]):
        a.copy_(sa)
    again = run_steps(cfg, kv, snap[1], snap[2], k_steps)[3]
    if not torch.equal(again, first):
        raise AssertionError("bench hm path: a second run from the same state gave other "
                             "tokens")
    dt = float(np.median(times))
    tok_s = b / dt
    h, f, l, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    qs, kvs = cfg.q_size, cfg.kv_size
    weight_bytes = l * (h * (qs + 2 * kvs) + qs * h + h * 2 * f + f * h) + h * v
    kv_bytes_per_tok = l * 2 * (ctx + total_new // 2) * cfg.num_kv_heads * cfg.head_dim * 2
    from sgl_kernel_npu_tpu_torch.utils import H100
    roofline = H100.hbm_bytes_per_s / (weight_bytes / b + kv_bytes_per_tok)
    print(f"  bench --bf16-kv path B={b} ctx={ctx} ps={ps} {layout} bf16, {k_steps} steps x "
          f"(1 warm + {reps}): median {1e3 * dt:.3f} ms/step (steps "
          f"{[round(1e3 * t, 3) for t in times]}), {tok_s:.1f} tok/s; byte roofline at 3.35 "
          f"TB/s (kv_elt 2) {roofline:.1f} tok/s, share {tok_s / roofline:.4f} [{gpu}]")
    print(f"  launches in {steps} steps: "
          + ", ".join(f"{k} {n} ({n // steps}/step)" for k, n in launches.items() if n)
          + "; every other kernel 0; repeat run identical")

    def step():
        slots = bt[rows, pos // ps] * ps + pos % ps
        return llama.decode_step_kv(params, cfg, kv, ids, pos, pos + 1, bt, slots)
    profile_step(torch, step, _HM_BUCKETS, "bench --bf16-kv step (B=128)")

    # From the v6 run's state, fed its tokens: v6, v3 and the non-deferred
    # branch, each against its plain versions (SKT_IMPL=ref) step by step,
    # each step from the state the kernels' step starts from (over several
    # steps each run writes its own new rows, and at 32 layers those
    # differences compound); on bf16 pages also DEFER=0 against v3 (the same
    # f32 math; on int8 pages DEFER=0 attends to the quantised current token
    # and the deferred branches to its bf16 row, so the two differ there).
    # The distance of v3 to v6, which rounds p to bf16, is printed.
    def clone(kv):
        return {k: a.clone() for k, a in kv.items()} if isinstance(kv, dict) else tuple(
            a.clone() for a in kv)

    def keys(kv):
        return kv.keys() if isinstance(kv, dict) else range(len(kv))

    def paired(kv, snap, cfg, ids, pos, flags):
        """n steps from `snap` under `flags`, fed `forced`; each step also
        through the plain versions from the same state. Returns the kernels'
        logits, the plain versions' and the launches (the kernels' only)."""
        for key in keys(kv):
            kv[key].copy_(snap[key])
        held = clone(kv)
        build.reset_launches()
        kern, plain = [], []
        with _env(**flags):
            for i in range(n):
                for key in keys(kv):
                    held[key].copy_(kv[key])
                with _env(SKT_IMPL="ref"):
                    plain += run_steps(cfg, held, ids, pos, 1)[4]
                kv, ids, pos, _, lgs, _ = run_steps(cfg, kv, ids, pos, 1, forced[i:i + 1])
                kern += lgs
        torch.cuda.synchronize()
        return kern, plain, dict(build.launches)

    def diffs(xs, ys):
        return [_calc_diff(a.float(), r.float()) for a, r in zip(xs, ys)]

    def fmt(xs):
        return [f"{x:.3g}" for x in xs]

    def held_to_plain(kv, snap, cfg, ids, pos, runs):
        """Every run of `runs` {label: (flags, its attention's counter)}
        through `paired`: exact launches, within 8e-3 of its plain versions.
        Returns {label: (logits, launches, calc_diff per step)}."""
        out = {}
        for label, (flags, counter) in runs.items():
            kern, plain, launched = paired(kv, snap, cfg, ids, pos, flags)
            _check_steps(launched, n, dict(HM_PER_STEP, **{counter: 32}), label)
            d = diffs(kern, plain)
            if not max(d) < 8e-3:
                raise AssertionError(f"{label}: logits calc_diff against the same steps "
                                     f"through the plain versions {d}")
            out[label] = (kern, launched, d)
        return out

    n = HM_VARIANT_STEPS
    for a, sa in zip(kv, snap[0]):
        a.copy_(sa)
    forced = run_steps(cfg, kv, snap[1], snap[2], n)[3]
    bf = held_to_plain(kv, snap[0], cfg, snap[1], snap[2], {
        "v6": ({}, "decode_v6_defer"),
        "SKT_DECODE_ATTN=v3": ({"SKT_DECODE_ATTN": "v3"}, "decode_v3_defer"),
        "SKT_DECODE_DEFER=0": ({"SKT_DECODE_DEFER": "0"}, "decode_v3")})
    d_nd = diffs(bf["SKT_DECODE_DEFER=0"][0], bf["SKT_DECODE_ATTN=v3"][0])
    d_v6 = diffs(bf["SKT_DECODE_ATTN=v3"][0], bf["v6"][0])
    if not max(d_nd) < 8e-3:
        raise AssertionError(f"hm variants: calc_diff DEFER=0 vs v3 {d_nd}")
    variants = {k: bf[k][1] for k in ("SKT_DECODE_ATTN=v3", "SKT_DECODE_DEFER=0")}
    print(f"  {n} steps each from the v6 run's state, its tokens fed, each step also through "
          f"the plain versions (SKT_IMPL=ref, no launch) from the same state; logits "
          f"calc_diff against them: v6 {fmt(bf['v6'][2])}, SKT_DECODE_ATTN=v3 "
          f"(decode_v3_defer 32 per step, K1 65, K2 64) {fmt(bf['SKT_DECODE_ATTN=v3'][2])}, "
          f"SKT_DECODE_DEFER=0 (decode_v3 32, K1 65, K2 64) "
          f"{fmt(bf['SKT_DECODE_DEFER=0'][2])}; DEFER=0 vs v3 {fmt(d_nd)}; v3 vs v6 (p "
          f"rounded to bf16, not held) {fmt(d_v6)}")
    del kv, snap, bf
    torch.cuda.empty_cache()

    # bench.py's SKT_KV_LAYOUT=hm on the int8 cache (v6), then v3 and the
    # non-deferred branch from its state, fed its tokens
    cfg8 = llama.LlamaConfig(int8_kv=True, page_size=512)
    with _env(SKT_KV_LAYOUT="hm"):
        layout8 = env.kv_layout("tm2" if llama.tm_layout_ok(cfg8) else "hm")
    kv8 = llama.init_kv_cache(cfg8, num_pages, layout=layout8, device="cuda")
    _fill_hm(torch, kv8, 2)
    run_steps(cfg8, kv8, ids0, pos0, 1)                                              # warm
    snap8 = clone(kv8)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, toks8, lgs8, finite = run_steps(cfg8, kv8, ids0, pos0 + 1, HM_INT8_STEPS)
    torch.cuda.synchronize()
    dt8 = (time.perf_counter() - t0) / HM_INT8_STEPS
    if not bool(finite):
        raise AssertionError("bench hm int8 path: logits are not finite")
    int8_launches = dict(build.launches)
    _check_steps(int8_launches, HM_INT8_STEPS,
                 dict(HM_PER_STEP, decode_v6_int8_defer=32), "bench hm int8 path")
    print(f"  SKT_KV_LAYOUT=hm int8 (layout {layout8}): {HM_INT8_STEPS} steps "
          f"{1e3 * dt8:.3f} ms/step, {b / dt8:.1f} tok/s; launches per step K1 65, K2 64, "
          f"decode_v6_int8_defer 32, every other kernel 0 [{gpu}]")
    forced = toks8[:n]
    i8 = held_to_plain(kv8, snap8, cfg8, ids0, pos0 + 1, {
        "int8 SKT_DECODE_ATTN=v3": ({"SKT_DECODE_ATTN": "v3"}, "decode_v3_int8_defer"),
        "int8 SKT_DECODE_DEFER=0": ({"SKT_DECODE_DEFER": "0"}, "decode_v3_int8")})
    variants.update({k: v[1] for k, v in i8.items()})
    print(f"  int8, {n} steps each from its state, its tokens fed, each step also through the "
          f"plain versions from the same state; logits calc_diff against them: "
          f"SKT_DECODE_ATTN=v3 (decode_v3_int8_defer 32 per step, K1 65, K2 64) "
          f"{fmt(i8['int8 SKT_DECODE_ATTN=v3'][2])}, SKT_DECODE_DEFER=0 (decode_v3_int8 32, "
          f"K1 65, K2 64) {fmt(i8['int8 SKT_DECODE_DEFER=0'][2])}; DEFER=0 vs v3 (quantised vs "
          f"bf16 current token, not held) "
          f"{fmt(diffs(i8['int8 SKT_DECODE_DEFER=0'][0], i8['int8 SKT_DECODE_ATTN=v3'][0]))}; "
          f"v3 vs v6 (not held) {fmt(diffs(i8['int8 SKT_DECODE_ATTN=v3'][0], lgs8[:n]))}")
    # K16's device time a step under each int8 variant, from the int8 state
    slots8 = bt[rows, (pos0 + 1) // ps] * ps + (pos0 + 1) % ps
    for label, flags in (("int8 SKT_DECODE_ATTN=v3", {"SKT_DECODE_ATTN": "v3"}),
                         ("int8 SKT_DECODE_DEFER=0", {"SKT_DECODE_DEFER": "0"})):
        for key in keys(kv8):
            kv8[key].copy_(snap8[key])
        with _env(**flags):
            profile_step(torch, lambda: llama.decode_step_kv(params, cfg8, kv8, ids0, pos0 + 1,
                                                             pos0 + 2, bt, slots8),
                         _HM_V3_BUCKETS, f"bench hm {label} step (B=128)")
    del kv8, snap8, i8
    torch.cuda.empty_cache()
    return launches, variants, int8_launches


# launches of one hm engine model call at Llama-3-8B width on pretiled banks
# (decode batch 8: K2 for wqkv and w13, K1 for wo, w2 and lm_head; prefill:
# K1 for the four banks and lm_head, one K15 per layer)
HM_SERVING = {"prefill": {"w8a8_gemm_tiled": 129, "prefill_hm": 32},
              "decode": {"w8a8_gemm_tiled": 65, "rmsq_gemm": 64, "decode_v6_defer": 32}}
HM_SERVING_INT8 = {"prefill": HM_SERVING["prefill"],
                   "decode": {"w8a8_gemm_tiled": 65, "rmsq_gemm": 64,
                              "decode_v6_int8_defer": 32}}


def run_hm_engines(torch, llama, serving, build, params, prompts, late, new_tokens, gpu):
    """LlamaEngine on hm pages at Llama-3-8B width, on phase 4's pretiled
    seed-0 weights, phase 2's prompts: int8_kv=False (bf16 pages, picked by
    the engine), then int8 pages with kv_layout="hm"; every model call's
    launches exactly HM_SERVING, all requests finish, the radix prefix is
    reused, a rerun gives the same tokens. Returns the launches of both."""
    out = {}
    for label, cfg, kw, expect in (
            ("int8_kv=False", llama.LlamaConfig(int8_kv=False), {}, HM_SERVING),
            ("int8_kv=True, kv_layout='hm'", llama.LlamaConfig(int8_kv=True),
             {"kv_layout": "hm"}, HM_SERVING_INT8)):
        build.reset_launches()
        outs, st, wall, reused, launches = run_engine(
            torch, serving, build, cfg, params, prompts, late, new_tokens, expect=expect,
            engine_kw=kw, profile=True, buckets=_HM_ENGINE_BUCKETS)
        if any(len(o) != new_tokens for o in outs):
            raise AssertionError(f"hm engine {label}: token counts {[len(o) for o in outs]}")
        if reused != 256:
            raise AssertionError(f"hm engine {label}: the prefix was not reused ({reused})")
        outs2 = run_engine(torch, serving, build, cfg, params, prompts, late, new_tokens,
                           expect=expect, engine_kw=kw)[0]
        if outs2 != outs:
            raise AssertionError(f"hm engine {label}: a second run gave other tokens")
        print(f"  hm engine {label}: {len(outs)} requests, {new_tokens} tokens each, radix "
              f"reuse {reused}, repeat run identical; {st['prefill_steps']} prefill calls "
              f"{st['prefill_tok'] / st['prefill_s']:.1f} prefill tok/s, {st['decode_steps']} "
              f"decode calls {st['decode_tok'] / st['decode_s']:.1f} decode tok/s, "
              f"{1e3 * st['decode_s'] / st['decode_steps']:.2f} ms/decode step; wall "
              f"{wall:.2f} s [{gpu}]")
        print(f"    launches per prefill call {expect['prefill']}, per decode call "
              f"{expect['decode']}, exactly, every call; in the run: "
              f"{ {k: n for k, n in launches.items() if n} }")
        out[label] = launches
        torch.cuda.empty_cache()
    return out


# ------------------------------- the rest of the Llama serving surface (phase 17)

# (a) the sampled engine
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# (b) the requests of phase 2's batch that carry the even-ids bitmask (the
# index past the prompts is the late request)
MASKED = (0, 2, 4, 6)
# (c) 4 adapters of rank 16 from numpy seed 0 (add_lora_adapters' scale
# 0.05); phase 2's requests' adapter ids, -1..3 in one batch: the two that
# share the 256-token prefix carry none, so the late one still reuses it
LORA_ADAPTERS, LORA_RANK = 4, 16
LORA_IDS = (0, 1, 2, 3, -1, -1, -1, -1)
# (e) a 512-token prompt in 128-token chunks, then 8 decode steps; the
# verify chain's length
STEP_PROMPT, STEP_CHUNK, STEP_NEW, VERIFY_CHAIN = 512, 128, 8, 4
# (f) speculative decoding: draft length, new tokens, the draft's depth.
# The logits are bf16 (lm_head's output dtype, as in the JAX package): at
# Llama-3-8B's vocabulary the best two ids often tie exactly or sit one
# bf16 ulp (1/64 at magnitudes 2-4) apart. The random seed-0 model carries
# a small difference in a layer's attention into a large one in the logits:
# on the same positions decode_step (K14, p rounded to bf16) and
# decode_verify_step (plain f32 attention) give logits up to 0.36 apart,
# K16 (p in f32) and decode_verify_step 0.18, and decode_verify_step on a
# 4-token chain and a token a call 0.31 (the card picks other reduction
# orders for other shapes; phase 17 on an H100). Greedy picks whose
# two best logits sit closer than that flip between any two of these
# paths, and most picks do. So (f) holds every speculative token to the
# target's own judgement of the emitted sequence: its first token equals
# the prefill's argmax exactly (the same call), and one decode_verify_step
# over the rest puts every later token within 2 * gap of its row's best
# logit, gap being (e)'s chain-vs-single difference (the margin rule);
# the share of tokens that are the row's argmax is printed
SPEC_DRAFT_LEN, SPEC_NEW, SPEC_DRAFT_LAYERS = 4, 64, 2
# (c), (e): calc_diff bounds, the repo's logits bound (tests/test_llama_model.py)
SURFACE_DIFF = 8e-3
# launches of one hm engine model call on untiled banks (A for the four
# banks, A at L = 1 for lm_head, one K15 or K14 a layer)
HM_A_SERVING = {"prefill": {"w8a8_gemm": 128, "prefill_hm": 32, "w8a8_gemm_l1": 1},
                "decode": {"w8a8_gemm": 128, "decode_v6_defer": 32, "w8a8_gemm_l1": 1}}
# the kernels phase 17 must launch: A, B, C, D, K14, K15
SURFACE_KERNELS = ("w8a8_gemm", "prefill_tm", "decode_tm", "append_tm", "decode_v6_defer",
                   "prefill_hm")


def _even_bitmask(vocab):
    """The packed bitmask that allows the even token ids."""
    return np.full((vocab + 31) // 32, 0x55555555, np.uint32).view(np.int32)


def _ms_per_decode(st):
    return 1e3 * st["decode_s"] / st["decode_steps"]


def _margin(row):
    top = row.float().topk(2).values
    return float(top[0] - top[1])


@contextlib.contextmanager
def _recorded_picks(serving):
    """Within: every LlamaEngine pick records each row's top-2 logit margin
    (after its bitmask) in its request's "margins" list."""
    pick = serving.LlamaEngine._pick

    def recording(self, logits, reqs):
        top = logits.float().topk(2, dim=-1).values
        for r, mg in zip(reqs, (top[:, 0] - top[:, 1]).tolist()):
            r.setdefault("margins", []).append(mg)
        return pick(self, logits, reqs)

    serving.LlamaEngine._pick = recording
    try:
        yield
    finally:
        serving.LlamaEngine._pick = pick


def check_sampling(torch, serving, build, cfg, params, prompts, late, new_tokens, greedy):
    """(a) A tm engine at temperature 0.8, top_k 50, top_p 0.95 serves phase
    2's prompts twice from seed 0: the same tokens. At top_k 1 it gives
    phase 2's greedy tokens up to each request's first exact tie of the two
    best logits (bf16 logits tie often at 128,256 ids; top-k keeps every
    tied logit, as in the JAX package, and the draw may take either, so
    the rest of that request may differ). Every model call's launches are
    phase 2's. Returns the first sampled run's stats."""
    runs = []
    for _ in range(2):
        outs, st, _, reused, _ = run_engine(torch, serving, build, cfg, params, prompts, late,
                                            new_tokens, expect=LLAMA_SERVING,
                                            engine_kw=dict(seed=0, **SAMPLED))
        runs.append((outs, st))
    if runs[0][0] != runs[1][0]:
        raise AssertionError("(a) the sampled engine gave other tokens from the same seed")
    if any(len(o) != new_tokens for o in runs[0][0]):
        raise AssertionError("(a) a sampled request did not finish")
    kept = {}
    with _recorded_picks(serving):
        top1 = run_engine(torch, serving, build, cfg, params, prompts, late, new_tokens,
                          expect=LLAMA_SERVING, engine_kw=dict(seed=0, temperature=0.8, top_k=1),
                          on_done=lambda eng, *_: kept.update(reqs=list(eng.reqs.values())))[0]
    margins = {tuple(r["tokens"]): r["margins"] for r in kept["reqs"]}
    held = []
    for p, o, g in zip(prompts + [late], top1, greedy):
        ties = [j for j, mg in enumerate(margins[tuple(p)]) if mg == 0]
        n = ties[0] if ties else new_tokens
        if o[:n] != g[:n]:
            raise AssertionError("(a) the engine at top_k 1 left phase 2's greedy tokens before "
                                 "an exact tie")
        held.append(n)
    same = sum(a == b for o, g in zip(runs[0][0], greedy) for a, b in zip(o, g))
    whole = sum(o == g for o, g in zip(top1, greedy))
    print(f"  (a) sampling (temperature 0.8, top_k 50, top_p 0.95, seed 0): two runs identical, "
          f"{same} of {len(greedy) * new_tokens} tokens equal to the greedy ones; top_k 1: "
          f"phase 2's greedy tokens up to each request's first exact tie, tokens held "
          f"{held} of {new_tokens} each ({whole} requests equal throughout); radix reuse "
          f"{reused}")
    return runs[0][1]


def check_grammar(torch, serving, build, cfg, params, prompts, late, new_tokens, greedy):
    """(b) Half of phase 2's requests carry the even-ids bitmask: every token
    they emit is even; the others equal phase 2's greedy tokens."""
    bm = _even_bitmask(cfg.vocab_size)
    req_kw = [dict(token_bitmask=bm) if i in MASKED else {} for i in range(len(prompts) + 1)]
    outs = run_engine(torch, serving, build, cfg, params, prompts, late, new_tokens,
                      expect=LLAMA_SERVING, request_kw=req_kw)[0]
    odd = [t for i in MASKED for t in outs[i] if t % 2]
    if odd or any(len(outs[i]) != new_tokens for i in MASKED):
        raise AssertionError(f"(b) masked requests emitted odd ids {odd[:8]}")
    free = [i for i in range(len(outs)) if i not in MASKED]
    if any(outs[i] != greedy[i] for i in free):
        raise AssertionError("(b) an unmasked request did not give phase 2's greedy tokens")
    print(f"  (b) grammar: requests {MASKED} under the even-ids bitmask emitted only even ids; "
          f"requests {free} equal phase 2's greedy tokens")


def check_lora(torch, serving, llama, env, build, cfg, params, prompts, late, new_tokens,
               greedy):
    """(c) 4 adapters of rank 16, ids -1..3 in one batch: the -1 requests
    equal phase 2's greedy tokens; one decode_step_kv call with lora_ids
    (the engine's steady decode call, replayed on its cache) is held to the
    same call under SKT_IMPL=ref within calc_diff SURFACE_DIFF, its -1 rows
    equal the call without adapters bit for bit, and the adapters move the
    others (calc_diff above 0). Returns the run's stats."""
    lparams = llama.add_lora_adapters(params, cfg, LORA_ADAPTERS, LORA_RANK, seed=0)
    kept = {}

    def keep(eng, stats, _dec):
        kept["args"], kept["kv"] = stats["steady_args"], eng.kv

    outs, st, _, reused, _ = run_engine(
        torch, serving, build, cfg, lparams, prompts, late, new_tokens, expect=LLAMA_SERVING,
        request_kw=[dict(lora_id=i) for i in LORA_IDS], on_done=keep)
    base = [i for i, lid in enumerate(LORA_IDS) if lid < 0]
    if any(outs[i] != greedy[i] for i in base):
        raise AssertionError("(c) a request without an adapter did not give phase 2's tokens")
    if reused != 256:
        raise AssertionError(f"(c) the shared prefix was not reused ({reused})")
    moved = sum(outs[i] != greedy[i] for i, lid in enumerate(LORA_IDS) if lid >= 0)
    ids, pos, seq, bt, slots, lids = kept["args"]
    kv = kept["kv"]

    def call(lora):
        out = llama.decode_step_kv(lparams, cfg, kv, ids, pos, seq, bt, slots,
                                   lora_ids=lids if lora else None)[0].clone()
        torch.cuda.synchronize()
        return out

    c = _Launches(build)
    got = call(True)
    launched = {k: n for k, n in c.delta().items() if n}
    with _env(SKT_IMPL="ref"):
        c = _Launches(build)
        ref = call(True)
        if any(c.delta().values()):
            raise AssertionError("(c) the SKT_IMPL=ref call launched a kernel")
    plain = call(False)
    with_ad, without = lids >= 0, (lids < 0) & (slots >= 0)
    d_ref = _calc_diff(got, ref)
    d_ad = _calc_diff(got[with_ad], plain[with_ad])
    print(f"  (c) multi-LoRA ({LORA_ADAPTERS} adapters of rank {LORA_RANK}, ids "
          f"{list(LORA_IDS)} + -1 for the late request): the -1 requests equal phase 2's "
          f"tokens, {moved} of 4 adapter requests' tokens moved, radix reuse {reused}; one "
          f"decode_step_kv call (ids {lids.tolist()}) launched {launched}, calc_diff "
          f"{d_ref:.3g} against SKT_IMPL=ref (bound {SURFACE_DIFF}), {d_ad:.3g} against no "
          f"adapter on the adapter rows (must be > 0), rows without one bit-equal: "
          f"{torch.equal(got[without], plain[without])}")
    if not d_ref < SURFACE_DIFF:
        raise AssertionError("(c) decode_step_kv with lora_ids is off its SKT_IMPL=ref call")
    if not d_ad > 0 or not torch.equal(got[without], plain[without]):
        raise AssertionError("(c) the adapters do not move their rows, or move the others")
    return st


def check_pause_resume(torch, serving, build, cfg, params, prompts, late, new_tokens, greedy,
                       gpu):
    """(d) Phase 2's requests; the first is paused after half its tokens
    (pages offloaded to the host, freed), a new 300-token request churns
    the pool (it takes the freed page) for 4 steps, then the first resumes
    into a new page: every request's tokens equal phase 2's."""
    eng = serving.LlamaEngine(cfg, params=params, device="cuda", num_pages=512,
                              decode_batch=8, token_budget=256)
    churn_prompt = np.random.default_rng(17).integers(0, cfg.vocab_size, 300).tolist()
    rids = [eng.add_request(p, new_tokens) for p in prompts]
    late_rid = paused = resumed = None
    held, took, times = 0, set(), {}
    for _ in range(1000):
        if late_rid is None and eng.reqs[rids[-1]]["out"]:
            late_rid = eng.add_request(late, new_tokens)
        if (paused is None and late_rid is not None
                and len(eng.reqs[rids[0]]["out"]) >= new_tokens // 2):
            old = list(eng.reqs[rids[0]]["pages"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paused = eng.pause_request(rids[0])
            times["pause"] = time.perf_counter() - t0
            churn = eng.add_request(churn_prompt, 4)
            took = set(eng.reqs[churn]["pages"]) & set(old)
        elif paused is not None and resumed is None:
            held += 1
            if held > 4:
                t0 = time.perf_counter()
                resumed = eng.resume_request(paused)
                torch.cuda.synchronize()
                times["resume"] = time.perf_counter() - t0
                new_pages = eng.reqs[resumed]["pages"]
        if not eng.step() and resumed is not None:
            break
    outs = [eng.reqs[resumed]["out"]] + [eng.reqs[r]["out"] for r in rids[1:] + [late_rid]]
    if not took:
        raise AssertionError("(d) the churn request took none of the paused request's pages")
    if outs != greedy:
        bad = [i for i, (a, b) in enumerate(zip(outs, greedy)) if a != b]
        raise AssertionError(f"(d) requests {bad} differ from phase 2's uninterrupted run")
    print(f"  (d) pause / resume: request 0 paused after {new_tokens // 2} tokens (pages {old}, "
          f"offloaded in {1e3 * times['pause']:.2f} ms), the churn request took pages "
          f"{sorted(took)}, resumed after 4 steps into pages {new_pages} "
          f"({1e3 * times['resume']:.2f} ms); all 8 requests equal phase 2's tokens [{gpu}]")
    del eng


def _decode_batch_args(torch, b, tok, p, table, mp, ps):
    """decode_step's inputs for one live row in a padded batch of b, as the
    engine pads its decode batch."""
    dev = "cuda"
    ids = torch.zeros(b, dtype=torch.int32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    seq = torch.ones(b, dtype=torch.int32, device=dev)
    bt = torch.zeros((b, mp), dtype=torch.int32, device=dev)
    slots = torch.full((b,), -1, dtype=torch.int32, device=dev)
    ids[0], pos[0], seq[0] = tok, p, p + 1
    bt[0] = table
    slots[0] = int(table[p // ps]) * ps + p % ps
    return ids, pos, seq, bt, slots


def check_step_functions(torch, serving, llama, build, params, gpu):
    """(e) A 512-token prompt served by the hm engine (bf16 pages, 128-token
    chunks, untiled banks: A, K15, K14; every call's launches exact), and
    the same through prefill_chunk_step (4 chunks of 128) and decode_step
    on a padded batch of 8 as the engine pads it: the same tokens. Then
    decode_verify_step on the first 4 generated tokens, held to the 4
    decode_step calls' logits by calc_diff, and to decode_verify_step a
    token a call on the same positions. Returns the largest logit
    difference of the chain's call and the single-token calls, and the
    timings."""
    cfg = llama.LlamaConfig(int8_kv=False)
    prompt = np.random.default_rng(23).integers(0, cfg.vocab_size, STEP_PROMPT).tolist()
    eng = serving.LlamaEngine(cfg, params=params, device="cuda", num_pages=64, decode_batch=8,
                              token_budget=STEP_CHUNK)
    if not isinstance(eng.kv, tuple):
        raise AssertionError("(e) the engine at int8_kv=False must pick bf16 hm pages")
    inner = {"prefill": eng._prefill_batch, "decode": eng._decode}

    def checked(kind):
        def call(*a):
            c = _Launches(build)
            out = inner[kind](*a)
            _check_call(kind, c.delta(), HM_A_SERVING)
            return out
        return call

    eng._prefill_batch, eng._decode = checked("prefill"), checked("decode")
    want = eng.generate([prompt], max_new_tokens=STEP_NEW)[0]
    mp = eng.max_pages
    del eng
    torch.cuda.empty_cache()

    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    k, v = llama.init_kv_cache(cfg, 64, layout="hm", device="cuda")
    table = ints(list(range(mp)))
    t = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, STEP_PROMPT, STEP_CHUNK):
        pos = torch.arange(lo, lo + STEP_CHUNK, dtype=torch.int32, device="cuda")
        lg, k, v = llama.prefill_chunk_step(params, cfg, k, v, ints(prompt[lo:lo + STEP_CHUNK]),
                                            pos, pos, table, lo)
    torch.cuda.synchronize()
    t["prefill_chunk_step"] = (time.perf_counter() - t0) / (STEP_PROMPT // STEP_CHUNK)
    toks, margins, dec = [int(lg[-1].argmax())], [_margin(lg[-1])], []
    t0 = time.perf_counter()
    for i in range(STEP_NEW - 1):
        args = _decode_batch_args(torch, 8, toks[-1], STEP_PROMPT + i, table, mp,
                                  cfg.page_size)
        lg, k, v = llama.decode_step(params, cfg, k, v, *args)
        dec.append(lg[0].clone())
        toks.append(int(lg[0].argmax()))
        margins.append(_margin(lg[0]))
    t["decode_step"] = (time.perf_counter() - t0) / (STEP_NEW - 1)
    if toks != want:
        raise AssertionError(f"(e) prefill_chunk_step + decode_step gave {toks}, the hm engine "
                             f"{want}")
    chain = toks[:VERIFY_CHAIN]
    pos = torch.arange(STEP_PROMPT, STEP_PROMPT + VERIFY_CHAIN, dtype=torch.int32,
                       device="cuda")[None]
    mask = torch.tril(torch.ones((1, VERIFY_CHAIN, VERIFY_CHAIN), dtype=torch.bool,
                                 device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lv, k, v = llama.decode_verify_step(params, cfg, k, v, ints([chain]), pos, mask,
                                        ints([STEP_PROMPT]), table[None], pos)
    torch.cuda.synchronize()
    t["decode_verify_step"] = time.perf_counter() - t0
    ref = torch.stack(dec[:VERIFY_CHAIN])
    d = _calc_diff(lv[0], ref)
    gap = float((lv[0] - ref).abs().max())
    # the same 4 positions through decode_verify_step a token a call, each
    # reading the rows the chain's call wrote before it
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    single = torch.stack([
        llama.decode_verify_step(params, cfg, k, v, ints([[tok]]), pos[:, i:i + 1], one,
                                 ints([STEP_PROMPT + i]), table[None], pos[:, i:i + 1])[0][0, 0]
        for i, tok in enumerate(chain)])
    d_one, gap_one = _calc_diff(lv[0], single), float((lv[0] - single).abs().max())
    print(f"  (e) step functions: {STEP_PROMPT} tokens through prefill_chunk_step in chunks of "
          f"{STEP_CHUNK} ({1e3 * t['prefill_chunk_step']:.2f} ms a chunk), {STEP_NEW - 1} "
          f"decode_step calls ({1e3 * t['decode_step']:.2f} ms each): the hm engine's tokens "
          f"(smallest top-2 margin {min(margins):.4f}); decode_verify_step on a "
          f"{VERIFY_CHAIN}-token chain ({1e3 * t['decode_verify_step']:.2f} ms) vs the decode_step logits: calc_diff "
          f"{d:.3g} (bound {SURFACE_DIFF}), max |diff| {gap:.4g}; vs decode_verify_step a "
          f"token a call on the same positions: calc_diff {d_one:.3g}, max |diff| "
          f"{gap_one:.4g} [{gpu}]")
    if not (d < SURFACE_DIFF and d_one < SURFACE_DIFF):
        raise AssertionError("(e) decode_verify_step's logits are off decode_step's or its own")
    del k, v
    return gap_one, t


def _judged(torch, llama, cfg, params, prompt, out, num_pages=16):
    """The target's judgement of an emitted sequence: the prompt through
    prefill_chunk_step as speculative_generate prefills it, then one
    decode_verify_step over out[:-1] as a causal chain. Returns the
    prefill's argmax (out[0]'s judge) and, for every later token, how far
    its logit lies below its row's best."""
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    ps = cfg.page_size
    pages = list(range(1, num_pages))
    bt = ints([pages])
    k, v = llama.init_kv_cache(cfg, num_pages, layout="hm", device="cuda")
    m, n = len(prompt), len(out) - 1
    slots = [pages[p // ps] * ps + p % ps for p in range(m + n)]
    lg, k, v = llama.prefill_chunk_step(params, cfg, k, v, ints(prompt),
                                        torch.arange(m, dtype=torch.int32, device="cuda"),
                                        ints(slots[:m]), bt[0], 0)
    first = int(lg[-1].argmax())
    mask = torch.tril(torch.ones((1, n, n), dtype=torch.bool, device="cuda"))
    lv, k, v = llama.decode_verify_step(
        params, cfg, k, v, ints([out[:-1]]), ints([list(range(m, m + n))]), mask, ints([m]),
        bt, ints([slots[m:]]))
    rows = lv[0].float()
    lag = rows.max(-1).values - rows[torch.arange(n, device="cuda"), ints(out[1:]).long()]
    return first, lag.tolist()


def check_speculative(torch, serving, llama, params, prompt, gap, gpu):
    """(f) speculative_generate with the full-width target (bf16 pages) and a
    2-layer draft of the same widths (seed 1), draft_len 4, 64 new tokens,
    and with the target as its own draft, each held to the target's
    judgement of its output (_judged) under the margin rule (see
    SPEC_DRAFT_LEN): the first token the prefill's argmax, every later one
    within 2 * gap of its row's best logit. Self-speculation (its drafts
    are decode_step's, K14) must accept every draft of at least one round.
    Prints the accept counts and the share of tokens that are their row's
    argmax. Returns the figures."""
    t_cfg = llama.LlamaConfig(int8_kv=False)
    d_cfg = llama.LlamaConfig(int8_kv=False, num_layers=SPEC_DRAFT_LAYERS)
    t0 = time.perf_counter()
    d_params = llama.init_params(d_cfg, 1, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runs = {}
    for name, dp, dc in (("draft", d_params, d_cfg), ("self", params, t_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, acc = serving.speculative_generate(params, t_cfg, dp, dc, prompt, SPEC_NEW,
                                                SPEC_DRAFT_LEN, device="cuda")
        torch.cuda.synchronize()
        spec_s = time.perf_counter() - t0
        first, lag = _judged(torch, llama, t_cfg, params, prompt, out)
        runs[name] = (out, acc, spec_s, lag)
        if len(out) != SPEC_NEW or out[0] != first or max(lag) > 2 * gap:
            raise AssertionError(f"(f) {name}: {len(out)} tokens, first {out[0]} against the "
                                 f"prefill's {first}, a token {max(lag):.4f} below its row's "
                                 f"best (bound 2 * {gap:.4g})")
    s_acc = runs["self"][1]
    if SPEC_DRAFT_LEN - 1 not in s_acc:
        raise AssertionError(f"(f) self-speculation accepted no round whole: {s_acc}")
    del d_params
    fig = {}
    for name, (out, acc, spec_s, lag) in runs.items():
        fig[name] = dict(rounds=len(acc), rate=sum(acc) / (len(acc) * (SPEC_DRAFT_LEN - 1)),
                         s=spec_s, argmax=sum(x == 0 for x in lag), worst=max(lag))
        label = (f"a {SPEC_DRAFT_LAYERS}-layer draft (seed 1)" if name == "draft"
                 else "self-speculation")
        print(f"  (f) speculative_generate, {label}, "
              f"draft_len {SPEC_DRAFT_LEN}: {len(acc)} rounds, accept counts {acc} (acceptance "
              f"rate {fig[name]['rate']:.3f}), {spec_s:.2f} s; judged by one decode_verify_step "
              f"over its output: first token the prefill's argmax, {fig[name]['argmax']} of "
              f"{SPEC_NEW - 1} later tokens their row's argmax, the farthest {max(lag):.4f} below "
              f"its row's best (bound 2 * {gap:.4g}) [{gpu}]")
    print(f"  (f) the draft's init_params {init_s:.1f} s")
    return fig


def run_serving_surface(torch, serving, llama, env, build, cfg, params, prompts, late,
                        new_tokens, greedy, phase2_st, gpu):
    """Phase 17: the rest of the Llama serving surface at Llama-3-8B width on
    phase 2's seed-0 weights (untiled banks), the counters set to 0 first:
    (a) sampling, (b) grammar bitmasks, (c) multi-LoRA, (d) pause / resume,
    (e) the step functions, (f) speculative decoding; (g) A, B, C, D, K14
    and K15 launched. Returns the phase's launches."""
    build.reset_launches()
    t0 = time.perf_counter()
    sampled_st = check_sampling(torch, serving, build, cfg, params, prompts, late, new_tokens,
                                greedy)
    check_grammar(torch, serving, build, cfg, params, prompts, late, new_tokens, greedy)
    lora_st = check_lora(torch, serving, llama, env, build, cfg, params, prompts, late,
                         new_tokens, greedy)
    check_pause_resume(torch, serving, build, cfg, params, prompts, late, new_tokens, greedy, gpu)
    torch.cuda.empty_cache()
    gap, _ = check_step_functions(torch, serving, llama, build, params, gpu)
    torch.cuda.empty_cache()
    spec = check_speculative(torch, serving, llama, params, prompts[0], gap, gpu)
    torch.cuda.empty_cache()
    launches = dict(build.launches)
    idle = [k for k in SURFACE_KERNELS if launches[k] <= 0]
    if idle:
        raise AssertionError(f"(g) kernels never launched in phase 17: {idle}")
    print(f"  decode ms per engine step (host clock, synchronised): phase 2 greedy "
          f"{_ms_per_decode(phase2_st):.2f}, sampled {_ms_per_decode(sampled_st):.2f}, LoRA "
          f"{_ms_per_decode(lora_st):.2f} [{gpu}]")
    print(f"  (g) launches in phase 17: { {k: n for k, n in launches.items() if n} }; "
          f"A, B, C, D, K14 and K15 each launched; phase 17 {time.perf_counter() - t0:.1f} s")
    return launches, spec


# A, K1 and K2 run the int8 stage of csrc/w8a8_wgmma.cuh, each kernel
# instantiated on its epilogue order (EpiBank, EpiTiled, EpiRmsq)
_A = ("EpiBank",)
_K1 = ("EpiTiled",)
_K2 = ("EpiRmsq", "rmsq_rows")
_K8 = ("EpiGrouped",)
_HM_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K2 rmsq_gemm", _K2),
               ("K14 decode_v6_defer", ("decode_v6_kernel",)),
               ("memsets", ("Memset",)))
# phase 9's int8 v3 and DEFER=0 steps: K16's share
_HM_V3_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K2 rmsq_gemm", _K2),
                  ("K16 decode_v3", ("decode_v3_kernel",)),
                  ("memsets", ("Memset",)))
# phase 10's decode call, bf16 or int8 pages
_HM_ENGINE_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K2 rmsq_gemm", _K2),
                      ("K14 decode_v6", ("decode_v6_kernel", "decode_v6_int8_kernel")),
                      ("memsets", ("Memset",)))
# phase 2's decode call: kernel C's share of the device time
_ENGINE_BUCKETS = (("A w8a8_gemm", _A),
                   ("C decode_tm", ("decode_tm_kernel",)), ("D append_tm", ("append_tm_kernel",)),
                   ("memsets", ("Memset",)))
# phase 5's decode call: K7's share
_MLA_ENGINE_BUCKETS = (("K2 rmsq_gemm (per_tensor)", _K2), ("A w8a8_gemm", _A),
                       ("K7 decode_mla", ("decode_mla_kernel",)), ("memsets", ("Memset",)))
_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K2 rmsq_gemm", _K2),
            ("K3 decode_tm2", ("decode_tm2_kernel",)),
            ("K4 append_tm2", ("append_tm2_kernel",)),
            ("memsets", ("Memset",)))
_MLA_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K2 rmsq_gemm (both modes)", _K2),
                ("A w8a8_gemm (L = 1)", _A),
                ("K5 decode_mla_c", ("decode_mla_c_kernel",)),
                ("K6 append_mla", ("append_mla_kernel",)),
                ("memsets", ("Memset",)))


def profile_step(torch, step, buckets, label, reps=3):
    """torch.profiler over `reps` steady-state calls of `step`: device time
    by kernel bucket (and the glue of PyTorch's own kernels) and the device's
    idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    if not by_name:
        print(f"  {label} profile: the profiler recorded no device time (not measured)")
        return
    split = {lb: 0.0 for lb, _ in buckets}
    split["glue (PyTorch kernels)"] = 0.0
    for name, us in by_name.items():
        lb = next((lb for lb, keys in buckets if any(k in name for k in keys)),
                  "glue (PyTorch kernels)")
        split[lb] += us / reps / 1e3
    busy = sum(split.values())
    shares = ", ".join(f"{k.split()[0]} {v / busy:.3f}" for k, v in split.items() if busy)
    glue = sorted(((n, t) for n, t in by_name.items()
                   if not any(k in n for _, keys in buckets for k in keys)),
                  key=lambda kv: -kv[1])[:5]
    print(f"  {label} profile ({reps} steady-state steps): wall {1e3 * wall:.3f} ms/step "
          f"under the profiler, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / (1e3 * wall):.3f}; ms/step by kind: "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" (shares of the busy time: {shares}); largest glue kernels (ms/step): "
          + "; ".join(f"{n[:40]} {t / reps / 1e3:.3f}" for n, t in glue))


def _small_mla_config(dm):
    """DeepSeek's MLA widths (16 heads, latent 512 | 64, nope 128) with 2
    layers, hidden 512, q-LoRA 128 (K2 takes K in steps of 64), FFN 1024,
    vocab 1024 and 16-token pages, so that every MLA kernel runs."""
    return dm.MlaConfig(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=16,
                        kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
                        q_lora_rank=128, intermediate_size=1024, page_size=16,
                        max_position=512)


def check_small_mla(torch, dm):
    """The small MLA config on the card and on the CPU (plain versions), from
    the same CPU-made weights and inputs, on both paths:
      * bench path: three decode_step_c steps on an int8 combined cache
        pre-filled with the same seeded rows at position ps - 2, B = 8,
        banks pretiled to 128-wide panels (K1, K2 both modes, K5, K6): logits
        calc_diff < 8e-3 at each step, layer-0 rows and scales >= 99.9% exact
        with |diff| <= 1;
      * engine path: a chunked prefill of 2 sequences (decode_verify_step,
        causal) then 2 decode_step steps on a padded batch of 4, on split
        caches with fused stage weights (K2 per_tensor, A, K7): logits
        calc_diff < 8e-3, the split caches within calc_diff 1e-4 (bf16 rows
        after RMSNorms that the card and the CPU sum in other orders)."""
    cfg = _small_mla_config(dm)
    ps = cfg.page_size
    cpu_params = dm.init_params(cfg, 9, "cpu")
    rng = np.random.default_rng(13)
    b, mp = 8, 2
    pages = b * mp + 1
    c = dm.combined_width(cfg)
    cache = {"kv": rng.integers(-127, 128, (cfg.num_layers, pages, ps, c), dtype=np.int8),
             "s": (rng.random((cfg.num_layers, pages, 1, ps)) * 0.02 + 0.001)
             .astype(np.float32)}
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    steps, pos = [], np.full(b, ps - 2, np.int32)
    for _ in range(3):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        steps.append((rng.integers(0, cfg.vocab_size, b).astype(np.int32), pos, pos + 1, bt,
                      slots))
        pos = pos + 1
    # one weight set serves both paths: "fast" for the bench path, the fused
    # stage copies for the engine path
    dm.pretile_mla_weights(dm.fuse_mla_weights(cpu_params), cfg, block_n=128)
    results = {}
    for dev in ("cuda", "cpu"):
        params = _to_device(cpu_params, dev)
        kv = {k: torch.from_numpy(a).to(dev) for k, a in cache.items()}
        logits = []
        for args in steps:
            lg, kv = dm.decode_step_c(params, cfg, kv, *(torch.from_numpy(np.array(a)).to(dev)
                                                         for a in args))
            logits.append(lg.float().cpu())
        results[dev] = (logits, {k: v.cpu() for k, v in kv.items()})
    diffs = [_calc_diff(a, r) for a, r in zip(results["cuda"][0], results["cpu"][0])]
    if max(diffs) >= 8e-3 or not all(bool(torch.isfinite(a).all()) for a in results["cuda"][0]):
        raise AssertionError(f"small MLA bench path: logits calc_diff {diffs}")
    match = {}
    for k in ("kv", "s"):
        a, r = results["cuda"][1][k], results["cpu"][1][k]
        match[k] = [float((a[li] == r[li]).float().mean()) for li in range(2)]
        worst = int((a[0].int() - r[0].int()).abs().max()) if k == "kv" else 0
        if match[k][0] < 0.999 or worst > 1:
            raise AssertionError(f"small MLA bench path layer-0 {k}: {match[k][0]:.5f} exact, "
                                 f"max |diff| {worst}")
    print(f"  small MLA config (L=2, H=16, 512|64, q-LoRA 128, ps=16), bench path B=8 "
          f"int8 rows: logits calc_diff per step {[f'{x:.3g}' for x in diffs]}; exact "
          f"fraction per layer rows {match['kv']}, scales {match['s']}")

    # the engine path
    s, t, mpe, pages_e = 2, 32, 4, 12
    lens = [29, 20]
    bts = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    ppos = np.zeros((s, t), np.int32)
    for si, n in enumerate(lens):
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        ppos[si, :n] = np.arange(n)
        slp[si, :n] = bts[si, np.arange(n) // ps] * ps + np.arange(n) % ps
    dsteps = []
    for step in range(2):
        cur = [n + step for n in lens]
        bt4 = np.zeros((4, mpe), np.int32)
        bt4[:2] = bts
        sl = np.full(4, -1, np.int32)
        sl[:2] = [bts[i, p // ps] * ps + p % ps for i, p in enumerate(cur)]
        ids_d = np.zeros(4, np.int32)
        ids_d[:2] = rng.integers(0, cfg.vocab_size, 2)
        dsteps.append((ids_d, np.array(cur + [0, 0], np.int32),
                       np.array([p + 1 for p in cur] + [1, 1], np.int32), bt4, sl))
    for dev in ("cuda", "cpu"):
        params = _to_device(cpu_params, dev)
        ckv, kr = dm.init_kv_cache(cfg, pages_e, device=dev)

        def tt(a):
            return torch.from_numpy(np.array(a)).to(dev)
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev)).expand(s, t, t)
        lg, ckv, kr = dm.decode_verify_step(params, cfg, ckv, kr, tt(ids), tt(ppos), mask,
                                            torch.zeros(s, dtype=torch.int32, device=dev),
                                            tt(bts), tt(slp))
        logits = [lg[si, :n].float().cpu() for si, n in enumerate(lens)]
        for args in dsteps:
            lg, ckv, kr = dm.decode_step(params, cfg, ckv, kr, *(tt(a) for a in args))
            logits.append(lg[:2].float().cpu())
        results[dev] = (logits, (ckv.float().cpu(), kr.float().cpu()))
    diffs = [_calc_diff(a, r) for a, r in zip(results["cuda"][0], results["cpu"][0])]
    if max(diffs) >= 8e-3 or not all(bool(torch.isfinite(a).all()) for a in results["cuda"][0]):
        raise AssertionError(f"small MLA engine path: logits calc_diff {diffs}")
    cdiff = [_calc_diff(a, r) for a, r in zip(results["cuda"][1], results["cpu"][1])]
    exact = [float((a == r).float().mean()) for a, r in zip(results["cuda"][1],
                                                          results["cpu"][1])]
    if max(cdiff) >= 1e-4:
        raise AssertionError(f"small MLA engine path: caches calc_diff {cdiff}")
    print(f"  small MLA config, engine path (prefill {lens} + 2 decode steps, B=4): logits "
          f"calc_diff {[f'{x:.3g}' for x in diffs]}; ckv / krope calc_diff "
          f"{[f'{x:.3g}' for x in cdiff]}, exact fraction {exact}")


# the kernels of phase 5's MLA serving path, per model call
MLA_SERVING = {"decode": {"rmsq_gemm_pt": 54, "w8a8_gemm": 81, "w8a8_gemm_l1": 1,
                          "decode_mla": 27},
               "prefill": {"rmsq_gemm_pt": 54, "w8a8_gemm": 81, "w8a8_gemm_l1": 1}}
MLA_BATCH, MLA_CTX, MLA_STEPS, MLA_REPS = 128, 256, 16, 3
# launches of one decode_step_c step at DeepSeek-V2-Lite's 27 layers
MLA_PER_STEP = {"rmsq_gemm": 27, "rmsq_gemm_pt": 54, "w8a8_gemm_tiled": 54,
                "w8a8_gemm_l1": 1, "decode_mla_c": 27, "append_mla": 1}


def run_mla_bench_path(torch, dm, build, params, cfg, gpu):
    """What `python bench.py --config mla` runs (bench.py:265-375), on the
    port: DeepSeek-V2-Lite width, batch 128, context 256, 128-token pages, an
    int8 combined latent cache, banks pretiled to 1024-wide panels
    (bench.py:300), 16 greedy decode steps per call with argmax feeding the
    next id, one warm call then 3 timed. `params` (seed 0) gain their
    pretiled set. The cache holds seeded random rows and scales where
    bench.py leaves zeros. Returns the launch counts of the run."""
    b, ctx, k_steps, reps = MLA_BATCH, MLA_CTX, MLA_STEPS, MLA_REPS
    t0 = time.perf_counter()
    dm.pretile_mla_weights(params, cfg, block_n=1024)
    torch.cuda.synchronize()
    fast = params["fast"]
    wq = fast["wdqkv"]["q"]
    print(f"  pretile_mla_weights (bn 1024: wdqkv N {cfg.mm1_out} -> {wq.shape[1] * wq.shape[3]}"
          f", intermediate {cfg.intermediate_size} -> {fast['w2']['q'].shape[2]}) "
          f"{time.perf_counter() - t0:.1f} s")
    ps = cfg.page_size
    total_new = k_steps * (1 + reps)
    max_pages = -(-(ctx + total_new) // ps)
    num_pages = b * max_pages + 1
    kv = dm.init_kv_cache_combined(cfg, num_pages, quant="int8", device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    kv["kv"].copy_(torch.randint(-127, 128, kv["kv"].shape, generator=gen, dtype=torch.int8,
                                 device="cuda"))
    kv["s"].copy_(torch.rand(kv["s"].shape, generator=gen, device="cuda") * 0.02 + 0.001)
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(num_pages - 1)[: b * max_pages]
                           .reshape(b, max_pages) + 1).astype(np.int32)).cuda()
    pos0 = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    rows = torch.arange(b, device="cuda")

    def run_steps(kv, ids, pos):
        toks, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for _ in range(k_steps):
            slots = bt[rows, pos // ps] * ps + pos % ps
            logits, kv = dm.decode_step_c(params, cfg, kv, ids, pos, pos + 1, bt, slots)
            finite &= torch.isfinite(logits).all()
            ids = torch.argmax(logits, -1).to(torch.int32)
            toks.append(ids)
            pos = pos + 1
        return kv, ids, pos, torch.stack(toks), finite

    build.reset_launches()
    kv, ids, pos, _, finite = run_steps(kv, ids0, pos0)            # warm
    torch.cuda.synchronize()
    if not bool(finite):
        raise AssertionError("MLA bench path: logits are not finite")
    snap = ({k: v.clone() for k, v in kv.items()}, ids.clone(), pos.clone())
    times, first = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv, ids, pos, toks, finite = run_steps(kv, ids, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k_steps)
        if not bool(finite):
            raise AssertionError("MLA bench path: logits are not finite")
        first = toks if first is None else first
    launches = dict(build.launches)
    steps = k_steps * (1 + reps)
    for name, n in launches.items():
        want = MLA_PER_STEP.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"MLA bench path: {name} launched {n} times in {steps} steps,"
                                 f" not {want} ({MLA_PER_STEP.get(name, 0)} per step)")
    again = run_steps(*snap)[3]
    if not torch.equal(again, first):
        raise AssertionError("MLA bench path: a second run from the same state gave other "
                             "tokens")
    dt = float(np.median(times))
    tok_s = b / dt
    # bench.py's byte roofline (bench.py:352-370), with the row bytes of the
    # layout the port stores: 576 int8 + a 4-byte scale
    l, h, v = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    heads, qdim, f = cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.intermediate_size
    w_int8 = l * (h * cfg.mm1_out + cfg.q_lora_rank * heads * qdim
                  + heads * cfg.v_head_dim * h + h * 2 * f + f * h) + h * v
    w_f32 = l * (heads * cfg.qk_nope_dim * cfg.kv_lora_rank
                 + heads * cfg.kv_lora_rank * cfg.v_head_dim) * 4
    row_bytes = dm.combined_width(cfg) + 4
    kv_per_tok = l * row_bytes * (ctx + total_new // 2)
    from sgl_kernel_npu_tpu_torch.utils import H100
    roofline = H100.hbm_bytes_per_s / ((w_int8 + w_f32) / b + kv_per_tok)
    print(f"  MLA bench path B={b} ctx={ctx} ps={ps} int8 rows, {k_steps} steps x (1 warm + "
          f"{reps}): median {1e3 * dt:.3f} ms/step (steps {[round(1e3 * t, 3) for t in times]}),"
          f" {tok_s:.1f} tok/s; byte roofline at 3.35 TB/s {roofline:.1f} tok/s, share "
          f"{tok_s / roofline:.4f} [{gpu}]")
    print(f"  launches in {steps} steps: "
          + ", ".join(f"{k} {n} ({n // steps}/step)" for k, n in launches.items() if n)
          + "; every other kernel 0; repeat run identical")

    def step():
        slots = bt[rows, pos // ps] * ps + pos % ps
        return dm.decode_step_c(params, cfg, kv, ids, pos, pos + 1, bt, slots)
    profile_step(torch, step, _MLA_BUCKETS, "MLA bench step (B=128)")
    return launches


def small_qwen_config(qn):
    """Qwen3-Next's kernel widths (head dims 128, GQA in both attention kinds)
    at a small size: 4 layers (3 GDN, 1 attention), hidden 256, 1 qk and 2 v
    heads, 4 query and 2 kv heads, 8 experts top-2, intermediates 128, vocab
    512, 16-token pages."""
    return qn.QwenNextConfig(vocab_size=512, hidden_size=256, num_layers=4,
                             full_attention_interval=4, num_qk_heads=1, num_v_heads=2,
                             head_qk_dim=128, head_v_dim=128, num_heads=4, num_kv_heads=2,
                             head_dim=128, page_size=16, num_experts=8, top_k=2,
                             moe_intermediate_size=128, shared_intermediate_size=128,
                             max_position=256, num_loras=0)


def _qwen_state(torch, qn, cfg, b, pages, gen, dev, ssm_dtype=None):
    """A decode state of seeded random values where bench.py leaves zeros:
    conv N(0, 1) f32, the SSM pool 0.1 N(0, 1) (bf16 unless ssm_dtype says
    otherwise) and the caches N(0, 1) in bf16."""
    st = qn.init_state(cfg, b, pages, ssm_dtype=ssm_dtype or torch.bfloat16, device=dev)
    st["conv"].copy_(torch.randn(st["conv"].shape, generator=gen, device=gen.device))
    st["ssm"].copy_(0.1 * torch.randn(st["ssm"].shape, generator=gen, device=gen.device))
    for name in ("k_cache", "v_cache"):
        st[name].copy_(torch.randn(st[name].shape, generator=gen, device=gen.device))
    return st


def check_small_qwen(torch, qn):
    """The small Qwen config on the card and on the CPU (plain versions), from
    the same CPU-made weights and state: B = 8 at positions that cross page
    edges, three decode_step_q steps (K1, K8, K9, K10): logits calc_diff <
    8e-3 and equal greedy tokens at each step; the SSM pool and the caches
    within calc_diff 1e-4, the conv state within 1e-5 (f32 sums and bf16
    roundings in other orders)."""
    cfg = small_qwen_config(qn)
    ps, b, mp = cfg.page_size, 8, 3
    pages = b * mp + 1
    cpu_params = qn.init_params_q(cfg, 5, "cpu")
    gen = torch.Generator()
    gen.manual_seed(7)
    cpu_state = _qwen_state(torch, qn, cfg, b, pages, gen, "cpu")
    rng = np.random.default_rng(17)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    pos = np.array([0, ps - 1, ps, 2 * ps - 2, 5, 17, 30, 2 * ps + 3], np.int32)
    steps = []
    for _ in range(3):
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        steps.append((rng.integers(0, cfg.vocab_size, b).astype(np.int32), pos, pos + 1, bt,
                      slots))
        pos = pos + 1
    results = {}
    for dev in ("cuda", "cpu"):
        params, state = _to_device(cpu_params, dev), _to_device(cpu_state, dev)
        logits = []
        for args in steps:
            lg, state = qn.decode_step_q(params, cfg, state, *(torch.from_numpy(np.array(a))
                                                               .to(dev) for a in args))
            logits.append(lg.float().cpu())
        results[dev] = (logits, {k: v.float().cpu() for k, v in state.items()})
    diffs = [_calc_diff(a, r) for a, r in zip(results["cuda"][0], results["cpu"][0])]
    same = all(torch.equal(a.argmax(-1), r.argmax(-1))
               for a, r in zip(results["cuda"][0], results["cpu"][0]))
    if max(diffs) >= 8e-3 or not same or not all(bool(torch.isfinite(a).all())
                                                  for a in results["cuda"][0]):
        raise AssertionError(f"small Qwen config: logits calc_diff {diffs}, greedy tokens "
                             f"equal {same}")
    sdiff = {k: _calc_diff(results["cuda"][1][k], results["cpu"][1][k])
             for k in ("conv", "ssm", "k_cache", "v_cache")}
    if sdiff["conv"] >= 1e-5 or max(sdiff.values()) >= 1e-4:
        raise AssertionError(f"small Qwen config: state calc_diff {sdiff}")
    print(f"  small Qwen config (L=4: 3 GDN + 1 attention, hidden 256, head dims 128, 8 "
          f"experts top-2, ps=16), B=8, 3 steps: logits calc_diff per step "
          f"{[f'{x:.3g}' for x in diffs]}, greedy tokens equal; state calc_diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in sdiff.items()))


QWEN_BATCH, QWEN_CTX, QWEN_STEPS, QWEN_REPS = 128, 256, 8, 3
# launches of one decode_step_q step at bench.py's Qwen config (9 GDN + 3
# attention layers): K1 9 x 2 (wqkvz, wo) + 3 x 4 (wq, wk, wv, wo) + 12 x 2
# (shared w13, w2) + 1 (lm_head); K8 12 x 2; K9 9; K10 3
QWEN_PER_STEP = {"w8a8_gemm_tiled": 55, "w8a8_gemm_grouped": 24, "gdn_recurrent": 9,
                 "decode_hm": 3}
_QWEN_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K8 w8a8_gemm_grouped", _K8),
                 ("K9 gdn_recurrent", ("gdn_recurrent_kernel",)),
                 ("K10 decode_hm", ("decode_hm_kernel",)), ("memsets", ("Memset",)))


def run_qwen_bench_path(torch, qn, build, cfg, gpu):
    """What `python bench.py --config qwen` runs with its defaults
    (bench.py:497-588, SKT_QWEN_QUANT=1), on the port: init_params_q(cfg, 0)
    int8 weights, a bf16 SSM pool, batch 128, context 256, 128-token pages,
    8 greedy decode steps per call with argmax feeding the next id, one warm
    call then 3 timed. The state holds seeded random values where bench.py
    leaves zeros (same shapes and bytes). Returns the launch counts of the
    run."""
    b, ctx, k_steps, reps = QWEN_BATCH, QWEN_CTX, QWEN_STEPS, QWEN_REPS
    t0 = time.perf_counter()
    params = qn.init_params_q(cfg, 0, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  init_params_q {time.perf_counter() - t0:.1f} s ({nbytes / 1e9:.2f} GB)")
    ps = cfg.page_size
    total_new = k_steps * (1 + reps)
    max_pages = -(-(ctx + total_new) // ps)
    num_pages = b * max_pages + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = _qwen_state(torch, qn, cfg, b, num_pages, gen, "cuda")
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(num_pages - 1)[: b * max_pages]
                           .reshape(b, max_pages) + 1).astype(np.int32)).cuda()
    pos0 = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    rows = torch.arange(b, device="cuda")

    def run_steps(state, ids, pos):
        toks, finite = [], torch.ones((), dtype=torch.bool, device="cuda")
        for _ in range(k_steps):
            slots = bt[rows, pos // ps] * ps + pos % ps
            logits, state = qn.decode_step_q(params, cfg, state, ids, pos, pos + 1, bt, slots)
            finite &= torch.isfinite(logits).all()
            ids = torch.argmax(logits, -1).to(torch.int32)
            toks.append(ids)
            pos = pos + 1
        return state, ids, pos, torch.stack(toks), finite

    build.reset_launches()
    state, ids, pos, _, finite = run_steps(state, ids0, pos0)        # warm
    torch.cuda.synchronize()
    if not bool(finite):
        raise AssertionError("Qwen bench path: logits are not finite")
    snap = ({k: v.clone() for k, v in state.items()}, ids.clone(), pos.clone())
    times, first = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ids, pos, toks, finite = run_steps(state, ids, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k_steps)
        if not bool(finite):
            raise AssertionError("Qwen bench path: logits are not finite")
        first = toks if first is None else first
    launches = dict(build.launches)
    steps = k_steps * (1 + reps)
    for name, n in launches.items():
        want = QWEN_PER_STEP.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"Qwen bench path: {name} launched {n} times in {steps} "
                                 f"steps, not {want} ({QWEN_PER_STEP.get(name, 0)} per step)")
    again = run_steps(*snap)[3]
    if not torch.equal(again, first):
        raise AssertionError("Qwen bench path: a second run from the same state gave other "
                             "tokens")
    dt = float(np.median(times))
    tok_s = b / dt
    # bench.py's byte roofline (bench.py:572-583): every parameter but the
    # embedding, the KV rows at the mean context, the bf16 SSM state read and
    # written
    w_bytes = nbytes - params["embed"].numel() * params["embed"].element_size()
    kv_per_tok = cfg.num_attn_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2 * (
        ctx + total_new // 2)
    ssm_per_req = (cfg.num_gdn_layers * cfg.num_v_heads * cfg.head_qk_dim * cfg.head_v_dim
                   * 2 * 2)
    from sgl_kernel_npu_tpu_torch.utils import H100
    roofline = H100.hbm_bytes_per_s / (w_bytes / b + kv_per_tok + ssm_per_req)
    print(f"  Qwen bench path B={b} ctx={ctx} ps={ps}, {k_steps} steps x (1 warm + {reps}): "
          f"median {1e3 * dt:.3f} ms/step (steps {[round(1e3 * t, 3) for t in times]}), "
          f"{tok_s:.1f} tok/s; byte roofline at 3.35 TB/s {roofline:.1f} tok/s "
          f"({1e3 * b / roofline:.3f} ms/step), share {tok_s / roofline:.4f} [{gpu}]")
    print(f"  launches in {steps} steps: "
          + ", ".join(f"{k} {n} ({n // steps}/step)" for k, n in launches.items() if n)
          + "; every other kernel 0; repeat run identical")

    def step():
        slots = bt[rows, pos // ps] * ps + pos % ps
        return qn.decode_step_q(params, cfg, state, ids, pos, pos + 1, bt, slots)
    profile_step(torch, step, _QWEN_BUCKETS, "Qwen bench step (B=128)")
    return launches


# ------------------------------------------------------------ the EP MoE layer

# bench.py --config moe (bench.py:378-408): one MoE layer at the per-chip share
# of a DeepSeek-V3 deployment at EP 32 (8 local experts, hidden 7168,
# moe_intermediate 2048, top-8, 128 decode tokens), run at EP = 1
MOE_EL, MOE_H, MOE_F, MOE_T, MOE_K = 8, 7168, 2048, 128, 8
# K11's output rows and K13's int8 against their plain versions: both take the
# same f32 operations in the same order, so they are expected exact; the bar
# allows what a last-bit difference of exp could move: an int8 value by one
# LSB on at most this share of the entries (K13), an output row by two such
# flips times its largest weight (K11)
MOE_FLIP_SHARE = 1e-3
# calc_diff of a phase-8 layer output against its plain version, the bound
# of tests/test_torch_moe.py (LAYER_DIFF)
MOE_LAYER_DIFF = 1e-5


def moe_bench_data(torch):
    """bench.py's seed-0 data in its order (bench.py:399-408): x, topk_idx,
    topk_w, w13q, w13s, w2q, w2s, on the card."""
    el, h, f, t, k = MOE_EL, MOE_H, MOE_F, MOE_T, MOE_K
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((t, h)) * 0.3).to(torch.bfloat16)
    idx = np.stack([rng.choice(el, k, replace=False) for _ in range(t)]).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    w13q = rng.integers(-127, 128, (el, h, 2 * f)).astype(np.int8)
    w2q = rng.integers(-127, 128, (el, f, h)).astype(np.int8)
    out = [x, torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(w13q),
           torch.full((el, 2 * f), 2e-4), torch.from_numpy(w2q), torch.full((el, h), 2e-4)]
    return [a.cuda() for a in out]


def _moe_send_layout(torch, ll, pll, x, idx, el, maxt):
    """The "pallas" strategy's send layout at one rank: (x_send, counts,
    aligned offsets, window offsets)."""
    tok, _, counts, _, al, apos, sbuf = pll._send_layout(idx, 1, el, maxt)
    x_send = pll.send_buffer(x[tok], apos, sbuf)
    return x_send, counts, al, ll._window_offsets(1, el, maxt, x.device, 0)


class _DirtyEmpty:
    """A stand-in for a module's `torch` whose empty() and empty_like() hand
    back memory filled with 0x7f bytes (everything else is torch's own), so
    that a kernel that leaves a row of its output unwritten shows it."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def empty(self, *args, **kw):
        return self._dirty(self._torch.empty(*args, **kw))

    def empty_like(self, *args, **kw):
        return self._dirty(self._torch.empty_like(*args, **kw))

    def _dirty(self, out):
        if out.numel():
            out.view(-1).view(self._torch.uint8).fill_(0x7f)
        return out


@contextlib.contextmanager
def _dirty_empty(torch, module):
    """Within: `module`'s torch.empty and torch.empty_like give 0x7f-filled
    memory."""
    module.torch = _DirtyEmpty(torch)
    try:
        yield
    finally:
        module.torch = torch


# K12's edge layouts: (send_cnt, src_off, dst_off, src_rows, out_rows)
K12_EDGES = {
    "empty slice, ragged counts": ((13, 0, 32, 5), (0, 16, 16, 48), (0, 32, 64, 96), 64, 128),
    "chunk past src_rows": ((5, 12), (0, 16), (0, 32), 26, 64),
    "chunk past out_rows": ((8, 11), (0, 8), (0, 40), 24, 48),
    "gaps between windows": ((3, 9, 16), (0, 8, 24), (0, 24, 64), 40, 96),
    "offsets off a multiple of 8": ((7, 4), (3, 13), (5, 17), 16, 32),
    "no rows": ((0, 0, 0), (0, 0, 0), (0, 8, 16), 24, 24),
}


def _k12_call(torch, pll, g, args, kw):
    """One K12 call on windows that hold 0x7f bytes before it; raises unless
    its outputs equal the plain version's. Returns the call's keywords."""
    kw = dict(kw, group=g, slices_per_rank=args[2].numel())
    with _dirty_empty(torch, pll):
        out, s_out = pll._remote_scatter(*args, **kw)
    ref, s_ref = pll.remote_scatter_ref(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, ref) or (s_out is not None and not torch.equal(s_out, s_ref)):
        raise AssertionError("remote_scatter: differs from the plain version")
    return kw


def check_remote_scatter_edges(torch, pll, comm):
    """K12 bit-exact against its plain version at the edge layouts (an
    empty slice, counts off a multiple of 8, chunks past src_rows and past
    out_rows, gaps between windows, offsets off a multiple of 8, no rows),
    quantising bf16 and f32 rows and copying bf16 rows with their scales, at
    the MoE width, each call on windows that held 0x7f bytes just before."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(120)
    g, h, n = comm.EPGroup(None), MOE_H, 0
    for name, (cnt, so, do, src_rows, out_rows) in K12_EDGES.items():
        tables = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in (cnt, so, do)]
        x32 = torch.randn((src_rows, h), generator=gen, device="cuda") * 2
        sc = torch.rand((src_rows,), generator=gen, device="cuda")
        # quantise bf16, quantise f32, copy bf16 with scales
        for x, scales in ((x32.to(torch.bfloat16), None), (x32, None),
                          (x32.to(torch.bfloat16), sc)):
            _k12_call(torch, pll, g, (x, scales, *tables, tables[0]),
                      dict(out_rows=out_rows, quantize=scales is None))
            n += 1
    print(f"  remote_scatter edges: {n} calls at H {h} over {len(K12_EDGES)} layouts, each on "
          "windows of 0x7f bytes: exact")


def check_remote_scatter(torch, ll, pll, comm, data):
    """K12 at the bench shape: the pallas dispatch (the 1,088-row bf16 send
    buffer into the 1,024-row window, quantised) and its combine (1,024 bf16
    expert rows back into the send buffer's rows); exact against the plain
    version on windows that held 0x7f bytes, zero rows and padding scales
    included. Returns the rows of the dispatch and of the combine."""
    x, idx = data[0], data[1]
    el, maxt, h = MOE_EL, MOE_T, MOE_H
    x_send, counts, al, win = _moe_send_layout(torch, ll, pll, x, idx, el, maxt)
    sbuf = x_send.shape[0]
    g = comm.EPGroup(None)
    y = torch.randn((el * maxt, h), device="cuda").to(torch.bfloat16)
    sizes = (counts.long() + 7) // 8 * 8
    live = int(sizes.sum())
    cases = (
        ("dispatch (quantising)", (x_send, None, counts, al, win, counts),
         dict(out_rows=el * maxt, quantize=True), live * (2 * h + h + 4), None),
        ("combine (bf16)", (y, None, counts, win, al, counts),
         dict(out_rows=sbuf, quantize=False), live * 4 * h,
         (comm.loopback_targets(el * maxt, win, sizes, al, sbuf), y, sbuf)),
    )
    rows = []
    for name, args, kw, nbytes, lib_args in cases:
        kw = _k12_call(torch, pll, g, args, kw)
        ms = _time_ms(lambda: pll._remote_scatter(*args, **kw), 20, graph=True)
        plain = _time_ms(lambda: pll.remote_scatter_ref(*args, **kw), 3, 1)
        lib, lib_note = None, "no library call quantises and scatters"
        if lib_args is not None:
            tgt, src, out_rows = lib_args
            dst = torch.zeros((out_rows + 1, h), dtype=src.dtype, device="cuda")
            lib = _time_ms(lambda: dst.index_copy_(0, tgt, src), 20, graph=True)
            lib_note = (f"index_copy_ of the same rows {lib:.4f} ms (the kernel "
                        f"{'slower' if ms > lib else 'no slower'})")
        bound, by = _bound_ms(nbytes, 3.0 * live * h if kw["quantize"] else 0.0, "f32_flops")
        rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=0.0))
        print(f"  remote_scatter {name}: {live} live rows of {h}: exact on 0x7f windows; "
              f"kernel {ms:.4f} ms, plain {plain:.3f} ms, {lib_note}, bound {bound:.4f} ms "
              f"({by})")
    return rows


def _k11_args(torch, ll, pll, x, idx, weights, el, maxt):
    x_send, counts, al, win = _moe_send_layout(torch, ll, pll, x, idx, el, maxt)
    return (x_send, *weights, counts, al, win, counts, al)


def _check_k11_once(torch, fmp, EPGroup, args, label, maxt=MOE_T):
    """K11 against its plain version on one input: recv and rs exact, back
    within the flip bar. Returns max-abs of back."""
    g = EPGroup(None)
    recv, rs, back = fmp.fused_moe_layer(*args, group=g, maxt=maxt)
    precv, prs, pback = fmp.fused_moe_layer_ref(*args, group=g, maxt=maxt)
    torch.cuda.synchronize()
    if not (torch.equal(recv, precv) and torch.equal(rs, prs)):
        raise AssertionError(f"fused_moe {label}: recv / rs differ from the plain version")
    if not all(torch.equal(u, v) for u, v in zip((recv, rs, back),
                                                 fmp.fused_moe_layer(*args, group=g, maxt=maxt))):
        raise AssertionError(f"fused_moe {label}: a second call differs")
    _, _, asc = fmp.expert_rows_ref(precv, prs, *args[1:5])
    # the rows of back come from expert rows in chunk order; a flipped int8
    # activation moves its output row by at most asc * 127 * max|w2 scale|
    # per flip (2 allowed)
    bar = 2 * float(asc.max()) * 127 * float(args[4].abs().max())
    a, b = back.double(), pback.double()
    err = (a - b).abs()
    ok = err <= 2.0 ** -7 * b.abs() + bar
    rows_off = float((err > 0).any(dim=1).double().mean())
    if not bool(ok.all()) or rows_off > MOE_FLIP_SHARE * 10:
        raise AssertionError(f"fused_moe {label}: back max-abs {float(err.max()):.3g}, "
                             f"{rows_off:.4f} of rows differ")
    return float(err.max()), rows_off


def check_fused_moe(torch, ll, pll, fmp, fm_buffer_rounds1, EPGroup, data):
    """K11 at the bench shape (8 experts of 7168 x 4096 and 2048 x 7168,
    128 tokens top-8: 1,024 rows, sbuf 1,088), then with every copy on expert
    0 (7 experts of no rows) and with two experts and -1 slots; at maxT 8
    and 72 (a window's one m-tile partial) with the bench routing and with
    every copy on one expert, where a GEMM item that read its rows before
    they were written would show: recv and rs exact, back within the flip
    bar, a second call bit-identical. Returns its row; the yardstick is the
    composition at rounds = 1 (K8 twice and PyTorch glue), not one call."""
    x, idx, w = data[0], data[1], data[2]
    weights = data[3:]
    el, maxt, h, f = MOE_EL, MOE_T, MOE_H, MOE_F
    args = _k11_args(torch, ll, pll, x, idx, weights, el, maxt)
    err, rows_off = _check_k11_once(torch, fmp, EPGroup, args, "bench routing")
    one = torch.full_like(idx, -1)
    one[:, 0] = 0
    two = torch.full_like(idx, -1)
    two[:, :2] = torch.tensor([3, 5], dtype=idx.dtype, device="cuda")
    two[::3, 1] = -1
    for label, rt in (("every copy on expert 0", one), ("experts 3 and 5, -1 slots", two)):
        _check_k11_once(torch, fmp, EPGroup, _k11_args(torch, ll, pll, x, rt, weights, el, maxt),
                        label)
    # maxT not a multiple of the 128-row tile: a partial m-tile per window
    small = []
    for mt in (8, 72):
        e, r = _check_k11_once(torch, fmp, EPGroup,
                               _k11_args(torch, ll, pll, x[:mt], idx[:mt], weights, el, mt),
                               f"maxT {mt}", maxt=mt)
        _check_k11_once(torch, fmp, EPGroup,
                        _k11_args(torch, ll, pll, x[:mt], one[:mt], weights, el, mt),
                        f"maxT {mt}, every copy on expert 0", maxt=mt)
        small.append(f"maxT {mt} ({mt} tokens): back max-abs {e:.3g} ({r:.4f} of rows differ)")
    g = EPGroup(None)
    ms = _time_ms(lambda: fmp.fused_moe_layer(*args, group=g, maxt=maxt), 10, graph=True)
    plain = _time_ms(lambda: fmp.fused_moe_layer_ref(*args, group=g, maxt=maxt), 2, 1)
    comp = _time_ms(fm_buffer_rounds1, 10, graph=True)
    sbuf = args[0].shape[0]
    rows = el * maxt
    nbytes = (sum(t.numel() * t.element_size() for t in args[:5]) + rows * (h + 4)
              + sbuf * h * 2)
    bound, by = _bound_ms(nbytes, 2.0 * rows * 3 * h * f, "int8_ops")
    print(f"  fused_moe (one launch) at the bench shape: recv, rs exact, back max-abs {err:.3g} "
          f"({rows_off:.4f} of rows differ); every copy on one expert and -1 slots: the same; "
          f"recv, rs exact at {'; '.join(small)} (and every copy on one expert); second "
          "calls bit-identical; "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms ({by}); the "
          f"composition at rounds = 1 (not one call) {comp:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err), comp


def check_moe_gemms(torch, par, fm, mm, data):
    """K8 at the shapes the EP MoE layer gives it: the first round's aligned
    compaction (128-row tiles, one 128-row wgmma tile each) at chunk_rounds
    1, 2 and 4 (M 2,048, 1,536 and 1,280; capacity_rows=1024 is rounds = 1's
    compaction), GMM1 on the [8, 7168, 4096] bank and, on its requantised
    SwiGLU, GMM2 on the [8, 2048, 7168] bank: exact against the plain
    version, a second call bit-identical, one kernel a call. Returns the row
    of rounds = 1's two GEMMs summed."""
    x, idx = data[0], data[1]
    w13q, w13s, w2q, w2s = data[3:]
    el, t, k = MOE_EL, MOE_T, MOE_K
    strat = par.get_low_latency_strategy("default")
    g = par.EPGroup(None)
    rows, shapes = [], []
    for rounds in (1, 2, 4):
        tr = t // rounds
        maxt_r = min(t, max(tr, 8))
        res = strat.low_latency_dispatch(x[:tr], idx[:tr], group=g, num_experts=el,
                                         num_max_dispatch_tokens_per_rank=maxt_r,
                                         quant_mode="int8")
        _, ok, a, a_s, eid = fm._compact_rows(res, 1, el, maxt_r, maxt_r * min(k, el), True)
        tile = fm.GEMM_TILE
        m = a.shape[0]
        live = ok.reshape(-1, tile).any(1).tolist()
        groups = _expert_groups(eid.tolist(), live, tile)
        shapes.append(m)
        for name, w, ws in (("GMM1", w13q, w13s), ("GMM2", w2q, w2s)):
            args = (a, w, a_s, ws, eid, tile)
            out = mm.grouped_matmul_int8(*args)
            again = mm.grouped_matmul_int8(*args)
            ref = mm.grouped_matmul_int8_tiles_ref(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"w8a8_gemm_grouped {name} at chunk_rounds={rounds} (M={m}): "
                                     f"{(out != ref).sum().item()} elements differ")
            if not torch.equal(out, again):
                raise AssertionError(f"w8a8_gemm_grouped {name} at chunk_rounds={rounds}: a "
                                     "second call differs")
            kernels = _device_kernels(torch, lambda: mm.grouped_matmul_int8(*args))
            if kernels is not None and len(kernels) != 1:
                raise AssertionError(f"w8a8_gemm_grouped {name} at chunk_rounds={rounds}: one "
                                     f"call launched {kernels}")
            if rounds == 1:
                kk, n = w.shape[1], w.shape[2]
                xg, xsg = a, a_s

                def library():
                    y = torch.zeros((m, n), dtype=torch.bfloat16, device="cuda")
                    for e, r0, r1 in groups:
                        acc = torch._int_mm(xg[r0:r1], w[e])
                        y[r0:r1] = (acc.float() * xsg[r0:r1] * ws[e][None]).to(torch.bfloat16)
                    return y
                if not torch.equal(library(), ref):
                    raise AssertionError(f"torch._int_mm per expert group disagrees ({name})")
                ms = _time_ms(lambda: mm.grouped_matmul_int8(*args), 20, graph=True)
                plain = _time_ms(lambda: mm.grouped_matmul_int8_tiles_ref(*args), 1, 1)
                lib = _time_ms(library, 5, graph=True)
                n_exp = len({e for e, _, _ in groups})
                nbytes = n_exp * (kk * n + 4 * n) + m * kk + 4 * m + 2 * m * n + 4 * eid.numel()
                bound, by = _bound_ms(nbytes, 2.0 * int(ok.sum()) * kk * n, "int8_ops")
                rows.append(dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                 bound_by=by, max_abs_err=0.0))
                print(f"  w8a8_gemm_grouped MoE {name} M={m} ({int(ok.sum())} rows, {n_exp} "
                      f"experts, tiles of {tile}) K={kk} N={n}: exact; kernel {ms:.4f} ms, "
                      f"plain {plain:.3f} ms, _int_mm per expert group {lib:.4f} ms, bound "
                      f"{bound:.4f} ms ({by})")
            if name == "GMM1":
                a, a_s = fm._swiglu_requant(ref)
    print(f"  w8a8_gemm_grouped exact at the first round of chunk_rounds 1, 2, 4 (M {shapes}), "
          "GMM1 and GMM2")
    return _sum_rows(rows)


# K13's forms beyond the bench shape: (label, rows, N, dtype, do_limit, the
# group list, its type: 0 cumulative, any other counts); limit 3.0 where
# do_limit, so that the clamp bites on inputs of 2 standard deviations. The
# widths take every branch of the kernel's host plan (csrc/swiglu_quant.cu:
# the chunks a thread keeps): N 64 one (a warp a row), 1,003 and 2,048 two,
# 8,192 four, 8,200 none (computed twice); 1,003 the scalar tail.
K13_FORMS = (
    ("f32 x", 2048, MOE_F, "float32", False, (600, 0, 424), 1),
    ("do_limit", 2048, MOE_F, "bfloat16", True, (600, 0, 424), 1),
    ("f32 x, do_limit", 2048, MOE_F, "float32", True, (600, 0, 424), 1),
    ("N 1,003 (no multiple of 8)", 2048, 1003, "bfloat16", False, (600, 0, 424), 1),
    ("N 1,003 f32, do_limit", 515, 1003, "float32", True, (300, 7), 1),
    ("N 64 (8 rows a block)", 1000, 64, "bfloat16", False, (999,), 1),
    ("N 8,192 (four chunks a thread)", 300, 8192, "bfloat16", False, (150, 1), 1),
    ("N 8,200 (computed twice)", 300, 8200, "bfloat16", True, (150, 1), 1),
    ("total 0", 2048, MOE_F, "bfloat16", False, (0,), 1),
    ("total = S", 2048, MOE_F, "bfloat16", False, (2048,), 1),
    ("cumulative list", 2048, MOE_F, "bfloat16", False, (600, 600, 1024), 0),
    ("cumulative list f32, N 1,003", 515, 1003, "float32", True, (300, 307), 0),
    ("empty list of counts", 512, MOE_F, "bfloat16", False, (), 1),
    ("list type 2 (counts)", 600, MOE_F, "float32", True, (100, 200), 2),
)
K13_LIMIT = 3.0


def k13_inputs(torch, gen, s, n, dtype, group_list):
    """K13's x [s, 2n] (2 randn, rounded to `dtype`) and its group list, on
    the card."""
    x = (torch.randn((s, 2 * n), generator=gen, device="cuda") * 2).to(dtype)
    return x, torch.tensor(group_list, dtype=torch.int32, device="cuda")


def _k13_check(torch, act, label, x, gl, do_limit, list_type=1):
    """One K13 call on outputs of 0x7f bytes against its plain version:
    int8 within the flip bar, scales within one f32 ulp, rows past the
    total zero. Returns the largest int8 difference and its share."""
    kw = dict(do_limit=do_limit, limit=K13_LIMIT)
    with _dirty_empty(torch, act):
        q, sc = act.swiglu_quant(x, gl, list_type, **kw)
    rq, rsc = act.swiglu_quant_ref(x, gl, list_type, **kw)
    torch.cuda.synchronize()
    total = int(act.total_rows_from_group_list(gl, list_type))
    d = (q.int() - rq.int()).abs()
    share = float((d > 0).double().mean())
    if int(d.max()) > 1 or share > MOE_FLIP_SHARE:
        raise AssertionError(f"swiglu_quant {label}: int8 max diff {int(d.max())}, share "
                             f"{share:.5f}")
    ulp = torch.nextafter(rsc.abs(), torch.full_like(rsc, float("inf"))) - rsc.abs()
    if not bool(((sc - rsc).abs() <= ulp).all()) or q[total:].any() or sc[total:].any():
        raise AssertionError(f"swiglu_quant {label}: scales beyond one ulp, or rows past the "
                             "total set")
    return int(d.max()), share


def check_swiglu_quant(torch, act, floor):
    """K13 at the MoE shape of GMM1's output: 2,048 aligned rows x 4096 bf16,
    total_rows 1024 (a group list of counts), and at K13_FORMS: int8 within
    the flip bar, scales within one f32 ulp, rows past the total zero.
    `floor`: the card's launch floor at K13's grid, in ms, printed beside
    the bound."""
    s, n2, total = 2048, 2 * MOE_F, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    x, gl = k13_inputs(torch, gen, s, MOE_F, torch.bfloat16, (600, 0, 424))
    err, share = _k13_check(torch, act, "bench shape", x, gl, False)
    ms = _time_ms(lambda: act.swiglu_quant(x, gl, 1), 20, graph=True)
    plain = _time_ms(lambda: act.swiglu_quant_ref(x, gl, 1), 5, 1)
    nbytes = total * n2 * 2 + s * n2 // 2 + 4 * s
    bound, by = _bound_ms(nbytes, 8.0 * total * n2 // 2, "f32_flops")
    print(f"  swiglu_quant {s} x {n2} (total_rows {total}): {share:.5f} of int8 entries 1 "
          f"apart, scales within one ulp; kernel {ms:.4f} ms, plain {plain:.3f} ms, bound "
          f"{bound:.4f} ms ({by}), launch floor {floor:.4f} ms")
    forms = []
    for label, rows, n, dt, do_limit, gls, gtype in K13_FORMS:
        xf, glf = k13_inputs(torch, gen, rows, n, getattr(torch, dt), gls)
        e, sh = _k13_check(torch, act, label, xf, glf, do_limit, gtype)
        err = max(err, e)
        t = _time_ms(lambda: act.swiglu_quant(xf, glf, gtype, do_limit=do_limit,
                                              limit=K13_LIMIT), 20, graph=True)
        total = int(act.total_rows_from_group_list(glf, gtype))
        forms.append(f"{label} [{rows} x {2 * n}, total {total}] {sh:.5f} apart, {t:.4f} ms")
    print(f"  swiglu_quant forms on 0x7f outputs, within the bar: {'; '.join(forms)}")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=float(err))


# exact launches per call of each phase-8 variant; every other kernel 0
MOE_VARIANTS = {
    "rounds=1": {"w8a8_gemm_grouped": 2},
    "rounds=2": {"w8a8_gemm_grouped": 4},
    "rounds=4": {"w8a8_gemm_grouped": 8},
    "pallas_fused": {"fused_moe": 1},
    "pallas capacity_rows=1024": {"remote_scatter": 2, "w8a8_gemm_grouped": 2},
    "pallas dispatch+combine": {"remote_scatter": 2},
}
_MOE_BUCKETS = (("K8 w8a8_gemm_grouped", _K8), ("K11 fused_moe", ("fused_moe_kernel",)),
                ("K12 remote_scatter", ("remote_scatter_kernel",)), ("memsets", ("Memset",)))


def moe_variants(torch, par, data):
    """The calls of phase 8 by name: bench.py's four variants, the pallas
    strategy's capacity tier and its dispatch -> combine (the combine of the
    dequantised rows, x * sum of the weights)."""
    x, idx, w = data[0], data[1], data[2]
    weights = data[3:]
    kw = dict(num_max_dispatch_tokens_per_rank=MOE_T)
    dflt = par.Buffer(None, MOE_EL, **kw)
    pal = par.Buffer(None, MOE_EL, low_latency_strategy="pallas", **kw)

    def ll_pair():
        recv, sc, _, _, hd = pal.low_latency_dispatch(x, idx)
        return pal.low_latency_combine((recv.float() * sc[..., None]).to(torch.bfloat16), idx,
                                       w, hd)
    return {
        "rounds=1": lambda: dflt.fused_deep_moe(x, idx, w, *weights, chunk_rounds=1),
        "rounds=2": lambda: dflt.fused_deep_moe(x, idx, w, *weights, chunk_rounds=2),
        "rounds=4": lambda: dflt.fused_deep_moe(x, idx, w, *weights, chunk_rounds=4),
        "pallas_fused": lambda: pal.fused_deep_moe(x, idx, w, *weights),
        "pallas capacity_rows=1024": lambda: pal.fused_deep_moe(x, idx, w, *weights,
                                                                capacity_rows=1024),
        "pallas dispatch+combine": ll_pair,
    }


def _tier_share(out, ref):
    """Largest |out - ref| / (0.05 + 0.05 |ref|): at most 1 passes the JAX
    package's tier bound (tests/test_fused_moe_pallas.py:62)."""
    a, b = out.double(), ref.double()
    return float(((a - b).abs() / (0.05 + 0.05 * b.abs())).max())


def run_moe_bench_path(torch, par, build, data, gpu):
    """What `python bench.py --config moe` runs (bench.py:378-494) on the
    port at EP = 1: every variant once with the counts at 0 (exact launches
    per call), once more from the same inputs (bit-identical), finite,
    within the tier bound of rounds = 1 (the dispatch -> combine pair: of
    x * sum of the weights); then each one's device time by CUDA graph
    replay, tok/s, bench.py's roofline share and a profiler split. Returns
    the launch counts of the run."""
    x, w = data[0], data[2]
    calls = moe_variants(torch, par, data)
    build.reset_launches()
    outs = {}
    for name, fn in calls.items():
        before = dict(build.launches)
        outs[name] = fn()
        delta = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
        if delta != MOE_VARIANTS[name]:
            raise AssertionError(f"moe {name}: launches {delta}, not {MOE_VARIANTS[name]}")
        again = fn()
        torch.cuda.synchronize()
        if not torch.equal(again, outs[name]):
            raise AssertionError(f"moe {name}: a second call from the same inputs differs")
        if not bool(torch.isfinite(outs[name].float()).all()):
            raise AssertionError(f"moe {name}: output not finite")
    launches = dict(build.launches)
    # every variant against the same call through every kernel's plain
    # version on the same card tensors (SKT_IMPL=ref: the tight compaction
    # and the ragged reference GEMM, K11's and K12's plain versions)
    was = os.environ.get("SKT_IMPL")
    os.environ["SKT_IMPL"] = "ref"
    try:
        plain = {name: fn() for name, fn in calls.items()}
    finally:
        if was is None:
            del os.environ["SKT_IMPL"]
        else:
            os.environ["SKT_IMPL"] = was
    if dict(build.launches) != launches:
        raise AssertionError("a plain run of phase 8 launched a kernel")
    diffs = {name: _calc_diff(outs[name], plain[name]) for name in calls}
    bad = {name: d for name, d in diffs.items() if not d < MOE_LAYER_DIFF}
    if bad:
        raise AssertionError(f"moe: calc_diff against the plain composition {bad}")
    print(f"  calc_diff of each variant against its plain version (bound {MOE_LAYER_DIFF}): "
          f"{ {name: float(f'{d:.3g}') for name, d in diffs.items()} }")
    ident = (x.float() * w.sum(-1, keepdim=True)).to(torch.bfloat16)
    # bench.py's roofline (bench.py:481-485): the int8 expert weights plus the
    # token traffic (int8 dispatch, bf16 expert output, bf16 combine)
    el, h, f, t, k = MOE_EL, MOE_H, MOE_F, MOE_T, MOE_K
    from sgl_kernel_npu_tpu_torch.utils import H100
    bound_ms = 1e3 * (el * (h * 2 * f + f * h) + t * k * h * 5) / H100.hbm_bytes_per_s
    for name, fn in calls.items():
        ref = ident if name == "pallas dispatch+combine" else outs["rounds=1"]
        share = _tier_share(outs[name], ref)
        if share > 1.0:
            raise AssertionError(f"moe {name}: {share:.3f} of the tier bound")
        try:
            ms, how = _time_ms(fn, 10, graph=True), "graph replay"
        except RuntimeError as e:
            torch.cuda.synchronize()
            ms, how = _time_ms(fn, 10), f"events (capture failed: {str(e)[:60]})"
        print(f"  moe {name}: {ms:.4f} ms per call ({how}), {t / ms * 1e3:.1f} tok/s, "
              f"bench.py roofline share {bound_ms / ms:.4f} (bound {bound_ms:.4f} ms); "
              f"{share:.3f} of the tier bound vs "
              f"{'x * sum(w)' if name == 'pallas dispatch+combine' else 'rounds=1'}; "
              f"launches {MOE_VARIANTS[name]}, repeat identical [{gpu}]")
        profile_step(torch, fn, _MOE_BUCKETS, f"moe {name}")
    return launches


# ------------------------------------------------- the attentions surface

# Meta-Llama-3-8B's attention heads (LlamaConfig()) for laser attention and
# the sparse prefill; bench_ops.py:436 / :469's shapes and DeepSeek-V2-Lite's
# latent rows (bench.py:281-284) for the top-k decode and the estimator
ATT_HQ, ATT_HKV, ATT_D = 32, 8, 128
LASER_CASES = ((8192, True), (4096, False), (8000, True))   # (T, causal)
# shorter than and ragged against K17's 128-row tiles: held, not timed
LASER_EDGE_CASES = ((96, True), (96, False), (1000, True), (1000, False))
EST_SHAPES = ((1, 8, 8192), (4, 16, 4096))                   # (B, H, T) at D 128
EST_LONG = (1, 8, 32768)
EST_BLOCK = 128
TOPK_SHAPES = (("bench_ops", 64, 128, 128, 512), ("latent", 128, 576, 512, 4096))
TOPK_H, TOPK_PS, TOPK_KB = 16, 128, 256
NORM_D, NORM_ROWS = 4096, (8192, 128)
# the kernels line's row for each case above, in the same order
LASER_NAMES = ("laser_attention", "laser_attention (not causal)", "laser_attention (T 8000)")
TOPK_NAMES = ("topk_block_sparse", "topk_block_sparse (latent rows)")
NORM_NAMES = ("add_rmsnorm_quant", "add_rmsnorm_quant (N 128)")
# K17 against its plain version: p kept to 16 bits (hi + lo bf16 parts) and
# the f32 sums in another order; K18's scores: f32 order; K19 all f32; K15
# against K17 (the keep 1.0 cross-check): both within that of the exact
# value, so twice the share
ATT_SHARE = K10_SHARE
# K20 against its plain version: the same f32 steps and the same float64
# rstd, expected exact; a value on a rounding boundary may move by one
K20_FLIP_SHARE = 1e-4


def _laser_inputs(torch, t, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((1, ATT_HQ, t, ATT_D), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, ATT_HKV, t, ATT_D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v


def check_laser(torch, pf):
    """K17 at Llama-3-8B's heads (32 / 8, D 128, bf16), B 1: causal T 8192
    (the full context), not causal T 4096, causal T 8000 (a length the TPU
    kernel gets wrong), each against its plain version (f32 in blocks of
    256). Returns a row for each case, in LASER_CASES' order."""
    sm = ATT_D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i, (t, causal) in enumerate(LASER_CASES):
        q, k, v = _laser_inputs(torch, t, 170 + i)
        out = pf.laser_attention(q, k, v, sm, causal)
        ref = pf.laser_attention_blocked_ref(q, k, v, sm, causal)
        torch.cuda.synchronize()
        err, ratio = _bf16_check(f"laser_attention T={t} causal={causal}", out, ref, ATT_SHARE)
        ms = _time_ms(lambda: pf.laser_attention(q, k, v, sm, causal), 10, graph=True)
        plain_ms = _time_ms(lambda: pf.laser_attention_blocked_ref(q, k, v, sm, causal), 2, 1)
        def library():
            return sdpa(q, k, v, is_causal=causal, scale=sm, enable_gqa=True)
        lib_err = (library().float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 10, graph=True)
        ops = 4.0 * ATT_D * ATT_HQ * (t * (t + 1) / 2 if causal else float(t) * t)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = _bound_ms(nbytes, ops, "bf16_flops")
        f32_bound = _bound_ms(nbytes, ops, "f32_flops")[0]
        print(f"  laser_attention B=1 Hq={ATT_HQ} Hkv={ATT_HKV} T={t} causal={causal}: max-abs "
              f"{err:.3g} ({ratio:.3g} of its bound, max|plain| "
              f"{float(ref.float().abs().max()):.3g}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, SDPA (is_causal, enable_gqa) {lib:.4f} ms (max-abs vs "
              f"plain {lib_err:.3g}); {ops:.3e} operations: bound {bound:.4f} ms at the bf16 "
              f"tensor-core rate K17 runs ({by}), {f32_bound:.4f} ms at the f32 rate")
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                         bound_by=by, max_abs_err=err))
        del q, k, v, out, ref
    for i, (t, causal) in enumerate(LASER_EDGE_CASES):
        q, k, v = _laser_inputs(torch, t, 180 + i)
        calls = _Launches(pf._build)
        out = pf.laser_attention(q, k, v, sm, causal)
        launched = {k_: n for k_, n in calls.delta().items() if n}
        if launched != {"laser_attention": 1}:
            raise AssertionError(f"laser_attention T={t}: launched {launched}")
        ref = pf.laser_attention_blocked_ref(q, k, v, sm, causal)
        torch.cuda.synchronize()
        err, ratio = _bf16_check(f"laser_attention T={t} causal={causal}", out, ref, ATT_SHARE)
        print(f"  laser_attention B=1 Hq={ATT_HQ} Hkv={ATT_HKV} T={t} causal={causal}: max-abs "
              f"{err:.3g} ({ratio:.3g} of its bound), launches laser_attention 1")
    return rows


# K17's routes at widths and edges phase 21 does not time: (D, Dv, dtype, T,
# causal, the kernel that must take it). The bf16 / fp16 kernel's padded
# tiles ((8, 8) -> (64, 64), (128, 64) -> (128, 128) with V's second box
# wholly past Dv, (136, 64) -> (192, 128), (200, 40) -> (256, 256)) and the
# split-TF32 kernel at each padded width W (32, 64, 96, 128, 256) on each of
# its loads: TMA (f32, D and Dv % 4 == 0), cp.async (f32 at other widths) and
# widened 16-bit rows (bf16 / fp16 not a multiple of 8); T 1, ragged T, GQA
# 4 / 2, B 2
LASER_EDGES = (
    (80, 80, "float16", 300, True, "laser_attention"),
    (8, 8, "bfloat16", 129, True, "laser_attention"),
    (128, 64, "bfloat16", 200, False, "laser_attention"),
    (136, 64, "bfloat16", 257, True, "laser_attention"),
    (200, 40, "float16", 100, True, "laser_attention"),
    (96, 96, "bfloat16", 1, True, "laser_attention"),
    (96, 96, "float32", 300, True, "laser_attention_general"),
    (32, 32, "float32", 77, False, "laser_attention_general"),
    (64, 48, "float32", 200, True, "laser_attention_general"),
    (128, 128, "float32", 150, True, "laser_attention_general"),
    (192, 128, "float32", 130, False, "laser_attention_general"),
    (256, 256, "float32", 70, True, "laser_attention_general"),
    (100, 100, "float32", 260, True, "laser_attention_general"),
    (33, 17, "float32", 100, True, "laser_attention_general"),
    (1, 1, "float32", 50, True, "laser_attention_general"),
    (255, 255, "float32", 65, True, "laser_attention_general"),
    (95, 95, "bfloat16", 130, True, "laser_attention_general"),
    (20, 36, "float16", 90, False, "laser_attention_general"),
    (255, 250, "bfloat16", 40, True, "laser_attention_general"),
    (96, 96, "float32", 1, True, "laser_attention_general"),
)


def check_laser_edges(torch, pf):
    """K17's routes at LASER_EDGES, B 2, Hq 4 / Hkv 2: exactly one launch of
    the kernel the row names, finite, a second call bit-identical, within
    phase 21's bar of its dtype against the plain version (f32 also on
    inputs scaled by 1e3)."""
    for i, (d, dv, dtype, t, causal, name) in enumerate(LASER_EDGES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2140 + i)
        q = _width_randn(torch, gen, (2, 4, t, d), dtype, "cuda")
        k = _width_randn(torch, gen, (2, 2, t, d), dtype, "cuda")
        v = _width_randn(torch, gen, (2, 2, t, dv), dtype, "cuda")
        sm = d ** -0.5
        for scale in (1.0, 1e3) if dtype == "float32" else (1.0,):
            qs, ks, vs = (x * scale for x in (q, k, v))
            calls = _Launches(pf._build)
            out = pf.laser_attention(qs, ks, vs, sm, causal)
            launched = {k_: n for k_, n in calls.delta().items() if n}
            if launched != {name: 1}:
                raise AssertionError(f"laser_attention (D {d}, Dv {dv}, {dtype}): launched "
                                     f"{launched}, not {name} once")
            again = pf.laser_attention(qs, ks, vs, sm, causal)
            ref = pf.laser_attention_blocked_ref(qs, ks, vs, sm, causal)
            torch.cuda.synchronize()
            label = (f"laser_attention (D {d}, Dv {dv}, {dtype}, T {t}, "
                     f"{'causal' if causal else 'not causal'}{', x 1e3' if scale != 1.0 else ''})")
            if not torch.equal(out, again):
                raise AssertionError(f"{label}: a second call differs")
            err, ratio, what = _width_check(label, out, ref, dtype)
            print(f"  {label} on {name}: max-abs {err:.3g}, {ratio:.3g} of its bar ({what})")


def _mask_flips(name, ref_scores, mask, ref_mask, keep):
    """The estimator's masks from K18's and the plain scores must agree; an
    entry may flip only where its score lies within f32 rounding of its
    row's threshold. Names the flipped entries and returns them."""
    flips = (mask != ref_mask).nonzero().tolist()
    if flips:
        nk = ref_scores.shape[-1]
        thresh = ref_scores.sort(dim=-1).values[..., nk - keep:nk - keep + 1]
        top = ref_scores.abs().masked_fill(ref_scores < -1e29, 0).amax(-1, keepdim=True)
        near = (ref_scores - thresh).abs() <= 1e-5 * top
        far = [f for f in flips if not bool(near[tuple(f)])]
        if far:
            raise AssertionError(f"{name}: mask entries {far[:8]} flipped away from the "
                                 "threshold")
        print(f"  {name}: mask entries flipped within f32 rounding of the threshold: {flips}")
    return flips


def _estimate_case(torch, sp, name, q, k, causal):
    """K18 on bf16 q [BH, NQ*128, 128], k [BH, NK*128, 128] against its plain
    version: scores within 1e-5 of the largest |score| (the -1e30 entries
    exact), the keep-0.25 masks equal or flipped only at the threshold;
    timed by graph replay. Returns the kernels line's row."""
    bh, nq, nk = q.shape[0], q.shape[1] // EST_BLOCK, k.shape[1] // EST_BLOCK
    sc = sp.block_scores(q, k, EST_BLOCK, causal)
    ref = sp.block_scores_ref(q, k, EST_BLOCK, causal)
    again = sp.block_scores(q, k, EST_BLOCK, causal)
    torch.cuda.synchronize()
    if not torch.equal(sc, again):
        raise AssertionError(f"sparse_estimate {name}: a second call differs")
    live = ref > -1e29
    if not torch.equal(sc[~live], ref[~live]):
        raise AssertionError(f"sparse_estimate {name}: the causal -1e30 entries differ")
    err = float((sc[live] - ref[live]).abs().max())
    top = float(ref[live].abs().max())
    if not err <= 1e-5 * top:
        raise AssertionError(f"sparse_estimate {name}: max-abs {err:.3g} over 1e-5 of {top:.3g}")
    keep = max(1, int(nk * 0.25))
    mask, _ = sp._threshold(sc[None], 0.25, causal, True, True)
    ref_mask, _ = sp._threshold(ref[None], 0.25, causal, True, True)
    flips = _mask_flips(f"sparse_estimate {name}", ref[None], mask, ref_mask, keep)
    ms = _time_ms(lambda: sp.block_scores(q, k, EST_BLOCK, causal), 20, graph=True)
    plain_ms = _time_ms(lambda: sp.block_scores_ref(q, k, EST_BLOCK, causal), 5, 1)
    nbytes = 2.0 * (q.numel() + k.numel()) + 4.0 * bh * nq * nk
    ops = 2.0 * (q.numel() + k.numel()) / 2 + 2.0 * bh * nq * nk * ATT_D
    bound, by = _bound_ms(nbytes, ops, "f32_flops")
    print(f"  sparse_estimate {name} blocks of {EST_BLOCK} (NQ {nq}, NK {nk}, causal {causal}): "
          f"scores max-abs {err:.3g} (max {top:.3g}), keep-0.25 mask "
          f"{'equal' if not flips else f'{len(flips)} flips at the threshold'}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, no library call; bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def check_sparse_estimate(torch, sp):
    """K18 at the sparse prefill's shape ([1, 8, 8192, 128], blocks of 128)
    and bench_ops.py:469's ([4, 16, 4096, 128]), causal, bf16; then at
    [1, 8, 32768] (NQ + NK = 512, past what K18 took before its pooled rows
    went to a workspace) not causal, and q of 8192 rows against k of
    32768, causal. Returns the rows of the sparse prefill's shape and of T
    32768 not causal."""
    rows = []
    for i, (b, h, t) in enumerate(EST_SHAPES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(180 + i)
        q, k = (torch.randn((b * h, t, ATT_D), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        row = _estimate_case(torch, sp, f"[{b}, {h}, {t}, {ATT_D}]", q, k, True)
        if i == 0:
            rows.append(row)
        del q, k
    b, h, t = EST_LONG
    gen = torch.Generator(device="cuda")
    gen.manual_seed(182)
    q, k = (torch.randn((b * h, t, ATT_D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    rows.append(_estimate_case(torch, sp, f"[{b}, {h}, {t}, {ATT_D}]", q, k, False))
    tq = EST_SHAPES[0][2]
    _estimate_case(torch, sp, f"[{b}, {h}, {tq} / {t}, {ATT_D}]", q[:, t - tq:].contiguous(), k,
                   True)
    del q, k
    return rows


def _topk_case(torch, name, b, d, dv, pages, seed, heads=TOPK_H, dtype=None, dev="cuda",
               kb=TOPK_KB):
    """Seeded q [B, heads, D], caches [pages, 128, D] / [.., Dv] in `dtype`
    (bf16 by default), kb distinct 8-token blocks a row; row 1 leaves its
    last 100 at -1, row 2 is all -1. Returns (q, k cache, v cache, block
    ids, token ids)."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn((b, heads, d), generator=gen, device=dev).to(dtype)
    kc = torch.randn((pages, TOPK_PS, d), generator=gen, device=dev).to(dtype)
    vc = torch.randn((pages, TOPK_PS, dv), generator=gen, device=dev).to(dtype)
    nblocks = pages * TOPK_PS // 8
    ids = torch.rand((b, nblocks), generator=gen, device=dev).argsort(dim=1)[:, :kb]
    ids = ids.to(torch.int32)
    ids[1, kb - 100:] = -1
    ids[2] = -1
    tok = torch.where(ids[..., None] >= 0, ids[..., None] * 8 + torch.arange(8, device=dev),
                      -1).reshape(b, kb * 8).to(torch.int32)
    return q, kc, vc, ids, tok


def check_topk(torch, sp):
    """K19 at bench_ops.py:436's shape (B 64, H 16, D = Dv = 128, 512 pages
    of 128, 256 blocks a row) and at DeepSeek-V2-Lite's latent rows (B 128,
    D 576, Dv 512, 4096 pages), against its plain version; row 2 has no
    block selected (the mean of block 0's V rows, as the TPU kernel).
    Returns the two rows."""
    rows = []
    for i, (name, b, d, dv, pages) in enumerate(TOPK_SHAPES):
        q, kc, vc, ids, tok = _topk_case(torch, name, b, d, dv, pages, 190 + i)
        sm = d ** -0.5
        out = sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS)
        ref = sp.topk_block_sparse_attention_ref(q, kc, vc, ids, sm, TOPK_PS)
        torch.cuda.synchronize()
        err, ratio = _bf16_check(f"topk_block_sparse {name}", out, ref, ATT_SHARE)
        mean0 = vc.reshape(-1, 8, dv)[0].float().mean(0)
        if not bool(((out[2].float() - mean0).abs() <= 2.0 ** -7 * mean0.abs() + 1e-3).all()):
            raise AssertionError("topk_block_sparse: the all -1 row is not block 0's mean")
        ms = _time_ms(lambda: sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS), 20,
                      graph=True)
        plain_ms = _time_ms(lambda: sp.topk_block_sparse_attention_ref(q, kc, vc, ids, sm,
                                                                       TOPK_PS), 3, 1)
        flat = tok.clamp_min(0).long().reshape(-1)
        kg = kc.reshape(-1, d).index_select(0, flat).reshape(b, 1, -1, d)
        vg = vc.reshape(-1, dv).index_select(0, flat).reshape(b, 1, -1, dv)
        live = (tok >= 0)[:, None, None, :]
        library, backend = _sdpa_yardstick(torch, q[:, None], kg, vg, live, sm)
        lib_err = (library()[:, 0].float() - ref.float())[[0, 1] + list(range(3, b))]
        lib = _time_ms(library, 20, graph=True)
        selected = float((ids >= 0).sum()) * 8
        # bytes: each distinct 8-row block read once (the rows overlap across
        # sequences; block 0 too, for the all -1 row), q, ids and the output
        distinct = torch.cat([ids[ids >= 0], ids.new_zeros(1)]).unique().numel()
        nbytes = (8.0 * distinct * 2.0 * (d + dv) + 2.0 * b * TOPK_H * (d + dv)
                  + 4.0 * ids.numel())
        # operations on the bf16 tensor cores K19 runs: q . k and p . v once
        # each; p . v takes p as three bf16 parts, so its floor counts it thrice
        bound, by = _bound_ms(nbytes, 2.0 * selected * TOPK_H * (d + dv), "bf16_flops")
        floor3 = _bound_ms(nbytes, 2.0 * selected * TOPK_H * (d + 3 * dv), "bf16_flops")[0]
        print(f"  topk_block_sparse ({name}) B={b} H={TOPK_H} D={d} Dv={dv} {pages} pages of "
              f"{TOPK_PS}, {TOPK_KB} blocks a row ({int(selected)} rows selected, {distinct} "
              f"distinct blocks, {nbytes / 1e6:.1f} MB to move): max-abs "
              f"{err:.3g} ({ratio:.3g} of its bound, max|plain| "
              f"{float(ref.float().abs().max()):.3g}), the all -1 row block 0's mean; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA ({backend}, over rows gathered by "
              f"index_select beforehand) {lib:.4f} ms (max-abs vs plain "
              f"{float(lib_err.abs().max()):.3g}); bound {bound:.4f} ms ({by}; with the "
              f"three-part P . V {floor3:.4f})")
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err))
        del q, kc, vc, ids, tok, kg, vg
    return rows


def check_topk_edges(torch, sp):
    """K19's splits at both phase-1 shapes with KB 251 (a prime: no split
    count divides it) and chunk 1 and 64, against the plain version: row 1
    leaves its last 100 ids at -1, row 2 is all -1, row 3 its second half
    (so its last split holds only -1 ids, which must vanish from the
    merge); a second call bit-identical (the merge is in split order)."""
    from sgl_kernel_npu_tpu_torch import _build
    kb = 251
    for i, (name, b, d, dv, pages) in enumerate(TOPK_SHAPES):
        q, kc, vc, ids, _ = _topk_case(torch, name, b, d, dv, pages, 290 + i)
        ids = ids[:, :kb].contiguous()
        ids[1, kb - 100:] = -1
        ids[3, kb // 2:] = -1
        sm = d ** -0.5
        splits = _build.splits("topk_block_sparse", b, TOPK_H, kb, d, dv, 0)   # bf16
        for chunk in (1, 64):
            out = sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS, chunk=chunk)
            again = sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS, chunk=chunk)
            ref = sp.topk_block_sparse_attention_ref(q, kc, vc, ids, sm, TOPK_PS, chunk)
            torch.cuda.synchronize()
            err, ratio = _bf16_check(f"topk_block_sparse ({name}) KB {kb} chunk {chunk}", out,
                                     ref, ATT_SHARE)
            if not torch.equal(out, again):
                raise AssertionError(f"topk_block_sparse ({name}): a second call differs")
            print(f"  topk_block_sparse ({name}) KB={kb} over {splits} splits, chunk {chunk}, a "
                  f"split of only -1 ids in row 3: max-abs {err:.3g} ({ratio:.3g} of its bound); "
                  f"a second call bit-identical")
        del q, kc, vc, ids
    # 8 heads (half of a block's 16 idle) and 40 (three blocks of heads a row)
    for heads in (8, 40):
        q, kc, vc, ids, _ = _topk_case(torch, "heads", 16, 128, 128, 64, 300 + heads, heads)
        out = sp.topk_block_sparse_attention(q, kc, vc, ids, 128 ** -0.5, TOPK_PS)
        ref = sp.topk_block_sparse_attention_ref(q, kc, vc, ids, 128 ** -0.5, TOPK_PS, 64)
        torch.cuda.synchronize()
        err, ratio = _bf16_check(f"topk_block_sparse H={heads}", out, ref, ATT_SHARE)
        print(f"  topk_block_sparse B=16 H={heads} D=Dv=128: max-abs {err:.3g} ({ratio:.3g} of its "
              f"bound)")


def check_decode_edges(torch, dv9, dv8, cfg):
    """Kernel C's splits at their edges, both contracts, against the plain
    versions: cached 0, 1, 15, 16, 17 (shorter than one split's share: the
    other splits are empty), 200, 700 and 1500 over a block table of 128
    pages (16,384 tokens, far wider than the longest sequence); a second
    call bit-identical."""
    from sgl_kernel_npu_tpu_torch import _build
    rng = torch.Generator(device="cuda")
    rng.manual_seed(500)
    b, hq, hkv, d, ps = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.page_size
    pages, mp, layers, li = 160, 128, 2, 0
    kc, vc, ks, vs = _tm_cache(torch, rng, layers, pages, ps, hkv, d)
    cached = torch.tensor([0, 1, 15, 16, 17, 200, 700, 1500], dtype=torch.int32, device="cuda")
    bt = _block_tables(torch, rng, (cached + 1).tolist(), mp, pages, ps)
    q = torch.randn((b, hq, d), generator=rng, device="cuda").to(torch.bfloat16)
    kn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    vn = torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
    args = (q, kn, vn, kc, vc, ks, vs, cached, bt, d ** -0.5, ps)
    splits = _build.splits("decode_tm", b, hkv, mp, ps)
    for name, mod, fn in (("decode_tm", dv9, "decode_gqa_v9_int8_defer"),
                          ("decode_v8 contract", dv8, "decode_gqa_v8_int8_defer")):
        out = getattr(mod, fn)(*args, layer_idx=li)
        again = getattr(mod, fn)(*args, layer_idx=li)
        ref = getattr(mod, fn + "_ref")(*args, layer_idx=li)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"{name} edges: max-abs {err} > {ATTN_TOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: a second call differs")
        print(f"  {name} B={b} MP={mp} over {splits} splits, cached {cached.tolist()}: max-abs "
              f"{err:.3g}; a second call bit-identical")
    # one query head a kv head (seven of mma's eight idle) and eight (all used)
    for g in (1, 8):
        q = torch.randn((b, hkv * g, d), generator=rng, device="cuda").to(torch.bfloat16)
        gargs = (q, *args[1:])
        out = dv9.decode_gqa_v9_int8_defer(*gargs, layer_idx=li)
        ref = dv9.decode_gqa_v9_int8_defer_ref(*gargs, layer_idx=li)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"decode_tm G={g}: max-abs {err} > {ATTN_TOL}")
        print(f"  decode_tm G={g} (Hq {hkv * g}), the same cache: max-abs {err:.3g}")


def _norm_inputs(torch, n, seed, dtype=None, d=NORM_D):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x, r = (torch.randn((n, d), generator=gen, device="cuda").to(dtype or torch.bfloat16)
            for _ in range(2))
    w = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    qs = 20.0 + 20.0 * torch.rand((d,), generator=gen, device="cuda")
    qo = torch.randn((d,), generator=gen, device="cuda")
    return x, r, w, b, qs, qo


def _norm_check(torch, name, got, want):
    """h exact; int8 within 1 on at most K20_FLIP_SHARE of the entries."""
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name}: h = x + residual differs")
    diff = (got[0].int() - want[0].int()).abs()
    share = float((diff > 0).double().mean())
    if int(diff.max()) > 1 or share > K20_FLIP_SHARE:
        raise AssertionError(f"{name}: int8 max diff {int(diff.max())}, share {share:.2e}")
    return int(diff.max()), share


def check_add_rmsnorm_quant(torch, nm, floor):
    """K20 at hidden 4096, bf16, N 8192 (a prefill) and 128 (a decode
    batch), against its plain version; then its f32 instantiation at N 128
    (no phase drives it; held and timed here only). `floor`: the card's
    launch floor in ms, printed beside the bounds. Returns the bf16 rows, in
    NORM_ROWS' order."""
    rows = []
    for n, dtype in [(n, torch.bfloat16) for n in NORM_ROWS] + [(128, torch.float32)]:
        x, r, w, b, qs, qo = _norm_inputs(torch, n, 200 + n, dtype)
        args = (x, r, w, b, 1e-6, qs, qo)
        got, want = nm.add_rmsnorm_bias(*args), nm.add_rmsnorm_bias_ref(*args)
        torch.cuda.synchronize()
        dmax, share = _norm_check(torch, f"add_rmsnorm_quant N={n} {dtype}", got, want)
        ms = _time_ms(lambda: nm.add_rmsnorm_bias(*args), 20, graph=True)
        plain_ms = _time_ms(lambda: nm.add_rmsnorm_bias_ref(*args), 5, 1)
        nbytes = (3.0 * x.element_size() + 1.0) * n * NORM_D + 16.0 * NORM_D
        bound, by = _bound_ms(nbytes, 8.0 * n * NORM_D, "f32_flops")
        print(f"  add_rmsnorm_quant N={n} d={NORM_D} {dtype}: h exact, int8 max diff {dmax} "
              f"({share:.2e} of entries); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, no "
              f"library call; bound {bound:.4f} ms ({by}), launch floor {floor:.4f} ms")
        if dtype == torch.bfloat16:
            rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                             bound_by=by, max_abs_err=float(dmax)))
    return rows


# K20's edge widths: one 8-column chunk, the widest (_MAX_D)
K20_EDGE_DS = (8, 8192)


def _k20_edge_ns(torch):
    """K20's edge rows: one, either side of a decode batch of 128, the SM
    count and one more (the last row count of the decode form, the first of
    the prefill form), a prefill."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (1, 127, 129, sms, sms + 1, 8192)


def check_add_rmsnorm_quant_edges(torch, nm):
    """K20 at _k20_edge_ns x K20_EDGE_DS, bf16 and f32, its outputs
    allocated on 0x7f bytes: h exact, int8 within K20_FLIP_SHARE, a second
    call bit-identical."""
    worst = 0.0
    ns = _k20_edge_ns(torch)
    for d in K20_EDGE_DS:
        for n in ns:
            for dtype in (torch.bfloat16, torch.float32):
                x, r, w, b, qs, qo = _norm_inputs(torch, n, 300 + n + d, dtype, d)
                args = (x, r, w, b, 1e-6, qs, qo)
                with _dirty_empty(torch, nm):
                    got = nm.add_rmsnorm_bias(*args)
                    again = nm.add_rmsnorm_bias(*args)
                want = nm.add_rmsnorm_bias_ref(*args)
                torch.cuda.synchronize()
                name = f"add_rmsnorm_quant N={n} d={d} {dtype}"
                worst = max(worst, _norm_check(torch, name, got, want)[1])
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{name}: a second call differs")
                del x, r, got, again, want
    print(f"  add_rmsnorm_quant edges (N {', '.join(map(str, ns))} by d "
          f"{', '.join(map(str, K20_EDGE_DS))}, bf16 and f32, 0x7f outputs): h exact, int8 "
          f"flips at most {worst:.2e} of entries, second calls bit-identical")


def _drive(torch, build, name, fn, expect, plain=True):
    """One call of a phase-11 entry point with exact launches (`expect`, 0
    for every other kernel), finite, and a second call bit-identical; then,
    with `plain`, the same call under SKT_IMPL=ref (no launch). Returns
    (out, plain out or None, ms per call by CUDA events)."""
    before = dict(build.launches)
    out = fn()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
    if delta != expect:
        raise AssertionError(f"{name}: launches {delta}, not {expect}")
    outs = out if isinstance(out, tuple) else (out,)
    if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
        raise AssertionError(f"{name}: output not finite")
    again = fn()
    again = again if isinstance(again, tuple) else (again,)
    torch.cuda.synchronize()
    if not all(torch.equal(a, o) for a, o in zip(again, outs)):
        raise AssertionError(f"{name}: a second call differs")
    ref = None
    if plain:
        mid = dict(build.launches)
        with _env(SKT_IMPL="ref"):
            ref = fn()
        torch.cuda.synchronize()
        if dict(build.launches) != mid:
            raise AssertionError(f"{name}: the SKT_IMPL=ref call launched a kernel")
    return out, ref, _time_ms(fn, 3, warmup=1)


def _pages_of(torch, x, bt):
    """[1, Hkv, T, D] rows as hm pages [P, Hkv, 128, D] behind block table
    bt (logical -> physical; page 0 left empty)."""
    _, hkv, t, d = x.shape
    npages = t // 128
    pages = torch.zeros((npages + 1, hkv, 128, d), dtype=x.dtype, device=x.device)
    pages[bt.long()] = x[0].reshape(hkv, npages, 128, d).transpose(0, 1)
    return pages


def run_attentions(torch, build, pf, sp, pp, nm, gpu):
    """Phase 11: the `attentions` surface through its public functions at
    full width, each call with exact launches, finite, repeated
    bit-identically and held to the same call under SKT_IMPL=ref. Returns
    the launches of each case, by its row in the kernels line (the counters
    set to 0 first)."""
    build.reset_launches()
    counts = {}

    def count(row, kernel, before):
        counts[row] = counts.get(row, 0) + build.launches[kernel] - before

    sm = ATT_D ** -0.5
    dense = {}
    print("  (a) laser_attention, Llama-3-8B heads (32 / 8, D 128, bf16), B 1")
    for i, (t, causal) in enumerate(LASER_CASES):
        q, k, v = _laser_inputs(torch, t, 1170 + i)
        name = f"laser_attention T={t} causal={causal}"
        n0 = build.launches["laser_attention"]
        out, plain, ms = _drive(torch, build, name, lambda: pf.laser_attention(
            q, k, v, sm, causal), {"laser_attention": 1})
        count(LASER_NAMES[i], "laser_attention", n0)
        err, _ = _bf16_check(name, out, plain, ATT_SHARE)
        print(f"    T={t} causal={causal}: {ms:.3f} ms per call, max-abs vs plain {err:.3g}, "
              "launches laser_attention 1")
        if i == 0:
            dense = dict(q=q, k=k, v=v, out=out, ms=ms)
        del out, plain
    print("  (b) sparse prefill, T 8192 at prefix 0, bf16 hm pages of 128, per kv head")
    q, k, v, t = dense["q"], dense["k"], dense["v"], LASER_CASES[0][0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1180)
    q8 = torch.randn((1, ATT_HKV, t, ATT_D), generator=gen, device="cuda").to(torch.bfloat16)
    npages = t // 128
    bt = (torch.randperm(npages, generator=gen, device="cuda") + 1).to(torch.int32)
    kv = (_pages_of(torch, k, bt), _pages_of(torch, v, bt))
    qt = q[0].transpose(0, 1).contiguous()                       # [T, 32, 128]

    def pipeline(keep):
        mask, pairs = sp.sparse_block_estimate_dispatch(q8, k, 128, keep_ratio=keep)
        out = pp.block_sparse_paged_attention(qt, kv, bt, mask[0], 0, sm, 128)
        return out, mask, pairs

    res = {}
    for keep in (0.25, 1.0):
        name = f"sparse prefill keep={keep}"
        n0 = build.launches["sparse_estimate"]
        # no plain run at keep 1.0: the plain K15 loop takes ~2,000 page steps
        k0 = build.launches["prefill_hm"]
        (out, mask, pairs), plain, ms = _drive(
            torch, build, name, lambda: pipeline(keep), {"sparse_estimate": 2, "prefill_hm": 1},
            plain=keep < 1.0)
        count("sparse_estimate", "sparse_estimate", n0)
        if keep < 1.0:
            count("prefill_hm (sparse T 8192 keep 0.25)", "prefill_hm", k0)
        plain_note = "the plain version not run"
        if plain is not None:
            ref_out = plain[0]
            if not torch.equal(mask, plain[1]):
                ref_scores = sp.block_scores_ref(q8[0], k[0], 128).reshape(mask.shape)
                _mask_flips(name, ref_scores, mask, plain[1], npages // 4)
                with _env(SKT_IMPL="ref"):                # the plain K15 on the kernel's mask
                    ref_out = pp.block_sparse_paged_attention(qt, kv, bt, mask[0], 0, sm, 128)
            err, _ = _bf16_check(name, out, ref_out, ATT_SHARE)
            plain_note = f"max-abs vs plain {err:.3g}"
        res[keep] = dict(out=out, mask=mask, ms=ms)
        print(f"    keep={keep}: {ms:.3f} ms per call (estimator + K15), "
              f"{int(pairs.sum())} of {int(mask.shape[1]) * npages * (npages + 1) // 2} "
              f"causal (q tile, page) pairs over the kv heads, {plain_note}; launches "
              "sparse_estimate 2 (pooling, scores), prefill_hm 1")
    sparse_row = _sparse_prefill_row(torch, pp, qt, kv, bt, res[0.25]["mask"][0], sm, gpu)
    full = res[1.0]
    causal_mask = torch.ones((npages, npages), dtype=torch.bool, device="cuda").tril()
    if not torch.equal(full["mask"], causal_mask.expand_as(full["mask"])):
        raise AssertionError("sparse prefill: the keep-1.0 mask is not full causal")
    dense_out = dense["out"][0].transpose(0, 1)
    err, _ = _bf16_check("sparse prefill keep=1.0 vs laser", full["out"], dense_out,
                         2 * ATT_SHARE)
    print(f"    keep=1.0 mask full causal; its output (K15) vs laser_attention's (K17) max-abs "
          f"{err:.3g}; sparse prefill at keep 0.25 {res[0.25]['ms']:.3f} ms against dense "
          f"laser {dense['ms']:.3f} ms ({res[0.25]['ms'] / dense['ms']:.2f}x) and dense K15 "
          f"{full['ms']:.3f} ms [{gpu}]")
    del dense, res, full, kv, q8, qt, q, k, v
    torch.cuda.empty_cache()
    print("  (c) topk_block_sparse_attention")
    for i, (name, b, d, dv, pages) in enumerate(TOPK_SHAPES):
        q, kc, vc, ids, tok = _topk_case(torch, name, b, d, dv, pages, 1190 + i)
        sm_t = d ** -0.5
        n0 = build.launches["topk_block_sparse"]
        out, plain, ms = _drive(torch, build, f"topk {name}", lambda: sp.topk_block_sparse_attention(
            q, kc, vc, ids, sm_t, TOPK_PS), {"topk_block_sparse": 1})
        count(TOPK_NAMES[i], "topk_block_sparse", n0)
        err, _ = _bf16_check(f"topk {name}", out, plain, ATT_SHARE)
        token = sp.topk_sparse_attention(q, kc, vc, tok, None, sm_t, TOPK_PS)
        keep_rows = [r for r in range(b) if r != 2]              # row 2 selects nothing
        terr, _ = _bf16_check(f"topk {name} vs token-granular", out[keep_rows],
                              token[keep_rows], ATT_SHARE)
        print(f"    {name} B={b} D={d} Dv={dv}: {ms:.3f} ms per call, max-abs vs plain "
              f"{err:.3g}, vs topk_sparse_attention over the same tokens {terr:.3g}; launches "
              "topk_block_sparse 1")
        del q, kc, vc, ids, tok, out, plain, token
    print("  (d) add_rmsnorm_bias with static int8 quant, hidden 4096, bf16")
    for i, n in enumerate(NORM_ROWS):
        args = _norm_inputs(torch, n, 1200 + n)
        n0 = build.launches["add_rmsnorm_quant"]
        got, plain, ms = _drive(torch, build, f"add_rmsnorm_bias N={n}", lambda: nm.add_rmsnorm_bias(
            *args[:4], 1e-6, *args[4:]), {"add_rmsnorm_quant": 1})
        count(NORM_NAMES[i], "add_rmsnorm_quant", n0)
        dmax, share = _norm_check(torch, f"add_rmsnorm_bias N={n}", got, plain)
        print(f"    N={n}: {ms:.4f} ms per call, h exact, int8 max diff {dmax} ({share:.2e} of "
              "entries) vs plain; launches add_rmsnorm_quant 1")
    return counts, sparse_row


def _sparse_prefill_row(torch, pp, qt, kv, bt, mask, sm, gpu):
    """The kernels-line row of K15 in the keep-0.25 sparse prefill: K15
    alone on the page lists of the estimator's mask [Hkv, NQ, NK], made
    outside the timed call (CUDA graph replay), its plain version once, SDPA
    with the same mask spread to tokens (memory-efficient backend; it
    computes every masked score), and
    the bound from the selected (tile, page) pairs: each distinct (kv head,
    page) read once, 4 * 128 operations per visible (query row, key)."""
    t, hq, d = qt.shape
    hkv, npages = mask.shape[0], mask.shape[1]
    g, ps = hq // hkv, t // npages

    zero = torch.zeros((), dtype=torch.int32, device="cuda")     # no copy in a graph
    sel, cnt = pp.block_mask_to_page_lists(mask, npages)

    def call():
        return pp.paged_prefill_attention(qt, kv, bt, zero, sm, ps, page_sel=sel, page_cnt=cnt,
                                          block_q=ps)
    out = call()
    ms = _time_ms(call, 3, graph=True)
    with _env(SKT_IMPL="ref"):
        plain_ms = _time_ms(call, 1, warmup=0)
        ref = call()
    err, _ = _bf16_check("sparse prefill keep=0.25 K15 alone", out, ref, ATT_SHARE)
    causal = torch.ones((ps, ps), dtype=torch.bool, device="cuda").tril()
    tok_mask = (mask[:, :, None, :, None] & torch.ones((1, 1, ps, 1, ps), dtype=torch.bool,
                                                       device="cuda"))
    diag = torch.eye(npages, dtype=torch.bool, device="cuda")[None, :, None, :, None]
    tok_mask = tok_mask & (~diag | causal[None, None, :, None, :])
    tok_mask = tok_mask.reshape(hkv, t, 1, t).expand(hkv, t, g, t).reshape(1, hkv, t * g, t)
    qq = qt.reshape(t, hkv, g, d).permute(1, 0, 2, 3).reshape(1, hkv, t * g, d).contiguous()
    rows_k = kv[0][bt.long()].permute(1, 0, 2, 3).reshape(1, hkv, t, d).contiguous()
    rows_v = kv[1][bt.long()].permute(1, 0, 2, 3).reshape(1, hkv, t, d).contiguous()
    library, backend = _sdpa_yardstick(torch, qq, rows_k, rows_v, tok_mask, sm)
    lib = _time_ms(library, 2, graph=True)
    del tok_mask, rows_k, rows_v, qq
    tri = torch.ones((npages, npages), dtype=torch.bool, device="cuda").tril(-1)
    pairs = (float((mask & tri).sum()) * ps * ps
             + float((mask & torch.eye(npages, dtype=torch.bool, device="cuda")).sum())
             * ps * (ps + 1) / 2)
    nbytes = (float(mask.any(1).sum()) * ps * d * 2 * 2 + 2 * 2 * t * hq * d
              + 4 * mask.numel())
    bound, by = _bound_ms(nbytes, 4.0 * pairs * g * d, "bf16_flops")
    print(f"    keep=0.25 K15 alone: {ms:.4f} ms per call, plain {plain_ms:.3f} ms, SDPA "
          f"({backend}, the mask spread to tokens) {lib:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"max-abs vs plain {err:.3g} [{gpu}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=err)


# --------------------------------------------- the soft-FP8 surface (phase 12)

# DeepSeek-V3's linear weights in its checkpoint's fp8 format
# (quantization_config: e4m3, weight_block_size [128, 128]) as [K, N]: the
# dense MLP's gate_proj and down_proj, and kv_a_proj_with_mqa (N 576, not a
# multiple of 128)
FP8_DENSE = (("gate_proj", 7168, 18432), ("down_proj", 18432, 7168),
             ("kv_a_proj_with_mqa", 7168, 576))
FP8_M, FP8_M_LARGE = 128, 4096
# the grouped GEMMs at phase 8's per-chip expert share (bench.py:378-408)
FP8_GROUPED = (("GMM1", MOE_H, 2 * MOE_F), ("GMM2", MOE_F, MOE_H))
HELLO_SHAPE = (4096, 7168)
# K21 against its plain version, and phase 12 against SKT_IMPL=ref: the bar
# tests/test_torch_fp8.py holds the port to the JAX package with (calc_diff,
# and the share of max|plain| beyond one bf16 ulp of the larger value): the
# sums are the same f32 products in another order
FP8_DIFF, FP8_SHARE = 1e-5, 1e-4


def _gemm_check(name, out, ref):
    """calc_diff(out, ref) <= FP8_DIFF and every value within one bf16 ulp
    of the larger of the two (2^-7 of its magnitude) plus FP8_SHARE *
    max|ref|. Returns max-abs and the largest error over its bound."""
    a, b = out.double(), ref.double()
    diff = _calc_diff(a, b)
    err = (a - b).abs()
    ratio = float((err / (2.0 ** -7 * a.abs().maximum(b.abs())
                          + FP8_SHARE * b.abs().max())).max())
    if not (diff <= FP8_DIFF and ratio <= 1.0):
        raise AssertionError(f"{name}: calc_diff {diff:.3g}, max-abs {float(err.max()):.3g} "
                             f"({ratio:.3g} x its bound)")
    return float(err.max()), ratio


def _fp8_bank(torch, qt, seed, shape):
    """Seeded bf16 weights [..., K, N] (0.05 randn on the card) quantised to
    fp8 e4m3 with an f32 scale per 128 x 128 block: quant.per_block_quant_fp8
    over each block's 16,384 values (K and N zero-padded to multiples of
    128). Returns (w [..., K, N] e4m3, scales [..., K/128, N/128] f32)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    *lead, k, n = shape
    w = (0.05 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
    sk, sn = -(-k // 128), -(-n // 128)
    w = torch.nn.functional.pad(w, (0, sn * 128 - n, 0, sk * 128 - k))
    blocks = w.reshape(*lead, sk, 128, sn, 128).transpose(-3, -2).reshape(*lead, sk, sn, 16384)
    del w
    q, s = qt.per_block_quant_fp8(blocks, block=16384)
    q = (q.view(torch.uint8).reshape(*lead, sk, sn, 128, 128).transpose(-3, -2)
         .reshape(*lead, sk * 128, sn * 128)[..., :k, :n].contiguous())
    return q.view(torch.float8_e4m3fn), s[..., 0].contiguous()


def _bf16_rows(torch, seed, shape, scale=1.0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)


def _fp8_moe_rows(torch, data):
    """phase 8's seed-0 routing as gmm_wfp8a16 takes it: the 1,024 routed
    rows of x ordered by expert (a stable sort of topk_idx) and the group
    sizes."""
    x, idx = data[0], data[1]
    order = torch.sort(idx.reshape(-1).long(), stable=True)
    sizes = torch.bincount(order.values, minlength=MOE_EL).to(torch.int32)
    return x[order.indices // MOE_K], sizes


def _gemm_bound(m, k, n, experts=1):
    """Bytes (x, the fp8 weights of each expert read, its scales, out) and
    operations of an fp8 W8A16 GEMM of m rows."""
    sk, sn = -(-k // 128), -(-n // 128)
    nbytes = 2.0 * m * k + experts * (float(k) * n + 4.0 * sk * sn) + 2.0 * m * n
    return _bound_ms(nbytes, 2.0 * m * k * n, "bf16_flops")


K21_EDGE_NOTES = ("M 8, 128 and 4096 at K 256, N 384 on TMA loads, M 600 and 200 (partial "
                  "256- and 128-row tiles)", "an e4m3 NaN code (its column NaN, as in the plain "
                  "version)", "m_live below M on the grouped form (zeros from m_live on, no "
                  "weights read)")


def check_wfp8a16_edges(torch, mm, qt):
    """K21 at its edges against its plain version, each case on its own
    seed: the three row tiles (M 8, 128, 4096) and partial ones (M 600, 200)
    on TMA loads; an e4m3 NaN code, which must give NaN exactly where the
    plain version does; and the grouped form with m_live below M (rows from
    m_live on zeros), on TMA loads and on the second load path (N 136)."""
    for i, m in enumerate((8, 128, 4096, 600, 200)):
        w, s = _fp8_bank(torch, qt, 360 + i, (256, 384))
        x = _bf16_rows(torch, 370 + i, (m, 256))
        _gemm_check(f"wfp8a16_gemm M={m} K=256 N=384", mm.mm_wfp8a16(x, w, s),
                    mm.mm_wfp8a16_ref(x, w, s))
    w, s = _fp8_bank(torch, qt, 380, (384, 256))
    w = w.view(torch.uint8).clone()
    w[130, 77] = 0x7F                                           # e4m3 NaN
    w = w.view(torch.float8_e4m3fn)
    x = _bf16_rows(torch, 381, (128, 384))
    out, ref = mm.mm_wfp8a16(x, w, s), mm.mm_wfp8a16_ref(x, w, s)
    nan = torch.isnan(ref)
    if not (torch.equal(torch.isnan(out), nan) and bool(nan[:, 77].all())
            and int(nan.sum()) == 128):
        raise AssertionError("wfp8a16_gemm: an e4m3 NaN code does not give its column NaN")
    _gemm_check("wfp8a16_gemm NaN code, the other columns", out[:, ~nan[0]], ref[:, ~nan[0]])
    for i, (n, block_m) in enumerate(((384, 128), (136, 64))):
        w, s = _fp8_bank(torch, qt, 390 + i, (3, 256, n))
        x = _bf16_rows(torch, 395 + i, (512, 256))
        eid = torch.tensor([2, 0, 1, 1, 0, 2, 1, 0][: 512 // block_m], dtype=torch.int32,
                           device="cuda")
        live = torch.tensor([256], dtype=torch.int32, device="cuda")
        got = mm._wfp8a16_gemm(x, w, s, eid, block_m, 128, m_live=live)
        want = mm.gmm_wfp8a16_aligned_ref(x, w, s, eid, block_m=block_m)
        _gemm_check(f"wfp8a16_gemm_grouped N={n} block_m={block_m} m_live 256", got[:256],
                    want[:256])
        if float(got[256:].float().abs().max()) != 0.0:
            raise AssertionError("wfp8a16_gemm_grouped: rows from m_live on are not zero")


def check_wfp8a16(torch, mm, qt, data):
    """K21 at phase 12's shapes against its plain version: the dense GEMM at
    M 128 on gate_proj, down_proj and kv_a_proj_with_mqa and at M 4096 on
    gate_proj; the grouped GEMM (GMM1, GMM2) on the 1,024 routed rows of
    phase 8's seed-0 routing, one 128-row tile per expert. Returns the rows
    (the M 128 sum, M 4096, the grouped sum)."""
    dense = []
    big = None
    for i, (name, k, n) in enumerate(FP8_DENSE):
        w, s = _fp8_bank(torch, qt, 300 + i, (k, n))
        w16 = mm._dequant_w_fp8_block(w, s)
        for m in (FP8_M, FP8_M_LARGE) if name == "gate_proj" else (FP8_M,):
            x = _bf16_rows(torch, 310 + i, (m, k))
            out, ref = mm.mm_wfp8a16(x, w, s), mm.mm_wfp8a16_ref(x, w, s)
            torch.cuda.synchronize()
            err, ratio = _gemm_check(f"wfp8a16_gemm {name} M={m}", out, ref)
            ms = _time_ms(lambda: mm.mm_wfp8a16(x, w, s), 10 if m > FP8_M else 30, graph=True)
            plain_ms = _time_ms(lambda: mm.mm_wfp8a16_ref(x, w, s), 2, 1)

            def library():
                return torch.matmul(x, w16)
            lib_err = (library().float() - ref.float()).abs().max().item()
            lib = _time_ms(library, 10 if m > FP8_M else 30, graph=True)
            bound, by = _gemm_bound(m, k, n)
            print(f"  wfp8a16_gemm {name} M={m} K={k} N={n}: max-abs {err:.3g} ({ratio:.3g} of "
                  f"its bound); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, torch.matmul on "
                  f"the bf16 weight {lib:.4f} ms (max-abs vs plain {lib_err:.3g}), bound "
                  f"{bound:.4f} ms ({by})")
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                       max_abs_err=err)
            if m == FP8_M:
                dense.append(row)
            else:
                big = row
            del x, out, ref
        del w, s, w16
        torch.cuda.empty_cache()
    for m, k, n in ((8, 7168, 576), (40, 200, 136), (3, 256, 576)):
        # 32-row tiles, a split K, a ragged K and N
        w, s = _fp8_bank(torch, qt, 350, (k, n))
        x = _bf16_rows(torch, 351, (m, k))
        _gemm_check(f"wfp8a16_gemm M={m} K={k} N={n}", mm.mm_wfp8a16(x, w, s),
                    mm.mm_wfp8a16_ref(x, w, s))
    w, s = _fp8_bank(torch, qt, 352, (4, 200, 136))
    x = _bf16_rows(torch, 353, (40, 200))
    gl = torch.tensor([10, 0, 20, 5], dtype=torch.int32, device="cuda")
    got = mm.gmm_wfp8a16(x, w, s, gl, block_m=32)
    want = mm.gmm_wfp8a16_ref(x, w, s, gl)
    _gemm_check("gmm_wfp8a16 S=40 block_m=32", got, want)
    check_wfp8a16_edges(torch, mm, qt)
    print("  wfp8a16_gemm within its bar also at M 8 (a split K), a ragged K 200 and N 136, "
          "and grouped over 32-row tiles with rows past the groups (zeros); "
          + ", ".join(K21_EDGE_NOTES))
    rows_x, sizes = _fp8_moe_rows(torch, data)
    m = rows_x.shape[0]
    eid = torch.arange(MOE_EL, dtype=torch.int32, device="cuda").repeat_interleave(
        sizes.long() // 128)
    if not bool((sizes == 128).all()):
        raise AssertionError(f"phase 8's routing no longer gives 128 rows an expert: {sizes}")
    grouped = []
    for i, (name, k, n) in enumerate(FP8_GROUPED):
        w, s = _fp8_bank(torch, qt, 320 + i, (MOE_EL, k, n))
        x = rows_x if name == "GMM1" else _bf16_rows(torch, 330, (m, k))
        args = (x, w, s, eid)
        out, ref = mm.gmm_wfp8a16_aligned(*args), mm.gmm_wfp8a16_aligned_ref(*args)
        torch.cuda.synchronize()
        err, ratio = _gemm_check(f"wfp8a16_gemm_grouped {name}", out, ref)
        ms = _time_ms(lambda: mm.gmm_wfp8a16_aligned(*args), 20, graph=True)
        plain_ms = _time_ms(lambda: mm.gmm_wfp8a16_aligned_ref(*args), 2, 1)
        w16 = torch.stack([mm._dequant_w_fp8_block(w[e], s[e]) for e in range(MOE_EL)])

        def library():
            return torch.cat([torch.matmul(x[e * 128:(e + 1) * 128], w16[e])
                              for e in range(MOE_EL)])
        lib_err = (library().float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 20, graph=True)
        bound, by = _gemm_bound(m, k, n, MOE_EL)
        print(f"  wfp8a16_gemm_grouped {name} M={m} (8 experts x 128 rows) K={k} N={n}: max-abs "
              f"{err:.3g} ({ratio:.3g} of its bound); kernel {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, torch.matmul per expert group {lib:.4f} ms (max-abs vs plain "
              f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
        grouped.append(dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                            bound_by=by, max_abs_err=err))
        del w, s, w16, out, ref
        torch.cuda.empty_cache()
    return _sum_rows(dense), big, _sum_rows(grouped)


def check_helloworld(torch, hw):
    """K22 on bf16 [4096, 7168] and on n = 1, 8, 1,001 and 8,003 values (a
    vector's worth, and tails past the 8-value vectors), exactly equal to
    its plain version (x + y); timed beside torch.add, its ratio printed."""
    for shape in (HELLO_SHAPE, (1,), (8,), (7, 143), (8003,)):
        x, y = _bf16_rows(torch, 340, shape), _bf16_rows(torch, 341, shape)
        out, ref = hw.helloworld(x, y), hw.helloworld_ref(x, y)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"helloworld {shape}: {(out != ref).sum().item()} values "
                                 "differ")
    x, y = _bf16_rows(torch, 340, HELLO_SHAPE), _bf16_rows(torch, 341, HELLO_SHAPE)
    ms = _time_ms(lambda: hw.helloworld(x, y), 50, graph=True)
    plain_ms = _time_ms(lambda: hw.helloworld_ref(x, y), 20)
    lib = _time_ms(lambda: torch.add(x, y), 50, graph=True)
    bound, by = _bound_ms(6.0 * x.numel(), float(x.numel()), "bf16_flops")
    print(f"  helloworld {HELLO_SHAPE} bf16: exact (and at n = 1, 8, 1,001, 8,003); kernel "
          f"{ms:.4f} ms, plain (x + y) {plain_ms:.4f} ms, torch.add {lib:.4f} ms (kernel / "
          f"torch.add {ms / lib:.3f}), bound {bound:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
                max_abs_err=0.0)


def run_fp8_surface(torch, build, mm, qt, hw, data, gpu):
    """Phase 12: the soft-FP8 surface through its public functions at
    DeepSeek-V3's widths, the counters set to 0 first: mm_wfp8a16 at M 128
    on the three projections and at M 4096 on gate_proj; gmm_wfp8a16 on the
    1,024 routed rows of phase 8's routing (GMM1, GMM2), with every row on
    one expert and with sum(group_list) < S (rows past it zero); helloworld
    on [4096, 7168]. Every call: exact launches, finite, a second call
    bit-identical, within the GEMM bar of the same call under SKT_IMPL=ref
    (helloworld equal). Returns the launches by kernels-line row."""
    build.reset_launches()
    counts = {}

    def count(row, kernel, before):
        counts[row] = counts.get(row, 0) + build.launches[kernel] - before

    one = {"wfp8a16_gemm": 1}
    for i, (name, k, n) in enumerate(FP8_DENSE):
        w, s = _fp8_bank(torch, qt, 300 + i, (k, n))
        for m in (FP8_M, FP8_M_LARGE) if name == "gate_proj" else (FP8_M,):
            x = _bf16_rows(torch, 310 + i, (m, k))
            n0 = build.launches["wfp8a16_gemm"]
            out, ref, ms = _drive(torch, build, f"mm_wfp8a16 {name} M={m}",
                                  lambda: mm.mm_wfp8a16(x, w, s), one)
            count("wfp8a16_gemm" if m == FP8_M else "wfp8a16_gemm (M 4096)", "wfp8a16_gemm", n0)
            err, _ = _gemm_check(f"mm_wfp8a16 {name} M={m}", out, ref)
            bound = _gemm_bound(m, k, n)[0]
            print(f"  mm_wfp8a16 {name} M={m} K={k} N={n}: {ms:.4f} ms per call (bound "
                  f"{bound:.4f}), max-abs vs SKT_IMPL=ref {err:.3g}; launches wfp8a16_gemm 1")
            del x, out, ref
        del w, s
        torch.cuda.empty_cache()
    rows_x, sizes = _fp8_moe_rows(torch, data)
    m = rows_x.shape[0]
    cases = (("phase 8 routing", sizes),
             ("every row on expert 2", torch.zeros_like(sizes).index_fill_(0, torch.tensor(
                 [2], device="cuda"), m)),
             ("sum 1,000 < 1,024", sizes - torch.tensor([0, 3, 0, 5, 0, 7, 0, 9],
                                                         dtype=torch.int32, device="cuda")))
    grouped = {"wfp8a16_gemm_grouped": 1}
    for i, (name, k, n) in enumerate(FP8_GROUPED):
        w, s = _fp8_bank(torch, qt, 320 + i, (MOE_EL, k, n))
        x = rows_x if name == "GMM1" else _bf16_rows(torch, 330, (m, k))
        for label, gl in cases if name == "GMM1" else cases[:1]:
            n0 = build.launches["wfp8a16_gemm_grouped"]
            out, ref, ms = _drive(torch, build, f"gmm_wfp8a16 {name} ({label})",
                                  lambda: mm.gmm_wfp8a16(x, w, s, gl), grouped)
            count("wfp8a16_gemm_grouped", "wfp8a16_gemm_grouped", n0)
            err, _ = _gemm_check(f"gmm_wfp8a16 {name} ({label})", out, ref)
            total = int(gl.sum())
            if out[total:].float().abs().any():
                raise AssertionError(f"gmm_wfp8a16 {name} ({label}): rows past the groups "
                                     "are not zero")
            bound = _gemm_bound(total, k, n, int((gl > 0).sum()))[0]
            print(f"  gmm_wfp8a16 {name} M={m} ({label}) K={k} N={n}: {ms:.4f} ms per call "
                  f"(compaction + K21; K21's bound {bound:.4f}), max-abs vs SKT_IMPL=ref "
                  f"{err:.3g}; launches wfp8a16_gemm_grouped 1")
            del out, ref
        del w, s
        torch.cuda.empty_cache()
    x, y = _bf16_rows(torch, 340, HELLO_SHAPE), _bf16_rows(torch, 341, HELLO_SHAPE)
    n0 = build.launches["helloworld"]
    out, ref, ms = _drive(torch, build, "helloworld", lambda: hw.helloworld(x, y),
                          {"helloworld": 1})
    count("helloworld", "helloworld", n0)
    if not torch.equal(out, ref):
        raise AssertionError("helloworld differs from its SKT_IMPL=ref call")
    print(f"  helloworld {HELLO_SHAPE}: {ms:.4f} ms per call, equal to SKT_IMPL=ref; launches "
          f"helloworld 1 [{gpu}]")
    return counts


# ------------------------------------------------------ the attic (phase 13)

# the attic's measured configuration (attic/ops_attention/README.md):
# Llama-3-8B's heads, int8 KV, batch 64, about 320 cached tokens; pages of
# 128 and 4 a sequence (to 512 tokens: the v7 loop grows each by 70)
ATT7_B, ATT7_MP, ATT7_LAYERS, ATT7_LI, ATT7_STEPS = 64, 4, 32, 5, 70
# K23 takes f32 products and an unrounded p (K16's bar); K24 rounds p to
# bf16 (K14's)
# the kernels line's rows of K23's contracts and K24, and their TPU kernels
ATTIC_TPU = {"decode_v5_int8_defer": "decode_v5.py:134", "decode_v5_defer": "decode_v5.py:225",
             "decode_v4b_int8": "decode_v4.py:536", "decode_fused_v4_int8": "decode_v4.py:188",
             "decode_fused_v4": "decode_v4.py:377", "decode_v7_int8": "decode_v7.py:208"}


def _attic_state(torch, cfg, seed):
    """The attic phases' decode state at Llama-3-8B's heads: 64 sequences of
    256..383 cached tokens, 4 distinct 128-token pages each, q of 1.5 randn,
    the current token's k / v."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, mp, ps = ATT7_B, ATT7_MP, cfg.page_size
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cached = torch.randint(256, 384, (b,), generator=gen, device="cuda", dtype=torch.int32)
    bt = (torch.randperm(b * mp, generator=gen, device="cuda").reshape(b, mp) + 1).to(
        torch.int32)
    q = (1.5 * torch.randn((b, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    kn, vn = (torch.randn((b, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    return dict(gen=gen, b=b, mp=mp, ps=ps, hq=hq, hkv=hkv, d=d, pages=b * mp + 1,
                cached=cached, bt=bt, q=q, kn=kn, vn=vn, sm=d ** -0.5)


def _stacked(torch, st, int8):
    """Seeded stacked caches [32, P, Hkv, 128, 128]: int8 rows with f32
    scales [32, P, Hkv, 1, 128] of 0.005..0.025, or bf16 randn rows."""
    gen = st["gen"]
    shape = (ATT7_LAYERS, st["pages"], st["hkv"], st["ps"], st["d"])
    if not int8:
        return [torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2)]
    sshape = shape[:3] + (1, st["ps"])
    return ([torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device="cuda")
             for _ in range(2)]
            + [torch.rand(sshape, generator=gen, device="cuda") * 0.02 + 0.005
               for _ in range(2)])


def _slots_of(torch, bt, pos, ps):
    b = bt.shape[0]
    return (bt[torch.arange(b, device=bt.device), (pos // ps).long()] * ps + pos % ps).to(
        torch.int32)


def _v7_state(torch, st):
    """The v7 pages and sidecar of the state: int8 rows and scales in every
    page, seeded bf16 sidecar rows (65 rows in a shuffled order)."""
    gen = st["gen"]
    k, v, ks, vs = _hm_pages(torch, gen, st["pages"], st["hkv"], st["ps"], st["d"], True)
    side = [torch.randn((st["b"] + 1, 64, st["hkv"] * st["d"]), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2)]
    rows = torch.randperm(st["b"] + 1, generator=gen, device="cuda")[: st["b"]].to(torch.int32)
    return dict(k=k, v=v, ks=ks, vs=vs, kside=side[0], vside=side[1], rows=rows)


def _v7_rows(torch, st, s7):
    """The v7 state's tokens as bf16 rows [B, Hkv, MP*ps, D] (the pages
    dequantised up to the last flush, the sidecar after it) for the SDPA
    yardstick, and the live mask."""
    b, hkv, d, w = st["b"], st["hkv"], st["d"], 64
    cached = st["cached"].long()
    flushed = cached // w * w
    rows = []
    for cache, sc, side in ((s7["k"], s7["ks"], s7["kside"]), (s7["v"], s7["vs"], s7["vside"])):
        r = _hm_rows(torch, cache, sc, st["bt"])
        tail = side[s7["rows"].long()].reshape(b, w, hkv, d).transpose(1, 2)
        t = torch.arange(w, device="cuda")
        bi, ti = (t[None, :] < (cached - flushed)[:, None]).nonzero(as_tuple=True)
        r[bi, :, flushed[bi] + ti] = tail[bi, :, ti]
        rows.append(r)
    live = torch.arange(st["mp"] * st["ps"], device="cuda")[None, :] < cached[:, None]
    return rows[0], rows[1], live


def check_attic(torch, dv4, dv5, dv7, cfg):
    """K23's five contracts and K24 at phase 13's shapes (Llama-3-8B heads,
    64 sequences of 256..383 cached tokens, 128-token pages; the stacked
    caches 32 layers, layer 5, the layer an int), against their plain
    versions; the fused contracts' writes bit-equal to the plain versions'.
    Returns the rows by kernel name."""
    from sgl_kernel_npu_tpu_torch.ops.attention.decode_v8 import quant_rows_int8
    st = _attic_state(torch, cfg, 350)
    b, hq, hkv, d, mp, ps, sm = (st[k] for k in ("b", "hq", "hkv", "d", "mp", "ps", "sm"))
    q, kn, vn, cached, bt = st["q"], st["kn"], st["vn"], st["cached"], st["bt"]
    rows = {}

    def finish(name, fn, plain, share, rows_k, rows_v, live, new, lens, int8, extra_bytes=0.0,
               extra_tok=0.0, write=None):
        out, ref = fn(), plain()
        again = fn()
        torch.cuda.synchronize()
        if write is not None:
            write()
        err, ratio = _bf16_check(name, out, ref, share)
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: a second call differs")
        ms = _time_ms(fn, 50, graph=True)
        plain_ms = _time_ms(plain, 3)
        library, backend, lib_out = _hm_yardstick(torch, q, rows_k, rows_v, live, new, sm)
        lib_err = (lib_out().float() - ref.float()).abs().max().item()
        lib = _time_ms(library, 20, graph=True)
        nbytes, tok = _hm_decode_bytes(lens, b, hkv, hq, d, mp, int8, new is not None)
        # K24: q . k and p . v a (token, head) on bf16; K23: three p . v parts
        bound, by = _bound_ms(nbytes + extra_bytes,
                              (4.0 if share == K14_SHARE else 8.0) * (tok + extra_tok + b)
                              * hq * d, "bf16_flops")
        print(f"  {name} B={b} Hq={hq} Hkv={hkv} ps={ps} MP={mp}: max-abs {err:.3g} "
              f"({ratio:.3g} of its bound, max|plain| {float(ref.float().abs().max()):.3g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA ({backend}) {lib:.4f} ms "
              f"(max-abs vs plain {lib_err:.3g}), bound {bound:.4f} ms ({by})")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound,
                          bound_by=by, max_abs_err=err)

    live = torch.arange(mp * ps, device="cuda")[None, :] < cached[:, None]
    for int8 in (True, False):
        name = "decode_v5_int8_defer" if int8 else "decode_v5_defer"
        k, v, ks, vs = _hm_pages(torch, st["gen"], st["pages"], hkv, ps, d, int8)
        sc = (ks, vs) if int8 else ()
        fn = dv5.decode_gqa_v5_int8_defer if int8 else dv5.decode_gqa_v5_defer
        finish(name, lambda: fn(q, kn, vn, k, v, *sc, cached, bt, sm, ps),
               lambda: dv5.decode_gqa_v5_defer_ref(q, kn, vn, k, v, cached, bt, sm, k_scales=ks,
                                                   v_scales=vs),
               HM_SHARE, _hm_rows(torch, k, ks, bt), _hm_rows(torch, v, vs, bt), live, (kn, vn),
               cached, int8)
        del k, v, ks, vs
    li = ATT7_LI
    seq = cached + 1
    slots = _slots_of(torch, bt, cached, ps)
    k, v, ks, vs = _stacked(torch, st, True)
    live_in = torch.arange(mp * ps, device="cuda")[None, :] < seq[:, None]
    finish("decode_v4b_int8",
           lambda: dv4.decode_v4b_int8(q, k, v, ks, vs, seq, bt, li, sm, ps)[0],
           lambda: dv4.decode_v4b_int8_ref(q, k, v, ks, vs, seq, bt, li, sm)[0], HM_SHARE,
           _hm_rows(torch, k[li], ks[li], bt), _hm_rows(torch, v[li], vs[li], bt), live_in,
           None, seq, True)
    for int8 in (True, False):
        name = "decode_fused_v4_int8" if int8 else "decode_fused_v4"
        if not int8:
            del k, v, ks, vs
            torch.cuda.empty_cache()
            k, v = _stacked(torch, st, False)
            ks = vs = None
        caches = (k, v, ks, vs) if int8 else (k, v)
        twin = [c.clone() for c in caches]
        kfn = dv4.decode_fused_v4_int8 if int8 else dv4.decode_fused_v4
        pfn = dv4.decode_fused_v4_int8_ref if int8 else dv4.decode_fused_v4_ref

        def write(caches=caches, twin=twin, name=name):
            if not all(torch.equal(a, t) for a, t in zip(caches, twin)):
                raise AssertionError(f"{name}: the caches differ from the plain version's")
        # the new token as the caches hold it after the write (int8: dequantised)
        if int8:
            kq, vq, kqs, vqs = quant_rows_int8(kn, vn)
            new = (kq.float().mul(kqs[..., None]).to(torch.bfloat16),
                   vq.float().mul(vqs[..., None]).to(torch.bfloat16))
        else:
            new = (kn, vn)
        finish(name,
               lambda: kfn(q, kn, vn, *caches, seq, bt, slots, li, sm, ps)[0],
               lambda: pfn(q, kn, vn, *twin, seq, bt, slots, li, sm)[0],
               HM_SHARE, _hm_rows(torch, k[li], ks[li] if int8 else None, bt),
               _hm_rows(torch, v[li], vs[li] if int8 else None, bt), live, new, cached, int8,
               extra_bytes=2.0 * b * hkv * (d * (1 if int8 else 2) + (4 if int8 else 0)),
               write=write)
        del twin
    del k, v, ks, vs
    torch.cuda.empty_cache()
    s7 = _v7_state(torch, st)
    args = (s7["k"], s7["v"], s7["ks"], s7["vs"], s7["kside"], s7["vside"], s7["rows"], cached,
            bt, sm, ps)
    rk, rv, live7 = _v7_rows(torch, st, s7)
    flushed = cached.long() // 64 * 64
    nside = float((cached.long() - flushed).sum())
    finish("decode_v7_int8", lambda: dv7.decode_gqa_v7_int8(q, None, kn, vn, *args),
           lambda: dv7.decode_gqa_v7_int8_ref(q, None, kn, vn, *args), K14_SHARE, rk, rv, live7,
           (kn, vn), flushed, True, extra_bytes=nside * hkv * 4.0 * d + 4.0 * b,
           extra_tok=nside)
    return rows


# K24's edges: (W, cached lengths): on and off a window boundary, sidecars of
# 0, 1, W - 1 and a few rows, over 4 pages of 128
V7_EDGES = ((64, (0, 1, 63, 64, 65, 127, 128, 389)), (100, (0, 1, 99, 100, 101, 199, 200, 305)))


def check_decode_v7_edges(torch, dv7):
    """K24 where its loop meets its edges, against its plain version within
    one bf16 ulp + K14_SHARE of max|plain|, each second call bit-identical,
    the wrapper's output and workspace allocated on 0x7f bytes: W 64 and
    100, 8 sequences (V7_EDGES: cached lengths on and off a window boundary,
    sidecar counts 0 and W - 1 among them) over 2 kv heads of 4 pages of 128
    tokens (rows split over blocks: skt_decode_v7_int8_splits must say S >
    1, so the merging block folds the sidecar and the current token in), G 1,
    4 and 16 (16: two blocks of 8)."""
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops.attention.decode_v3 import v3_groups
    rng = torch.Generator(device="cuda")
    rng.manual_seed(1024)
    hkv, d, ps, mp = 2, 128, 128, 4
    sm = d ** -0.5
    worst, calls, least_s = 0.0, 0, 8
    for w, lens in V7_EDGES:
        b = len(lens)
        pages = b * mp + 1
        cached = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
              .reshape(b, mp).to(torch.int32) + 1)
        k, v, ks, vs = _hm_pages(torch, rng, pages, hkv, ps, d, True)
        kside, vside = (torch.randn((b + 1, w, hkv * d), generator=rng, device="cuda")
                        .to(torch.bfloat16) for _ in range(2))
        rows = torch.randperm(b + 1, generator=rng, device="cuda")[:b].to(torch.int32)
        kn, vn = (torch.randn((b, hkv, d), generator=rng, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        for g in (1, 4, 16):
            q = (1.5 * torch.randn((b, hkv * g, d), generator=rng, device="cuda")
                 ).to(torch.bfloat16)
            ng = v3_groups(g)
            least_s = min(least_s, _build.splits("decode_v7_int8", b, hkv, g // ng, ng, mp, ps,
                                                 w))
            args = (q, None, kn, vn, k, v, ks, vs, kside, vside, rows, cached, bt, sm, ps, w)
            with _dirty_empty(torch, dv7):
                out, again = (dv7.decode_gqa_v7_int8(*args) for _ in range(2))
            ref = dv7.decode_gqa_v7_int8_ref(*args)
            torch.cuda.synchronize()
            _, ratio = _bf16_check(f"decode_v7_int8 edges W {w} G {g}", out, ref, K14_SHARE)
            if not torch.equal(out, again):
                raise AssertionError(f"decode_v7_int8 edges W {w} G {g}: a second call differs")
            worst, calls = max(worst, ratio), calls + 1
        del k, v, ks, vs, kside, vside
    if least_s < 2:
        raise AssertionError(f"decode_v7_int8 edges: took S = {least_s}, unsplit")
    print(f"  decode_v7_int8 edges ({calls} calls: W 64 and 100, cached {V7_EDGES[0][1]} and "
          f"{V7_EDGES[1][1]}, G 1, 4, 16, ps 128 over 4 pages, S >= {least_s}; output and "
          f"workspace on 0x7f bytes): at most {worst:.3g} of the bound, second calls "
          f"bit-identical")


def _attic_step(torch, build, name, fn, expect):
    """One call (or one step of calls) of a phase-13 entry point: exact
    launches (`expect`, no other kernel), finite outputs. Returns the
    outputs and ms by events around the eager call (host time included)."""
    before = dict(build.launches)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
    if delta != expect:
        raise AssertionError(f"{name}: launches {delta}, not {expect}")
    if not all(bool(torch.isfinite(o.float()).all()) for o in out):
        raise AssertionError(f"{name}: output not finite")
    return out, t0.elapsed_time(t1)


def run_attic(torch, build, dv4, dv5, dv7, cfg, gpu):
    """Phase 13: the attic through its public functions at Llama-3-8B's
    heads (64 sequences of 256..383 cached tokens, 128-token pages), the
    counters set to 0 first: the v5 decodes (bf16, int8); a step of 32
    layers on stacked int8 caches of scatter_stacked_int8 then
    decode_v4b_int8, and of decode_fused_v4_int8, and on stacked bf16
    caches of decode_fused_v4 (one call a layer, the layer a device
    tensor); 70 steps of the two-tier v7 loop (decode, sidecar_append,
    window_flush of the sequences that reach a multiple of 64: every
    sequence crosses one). Every call or step: exact launches, finite, a
    repeat from the same state bit-identical, the caches it writes bit-equal
    to the same step through the plain versions (SKT_IMPL=ref) from the same
    state, the outputs within the bars of that run. Returns the launches by
    kernel."""
    build.reset_launches()
    st = _attic_state(torch, cfg, 360)
    b, hkv, d, ps, sm = (st[k] for k in ("b", "hkv", "d", "ps", "sm"))
    q, kn, vn, cached, bt = st["q"], st["kn"], st["vn"], st["cached"], st["bt"]

    def held(name, run, state, share, expect):
        """run(state) twice from copies of one state on the kernels, once
        under SKT_IMPL=ref: outputs and written state."""
        copies = [[t.clone() for t in state] for _ in range(3)]
        (a, ms), (a2, _) = (_attic_step(torch, build, name, lambda c=c: run(c), expect)
                            for c in copies[:2])
        if not (all(torch.equal(x, y) for x, y in zip(a, a2))
                and all(torch.equal(x, y) for x, y in zip(copies[0], copies[1]))):
            raise AssertionError(f"{name}: a repeat from the same state differs")
        with _env(SKT_IMPL="ref"):
            ref, _ = _attic_step(torch, build, f"{name} (SKT_IMPL=ref)",
                                 lambda: run(copies[2]), {})
        if not all(torch.equal(x, y) for x, y in zip(copies[0], copies[2])):
            raise AssertionError(f"{name}: the state written differs from the plain run's")
        errs = [_bf16_check(f"{name} out {i}", x, y, share)[0] for i, (x, y) in
                enumerate(zip(a, ref))]
        print(f"  {name}: {ms:.3f} ms (events around the eager call), max-abs vs SKT_IMPL=ref "
              f"{max(errs):.3g}, repeat identical, state written equal; launches {expect}")
        del copies

    for int8 in (True, False):
        name = "decode_v5_int8_defer" if int8 else "decode_v5_defer"
        k, v, ks, vs = _hm_pages(torch, st["gen"], st["pages"], hkv, ps, d, int8)
        fn = dv5.decode_gqa_v5_int8_defer if int8 else dv5.decode_gqa_v5_defer
        state = [k, v, ks, vs] if int8 else [k, v]
        held(f"{name} (v5)", lambda c: [fn(q, kn, vn, *c, cached, bt, sm, ps)], state,
             HM_SHARE, {name: 1})
        del k, v, ks, vs, state
    layers = ATT7_LAYERS
    lis = [torch.tensor(li, dtype=torch.int32, device="cuda") for li in range(layers)]
    seq = cached + 1
    slots = _slots_of(torch, bt, cached, ps)
    gen = st["gen"]
    qs = [(1.5 * torch.randn(q.shape, generator=gen, device="cuda")).to(torch.bfloat16)
          for _ in range(layers)]
    news = [[torch.randn(kn.shape, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2)] for _ in range(layers)]

    def v4b_step(c):
        outs = []
        for li in range(layers):
            dv4.scatter_stacked_int8(*news[li], *c, lis[li], slots)
            outs.append(dv4.decode_v4b_int8(qs[li], *c, seq, bt, lis[li], sm, ps)[0])
        return outs

    def fused_step(c, fn):
        return [fn(qs[li], *news[li], *c, seq, bt, slots, lis[li], sm, ps)[0]
                for li in range(layers)]

    state = _stacked(torch, st, True)
    held(f"scatter_stacked_int8 + decode_v4b_int8, a {layers}-layer step", v4b_step, state,
         HM_SHARE, {"decode_v4b_int8": layers})
    held(f"decode_fused_v4_int8, a {layers}-layer step",
         lambda c: fused_step(c, dv4.decode_fused_v4_int8), state, HM_SHARE,
         {"decode_fused_v4_int8": layers})
    mem = sum(t.numel() * t.element_size() for t in state[:2]) / 1e9
    del state
    torch.cuda.empty_cache()
    state = _stacked(torch, st, False)
    held(f"decode_fused_v4, a {layers}-layer step", lambda c: fused_step(c, dv4.decode_fused_v4),
         state, HM_SHARE, {"decode_fused_v4": layers})
    del state
    torch.cuda.empty_cache()
    print(f"  stacked int8 K and V {mem:.2f} GB ({layers} layers of {st['pages']} pages)")
    s7 = _v7_state(torch, st)
    names7 = ("k", "v", "ks", "vs", "kside", "vside")
    qs7 = [(1.5 * torch.randn(q.shape, generator=gen, device="cuda")).to(torch.bfloat16)
           for _ in range(ATT7_STEPS)]
    news7 = [[torch.randn(kn.shape, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2)] for _ in range(ATT7_STEPS)]
    rows, btl = s7["rows"], bt.long()

    def v7_loop(c):
        k, v, ks, vs, kside, vside, cnt = c
        outs = []
        for step in range(ATT7_STEPS):
            outs.append(dv7.decode_gqa_v7_int8(qs7[step], None, *news7[step], k, v, ks, vs,
                                               kside, vside, rows, cnt, bt, sm, ps))
            dv7.sidecar_append(kside, vside, *news7[step], rows, cnt % 64)
            cnt += 1
            start = (cnt - 64).clamp_min(0).long()
            dv7.window_flush(k, v, ks, vs, kside, vside, rows,
                             btl[torch.arange(b, device="cuda"), start // ps], start % ps,
                             cnt % 64 == 0)
        return outs

    counts = cached.clone()
    held(f"the v7 two-tier loop, {ATT7_STEPS} steps", v7_loop,
         [s7[n] for n in names7] + [counts], K14_SHARE, {"decode_v7_int8": ATT7_STEPS})
    crossed = (cached + ATT7_STEPS) // 64 > cached // 64
    if not bool(crossed.all()):
        raise AssertionError("a sequence of the v7 loop crossed no window flush")
    print(f"  every sequence crossed a window flush (cached {int(cached.min())}.."
          f"{int(cached.max())} -> +{ATT7_STEPS}) [{gpu}]")
    return {k: v for k, v in build.launches.items() if v}


# ------------------------------------------------------- K10 on f32 pages

# K10's f32 form against its plain version: both all f32, the sums in
# another order; the bar is this share of max|plain| (O(1) outputs)
K10_F32_SHARE = 1e-5
# phase 16's attention shape: Qwen1.5-MoE-A2.7B's heads (16 of 128, 16 kv
# heads), 128 sequences of 256..383 tokens on 16-token pages
K10_F32_B, K10_F32_H, K10_F32_PS = 128, 16, 16


def _f32_check(name, out, ref):
    err = (out - ref).abs().max().item()
    bar = K10_F32_SHARE * ref.abs().max().item()
    if not err <= bar or not bool(out.isfinite().all()):
        raise AssertionError(f"{name}: max-abs {err:.3g} > {bar:.3g} ({K10_F32_SHARE} of "
                             "max|plain|), or not finite")
    return err, err / bar if bar else 0.0


def _f32_pages(torch, rng, b, hkv, g, ps, lens, mp, d=128):
    pages = b * mp + 1
    bt = (torch.randperm(pages - 1, generator=rng, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    k = torch.randn((hkv, pages, ps, d), generator=rng, device="cuda")
    v = torch.randn((hkv, pages, ps, d), generator=rng, device="cuda")
    q = 1.5 * torch.randn((b, hkv * g, d), generator=rng, device="cuda")
    seq = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, seq, bt


def check_decode_hm_f32(torch, dec, dv3, rng):
    """K10 on f32 pages at phase 16's shape (K10_F32_*; G 1): against its
    plain version within K10_F32_SHARE of max|plain|, a second call
    bit-identical, the output on 0x7f bytes; timed warm by graph replay and
    cold (_cold_ms), beside SDPA over the gathered f32 rows and the byte
    bound."""
    b, h, ps = K10_F32_B, K10_F32_H, K10_F32_PS
    lens = torch.randint(256, 384, (b,), generator=rng, device="cuda", dtype=torch.int32)
    mp = -(-384 // ps)
    q, k, v, seq, bt = _f32_pages(torch, rng, b, h, 1, ps, lens, mp)
    sm = 128 ** -0.5
    args = (q, k, v, seq, bt, sm, ps)
    with _dirty_empty(torch, dv3):
        out, again = dec.decode_gqa_hm(*args), dec.decode_gqa_hm(*args)
    ref = dec.decode_gqa_hm_ref(*args)
    torch.cuda.synchronize()
    if out.dtype != torch.float32:
        raise AssertionError(f"decode_hm_f32 gave {out.dtype}")
    err, ratio = _f32_check("decode_hm_f32", out, ref)
    if not torch.equal(out, again):
        raise AssertionError("decode_hm_f32: a second call differs")
    ms = _time_ms(lambda: dec.decode_gqa_hm(*args), 50, graph=True)
    plain = _time_ms(lambda: dec.decode_gqa_hm_ref(*args), 3)
    tok = seq.double().sum().item()
    nbytes = tok * h * 128 * 4 * 2 + 2 * 4 * b * h * 128 + 4 * b + 4 * b * mp

    def make_call(i):
        gi = torch.Generator(device="cuda")
        gi.manual_seed(500 + i)
        ci = _f32_pages(torch, gi, b, h, 1, ps, lens, mp)
        return lambda: dec.decode_gqa_hm(*ci, sm, ps)
    cold, sets = _cold_ms(torch, make_call, nbytes)
    n = mp * ps
    btl = bt.long()
    kk = k[:, btl].permute(1, 0, 2, 3, 4).reshape(b, h, n, 128).contiguous()
    vv = v[:, btl].permute(1, 0, 2, 3, 4).reshape(b, h, n, 128).contiguous()
    mask = (torch.arange(n, device="cuda")[None, :] < seq[:, None])[:, None, None, :]
    library, backend = _sdpa_yardstick(torch, q.reshape(b, h, 1, 128), kk, vv, mask, sm)
    lib_err = (library().reshape(b, h, 128) - ref).abs().max().item()
    lib = _time_ms(library, 50, graph=True)
    bound, by = _bound_ms(nbytes, 4.0 * tok * h * 128, "f32_flops")
    print(f"  decode_hm_f32 B={b} Hq=Hkv={h} D=128 ps={ps} MP={mp} seq {int(seq.min())}.."
          f"{int(seq.max())} (sum {int(tok)}), f32 q and pages: max-abs {err:.3g} ({ratio:.3g} "
          f"of its bar, max|plain| {float(ref.abs().max()):.3g}); kernel {ms:.4f} ms warm, "
          f"{cold:.4f} ms cold ({sets} sets), plain {plain:.3f} ms, SDPA ({backend}, f32 "
          f"gathered rows) {lib:.4f} ms (max-abs vs plain {lib_err:.3g}), bound {bound:.4f} ms "
          f"({by})")
    return dict(ms=ms, cold_ms=cold, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by, max_abs_err=err)


# K10 f32's edges: (ps, MP): pages of 16 and 128 over 4 pages, and one page
# of 1,024 (two softmax steps of 512 within it)
K10_F32_EDGE_PAGES = ((16, 4), (128, 4), (1024, 1))


def check_decode_hm_f32_edges(torch, dec, dv3):
    """K10 on f32 pages where its loop meets its edges: G 1, 2, 4, 8 and 16;
    pages of K10_F32_EDGE_PAGES; lengths 0, 1, ps - 1, ps, ps + 1, 2 ps + 3
    and 4 ps (capped at MP ps) over 7 sequences of 2 kv heads, a batch that
    splits each row over blocks (S > 1 asserted); output and workspace on
    0x7f bytes; each held to its plain version within K10_F32_SHARE of
    max|plain|, each second call bit-identical."""
    from sgl_kernel_npu_tpu_torch import _build
    rng = torch.Generator(device="cuda")
    rng.manual_seed(2022)
    hkv, b = 2, 7
    sm = 128 ** -0.5
    worst, calls, least_s = 0.0, 0, 8
    for ps, mp in K10_F32_EDGE_PAGES:
        lens = _v3_edge_lens(ps, mp)
        for g in (1, 2, 4, 8, 16):
            q, k, v, seq, bt = _f32_pages(torch, rng, b, hkv, g, ps, lens, mp)
            least_s = min(least_s, _build.splits("decode_hm_f32", b, hkv, g, mp, ps))
            with _dirty_empty(torch, dv3):
                out, again = (dec.decode_gqa_hm(q, k, v, seq, bt, sm, ps) for _ in range(2))
            ref = dec.decode_gqa_hm_ref(q, k, v, seq, bt, sm)
            torch.cuda.synchronize()
            _, ratio = _f32_check(f"decode_hm_f32 edges ps {ps} G {g}", out, ref)
            if not torch.equal(out, again):
                raise AssertionError(f"decode_hm_f32 edges ps {ps} G {g}: a second call differs")
            if not bool((out[0] == 0).all()):
                raise AssertionError("decode_hm_f32 edges: a length-0 row is not 0")
            worst, calls = max(worst, ratio), calls + 1
    if least_s < 2:
        raise AssertionError(f"decode_hm_f32 edges: a batch of {b} took S = {least_s}")
    print(f"  decode_hm_f32 edges ({calls} calls: G 1, 2, 4, 8, 16; ps 16 / 128 over 4 pages "
          f"and 1024 over one; lengths 0, 1, ps - 1, ps, ps + 1, 2 ps + 3, 4 ps; B {b}, S >= "
          f"{least_s}; output and workspace on 0x7f bytes): at most {worst:.3g} of the bar, "
          f"second calls bit-identical, length 0 gives 0")


# ------------------------------------------- the EP normal surface (phase 14)

# DeepSeek-V3's prefill shape at EP = 1: 4,096 tokens of hidden 7168, top-8
# over its 256 routed experts; the low-latency modes at phase 8's 128 tokens
EP_T, EP_H, EP_E, EP_K, EP_LL_T = 4096, 7168, 256, 8, 128
# the round trip x * sum(w) against the JAX tests' bars
# (tests/test_ep_dispatch_combine.py:97-99, tests/test_ep_features.py:157);
# those tests' rows are 64 wide, these 7168 (a row's absmax, hence its int8
# step, about twice theirs), and the weights sum to 1 as a router's do
EP_BAR = {"bf16": 1e-3, "int8": 0.06, "fp8": 0.1, "mxfp8": 0.12, "mxfp4": 0.4}


def _ep_inputs(torch, t, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((t, EP_H), generator=g, device="cuda").to(torch.bfloat16)
    idx = torch.rand((t, EP_E), generator=g, device="cuda").topk(EP_K, -1).indices.int()
    # the router's weights: renormalised to sum 1 a token (deepseek_v3.route)
    w = torch.rand((t, EP_K), generator=g, device="cuda")
    return x, idx, w / w.sum(-1, keepdim=True)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(u, v) for u, v in zip(a, b))
    if hasattr(a, "send_slot_token"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in (
            "send_slot_token", "send_valid", "send_counts", "input_offsets", "output_offsets",
            "recv_sizes", "recv_offsets"))
    if hasattr(a, "copy_slot"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in (
            "copy_slot", "send_counts", "input_offsets", "recv_counts"))
    return a is None and b is None or a.dtype == b.dtype and _bits_equal(a, b)


def _bits_equal(a, b):
    import torch
    return torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                       b.view(torch.uint8) if b.element_size() == 1 else b)


def _round_trip(name, got, x, w, bar):
    want = x.float() * w.sum(-1, keepdim=True)
    err = (got.float() - want).abs()
    if not bool((err <= bar + bar * want.abs()).all()):
        raise AssertionError(f"{name}: round trip off x * sum(w) by {err.max().item():.3g} "
                             f"(bar rtol = atol = {bar})")
    return err.max().item()


def run_ep_normal(torch, par, build, env, gpu):
    """Phase 14: the EP layer's normal-mode surface through Buffer(None, 256)
    at DeepSeek-V3's prefill shape, and the low-latency fp8 / MX modes.
    Every call twice, the second bit-identical; no kernel launch. Returns
    the launch counts of the phase (all 0)."""
    from sgl_kernel_npu_tpu_torch.ops import mxquant
    from sgl_kernel_npu_tpu_torch.ops.quant import per_token_quant_int8
    from sgl_kernel_npu_tpu_torch.parallel.strategies import normal
    x, idx, w = _ep_inputs(torch, EP_T, 14)
    torch.cuda.synchronize()
    build.reset_launches()
    times = {}

    def twice(name, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not _same(a, b):
            raise AssertionError(f"phase 14 {name}: a second call differs")
        times[name] = _time_ms(fn, 5, warmup=1)
        return a

    flat = {}
    for strat in ("default", "alltoall"):
        buf = par.Buffer(None, EP_E, normal_strategy=strat)
        for quant in ("bf16", "int8"):
            key = f"{strat} {quant}"
            res = twice(f"dispatch {key}", lambda: buf.dispatch(x, idx, w, quant_mode=quant))
            recv, sc, ridx, rw, count, per_expert, hd = res
            if int(count) != EP_T:
                raise AssertionError(f"phase 14 dispatch {key}: {int(count)} rows of {EP_T}")
            want = x if quant == "bf16" else per_token_quant_int8(x)[0]
            if not torch.equal(recv[:EP_T], want):
                raise AssertionError(f"phase 14 dispatch {key}: received rows differ from the "
                                     "source rows")
            cin = recv.float() if quant == "bf16" else recv.float() * sc
            comb = twice(f"combine {key}", lambda: buf.combine(cin, hd, rw))
            err = _round_trip(f"phase 14 {key}", comb[0], x, w, EP_BAR[quant])
            if not torch.allclose(comb[1], w, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"phase 14 combine {key}: weights off")
            flat[key] = (res, comb, err)
            if strat == "default" and quant == "bf16":
                nv = twice("notify_verify", lambda: buf.notify_verify(idx))
                if not (torch.equal(nv[0], hd.recv_sizes) and torch.equal(nv[5], per_expert)):
                    raise AssertionError("phase 14: notify_verify differs from the dispatch")
    # the long-sequence rounds (SKT_NORMAL_LONG_SEQ_ROUND=4) against one round
    os.environ["SKT_NORMAL_LONG_SEQ_ROUND"] = "4"
    try:
        rounds = env.long_seq_config()[0]
    finally:
        del os.environ["SKT_NORMAL_LONG_SEQ_ROUND"]
    strat = par.get_normal_strategy("default")
    g1 = par.EPGroup(None)

    def long_seq():
        res = normal.dispatch_long_seq(strat, x, idx, w, rounds=rounds, group=g1,
                                       num_experts=EP_E)
        return (torch.cat([r.recv_x for r in res]),
                normal.combine_long_seq(strat, [r.recv_x for r in res], [r.handle for r in res],
                                        [r.recv_topk_weights for r in res], group=g1))
    lr = twice(f"long-seq {rounds} rounds", long_seq)
    one = flat["default bf16"]
    one_comb = strat.combine(one[0][0], one[0][6], one[0][3], group=g1)
    if rounds != 4 or not (torch.equal(lr[0], one[0][0][:EP_T])
                           and _same(lr[1], one_comb)):
        raise AssertionError(f"phase 14: {rounds} long-seq rounds differ from one round")
    # the layered strategies over (EPGroup(None), EPGroup(None)) against the flat ones
    pair = (None, None)
    lay = par.Buffer(pair, EP_E, normal_strategy="layered")
    for quant in ("bf16", "int8"):
        res = twice(f"layered dispatch {quant}", lambda: lay.dispatch(x, idx, w,
                                                                       quant_mode=quant))
        ref = flat[f"default {quant}"][0]
        if not _same(res[:6], ref[:6]) or not _same(res[6], ref[6]):
            raise AssertionError(f"phase 14 layered {quant}: differs from the flat strategy")
    xl, idl, wl = _ep_inputs(torch, EP_LL_T, 8)
    ll_flat = par.Buffer(None, EP_E, EP_LL_T)
    ll_lay = par.Buffer(pair, EP_E, EP_LL_T, low_latency_strategy="layered")
    ll_err = {}
    for quant in ("bf16", "int8", "fp8", "mxfp8", "mxfp4"):
        res = twice(f"low_latency_dispatch {quant}",
                    lambda: ll_flat.low_latency_dispatch(xl, idl, quant_mode=quant))
        recv, sc = res[0], res[1]
        if quant in ("bf16", "int8"):
            lres = twice(f"layered low_latency_dispatch {quant}",
                         lambda: ll_lay.low_latency_dispatch(xl, idl, quant_mode=quant))
            if not _same(lres[:4], res[:4]) or not _same(lres[4], res[4]):
                raise AssertionError(f"phase 14 layered low latency {quant}: differs from the "
                                     "flat strategy")
        deq = (recv.float() if quant == "bf16" else
               recv.float() * sc[..., None] if quant in ("int8", "fp8") else
               (mxquant.dequantize_mxfp8 if quant == "mxfp8" else mxquant.dequantize_mxfp4)(
                   recv, sc, out_dtype=torch.float32))
        comb = twice(f"low_latency_combine {quant}",
                     lambda: ll_flat.low_latency_combine(deq, idl, wl, res[4]))
        ll_err[quant] = _round_trip(f"phase 14 low latency {quant}", comb, xl, wl,
                                    EP_BAR[quant])
    launches = dict(build.launches)
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched kernels: "
                             f"{ {k: n for k, n in launches.items() if n} }")
    print(f"  Buffer(None, {EP_E}) at T {EP_T} x H {EP_H} bf16, top-{EP_K}: received rows "
          "equal the source rows (bf16) and their int8 quantisation; round trip max-abs "
          + ", ".join(f"{k} {v[2]:.3g}" for k, v in flat.items())
          + f" (rtol = atol = {EP_BAR['bf16']} / {EP_BAR['int8']}); notify_verify = the "
          "dispatch's "
          f"counts; {rounds} long-seq rounds = one round, bit for bit; the layered normal and "
          "low-latency strategies over (EPGroup(None), EPGroup(None)) = the flat ones, bit for "
          f"bit; low-latency at T {EP_LL_T}: round trip max-abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in ll_err.items())
          + " (rtol = atol = " + ", ".join(f"{k} {EP_BAR[k]}" for k in ll_err) + "); every call "
          "twice, bit-identical; no kernel launched")
    print("  ms per call [" + gpu + "]: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return launches


# ------------------------------------------------- the EP models (phases 15, 16)

# deepseek-ai/DeepSeek-V3's published config.json at EP = 1, depth cut from
# 61 to 2 layers (the int8 experts take 11.3 GB a layer)
DSV3_WIDTHS = dict(vocab_size=129280, hidden_size=7168, num_heads=128, q_lora_rank=1536,
                   kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                   num_experts=256, top_k=8, moe_intermediate=2048, shared_intermediate=2048,
                   routed_scaling_factor=2.5, page_size=16)
DSV3_LAYERS = 2
# Qwen/Qwen1.5-MoE-A2.7B's published config.json, full depth, at EP = 1
QWEN_MOE_WIDTHS = dict(vocab_size=151936, hidden_size=2048, num_layers=24, num_heads=16,
                       num_kv_heads=16, head_dim=128, num_experts=60, top_k=4,
                       moe_intermediate=1408, shared_intermediate=5632, page_size=16)
EPM_B, EPM_STEPS, EPM_LO, EPM_HI = 128, 8, 256, 384
# each step against the same step run through the plain versions: the
# repo's logits bound (tests/test_torch_mla.py LOGITS_DIFF)
EPM_DIFF = 8e-3
# a top-k gap under this in the plain run, where the k-th choice has at
# least this probability, is a near-tie that another f32 order may decide
# the other way (choices below it carry no weight: the routers' logits
# spread so wide at these widths that most probabilities underflow)
EPM_TIE = 1e-6
_DSV3_BUCKETS = (("A w8a8_gemm (L = 1)", _A), ("K8 w8a8_gemm_grouped", _K8),
                 ("memsets", ("Memset",)))
_QMOE_BUCKETS = (("K10 decode_hm_f32", ("decode_hm_f32_kernel",)),
                 ("K8 w8a8_gemm_grouped", _K8), ("memsets", ("Memset",)))


class _RouteLog:
    """Wraps deepseek_v3.route (both EP models route through it): each
    call's chosen experts and weights, and the least gap between the k-th
    and the next probability where the k-th carries at least EPM_TIE."""

    def __init__(self, torch, ds):
        self.torch, self.ds, self.orig = torch, ds, ds.route
        self.picks, self.gap = [], float("inf")

    def __enter__(self):
        def route(h2, router, top_k):
            w, i = self.orig(h2, router, top_k)
            p = self.torch.softmax(h2 @ router, -1).topk(top_k + 1).values
            gap = self.torch.where(p[:, -2] >= EPM_TIE, p[:, -2] - p[:, -1], float("inf"))
            self.gap = min(self.gap, float(gap.min()))
            self.picks.append((i, w))
            return w, i
        self.ds.route = route
        return self

    def __exit__(self, *exc):
        self.ds.route = self.orig
        return False

    def differ(self, other):
        """(tokens routed otherwise than in `other`, summed over the calls;
        the most renormalised weight such a token gives experts `other` did
        not choose)."""
        n, most = 0, 0.0
        for (ia, wa), (ib, _) in zip(self.picks, other.picks):
            missing = ~(ia[:, :, None] == ib[:, None, :]).any(-1)
            n += int(missing.any(-1).sum())
            most = max(most, float((wa * missing).sum(-1).max()))
        return n, most


def _slot_rows(caches, slots, ps, page_dim):
    """(page, offset, the rows of each cache a step writes at slots [B])."""
    pg, off = (slots // ps).long(), (slots % ps).long()
    if page_dim == 1:
        return [(pg, off, c[:, pg, off].clone()) for c in caches]
    return [(pg, off, c[:, :, pg, off].clone()) for c in caches]


def _put_rows(caches, saved, page_dim):
    for c, (pg, off, rows) in zip(caches, saved):
        if page_dim == 1:
            c[:, pg, off] = rows
        else:
            c[:, :, pg, off] = rows


def run_ep_model(torch, mod, ds, build, cfg, params, caches, page_dim, per_layer, buckets,
                 label, gpu):
    """Phases 15 and 16: EPM_STEPS greedy decode steps of `mod` at EP = 1
    (batch EPM_B, EPM_LO..EPM_HI cached tokens; `caches` with pages on dim
    `page_dim`), the launches of every step exact (per_layer per layer,
    every other kernel 0), logits finite; then from the same state again,
    each step first through the plain versions (SKT_IMPL=ref) and then the
    kernels: the first run's logits and tokens repeated bit for bit, the
    plain logits within calc_diff EPM_DIFF, the two runs' routing compared.
    Prints ms/step, tok/s and the profiler's split. Returns the launch
    counts of the first run."""
    b, ps, L = EPM_B, cfg.page_size, cfg.num_layers
    rng = np.random.default_rng(16)
    mp = -(-(EPM_HI + EPM_STEPS) // ps)
    bt = torch.from_numpy(rng.permutation(caches[0].shape[page_dim])[: b * mp]
                          .reshape(b, mp).astype(np.int32)).cuda()
    pos0 = torch.from_numpy(rng.integers(EPM_LO, EPM_HI, b).astype(np.int32)).cuda()
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    rows = torch.arange(b, device="cuda")
    step = mod.make_decode_step(None, cfg, max_tokens=b)

    def one(ids, pos):
        slots = bt[rows, pos // ps] * ps + pos % ps
        saved = _slot_rows(caches, slots, ps, page_dim)
        return step(params, *caches, ids, pos, pos + 1, bt, slots)[0], saved

    build.reset_launches()
    ids, pos, toks, first, undo, times = ids0, pos0, [], [], [], []
    for _ in range(EPM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, saved = one(ids, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(logits.isfinite().all()):
            raise AssertionError(f"{label}: logits are not finite")
        first.append(logits)
        undo.append(saved)
        ids = torch.argmax(logits, -1).to(torch.int32)
        toks.append(ids)
        pos = pos + 1
    launches = dict(build.launches)
    for name, n in launches.items():
        want = per_layer.get(name, 0) * L * EPM_STEPS
        if n != want:
            raise AssertionError(f"{label}: {name} launched {n} times in {EPM_STEPS} steps, "
                                 f"not {want} ({per_layer.get(name, 0)} a layer)")
    for saved in reversed(undo):                  # back to the first state
        _put_rows(caches, saved, page_dim)
    ids, pos, worst, flips, flip_w, gap = ids0, pos0, 0.0, 0, 0.0, float("inf")
    for i in range(EPM_STEPS):
        os.environ["SKT_IMPL"] = "ref"
        try:
            with _RouteLog(torch, ds) as ref_route:
                plain, saved = one(ids, pos)
        finally:
            del os.environ["SKT_IMPL"]
        _put_rows(caches, saved, page_dim)
        with _RouteLog(torch, ds) as kern_route:
            logits, _ = one(ids, pos)
        if not torch.equal(logits, first[i]):
            raise AssertionError(f"{label}: step {i} from the same state gave other logits")
        worst = max(worst, _calc_diff(logits, plain))
        if worst > EPM_DIFF:
            raise AssertionError(f"{label}: step {i} off its plain run: calc_diff {worst:.3g}")
        gap = min(gap, ref_route.gap)
        n, most = ref_route.differ(kern_route)
        flips, flip_w = flips + n, max(flip_w, most)
        ids = torch.argmax(logits, -1).to(torch.int32)
        if not torch.equal(ids, toks[i]):
            raise AssertionError(f"{label}: step {i} repeated other tokens")
        pos = pos + 1
    dt = float(np.median(times))
    tie = (f"none under {EPM_TIE}" if gap >= EPM_TIE else
           f"under {EPM_TIE}: a near-tie another f32 order may decide the other way, so the "
           f"bound is the logits' calc_diff {EPM_DIFF}")
    print(f"  {label}: B={b}, {EPM_LO}..{EPM_HI} cached tokens on {ps}-token pages, "
          f"{EPM_STEPS} greedy steps: median {1e3 * dt:.3f} ms/step (steps "
          f"{[round(1e3 * t, 3) for t in times]}), {b / dt:.1f} tok/s [{gpu}]")
    print(f"  launches in {EPM_STEPS} steps: "
          + ", ".join(f"{k} {n} ({n // (L * EPM_STEPS)}/layer)" for k, n in launches.items() if n)
          + "; every other kernel 0; logits finite; a second run from the same state repeats "
          f"tokens and logits bit for bit; against SKT_IMPL=ref from the same state: worst "
          f"calc_diff {worst:.3g} (bar {EPM_DIFF}); least top-k gap of the plain run where "
          f"the k-th choice has probability >= {EPM_TIE}: {gap:.3g} ({tie}); (token, layer) "
          f"routings that differ from it {flips} of {b * L * EPM_STEPS}, their experts the "
          f"kernels' run did not choose carrying at most {flip_w:.3g} of a token's weight")
    profile_step(torch, lambda: one(ids0, pos0), buckets, f"{label} step (B={b})")
    return launches


def run_deepseek_v3(torch, build, gpu):
    """Phase 15: models/deepseek_v3.py at DeepSeek-V3's widths, depth cut to
    DSV3_LAYERS, EP = 1, the "default" low-latency strategy; weights drawn
    on the card by a seeded torch.Generator in init_params' shapes and
    scales."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as ds
    cfg = ds.DeepSeekV3Config(num_layers=DSV3_LAYERS, **DSV3_WIDTHS)
    t0 = time.perf_counter()
    params = ds.init_params(cfg, 0, "cuda", draws="torch")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  reduced: num_layers 61 -> {DSV3_LAYERS} (every width as published); "
          f"init_params (torch.Generator on the card, seed 0) {time.perf_counter() - t0:.1f} s, "
          f"{nbytes / 1e9:.2f} GB")
    mp = -(-(EPM_HI + EPM_STEPS) // cfg.page_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    ckv, kr = ds.init_kv_cache(cfg, EPM_B * mp + 1)
    ckv.normal_(generator=gen)
    kr.normal_(generator=gen)
    return run_ep_model(torch, ds, ds, build, cfg, params, [ckv, kr], 1,
                        {"w8a8_gemm_l1": 1, "w8a8_gemm_grouped": 2}, _DSV3_BUCKETS,
                        "DeepSeek-V3 (2 layers)", gpu)


def run_qwen_moe(torch, build, gpu):
    """Phase 16: models/moe.py at Qwen1.5-MoE-A2.7B's widths, full depth,
    EP = 1; weights drawn on the card; f32 caches."""
    from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as ds
    from sgl_kernel_npu_tpu_torch.models import moe
    cfg = moe.MoEConfig(**QWEN_MOE_WIDTHS)
    t0 = time.perf_counter()
    params = moe.init_params(cfg, 0, "cuda", draws="torch")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    mp = -(-(EPM_HI + EPM_STEPS) // cfg.page_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    kc, vc = moe.init_kv_cache(cfg, EPM_B * mp + 1)
    kc.normal_(generator=gen)
    vc.normal_(generator=gen)
    print(f"  init_params (torch.Generator on the card, seed 0) {time.perf_counter() - t0:.1f} "
          f"s, {nbytes / 1e9:.2f} GB of weights, {2 * kc.numel() * 4 / 1e9:.2f} GB of f32 caches")
    return run_ep_model(torch, moe, ds, build, cfg, params, [kc, vc], 2,
                        {"decode_hm_f32": 1, "w8a8_gemm_grouped": 2}, _QMOE_BUCKETS,
                        "Qwen1.5-MoE-A2.7B", gpu)


# --------------------------------------- phase 18: HF checkpoints, TP, K2 routes

HF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "hf_checkpoints")
HF_LLAMA_LAYERS = 2     # of Meta-Llama-3-8B's 32 (phase 15's style of depth cut)
HF_MLA_LAYERS = 2       # of DeepSeek-V2-Lite's 27
_ST_NAMES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int8": "I8",
             "int32": "I32"}


def write_safetensors(torch, path, tensors):
    """Write {name: torch tensor (any device)} as one .safetensors file: a
    little-endian u64 header length, the JSON header padded to 8 bytes with
    spaces, then each tensor's bytes in order."""
    import struct
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[str(t.dtype).split(".")[1]], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)


class _Checkpoint:
    """A bf16 HF checkpoint drawn on the card from a seeded torch.Generator
    into its own directory under HF_DIR (config.json and shards of at most
    ~2 GB), removed on exit. `add(name, shape, scale, offset)` draws
    offset + scale * N(0, 1); `seconds` holds the write time."""

    def __init__(self, torch, name, config, seed):
        import shutil
        self.path = os.path.join(HF_DIR, name)
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path)
        with open(os.path.join(self.path, "config.json"), "w") as f:
            json.dump(config, f)
        self.torch = torch
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)
        self.shard, self.size, self.files, self.nbytes, self.seconds = {}, 0, 0, 0, 0.0

    def add(self, name, shape, scale=0.02, offset=0.0):
        torch = self.torch
        t = (torch.randn(shape, generator=self.gen, device="cuda") * scale + offset).to(
            torch.bfloat16)
        self.shard[name] = t
        self.size += t.numel() * 2
        if self.size >= 2e9:
            self.flush()

    def flush(self):
        if not self.shard:
            return
        t0 = time.perf_counter()
        self.files += 1
        write_safetensors(self.torch, os.path.join(self.path,
                                                   f"model-{self.files:05d}.safetensors"),
                          self.shard)
        self.seconds += time.perf_counter() - t0
        self.nbytes += self.size
        self.shard, self.size = {}, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import shutil
        self.shard = {}
        shutil.rmtree(self.path, ignore_errors=True)


def _hf_llama_config(cfg, layers):
    return dict(architectures=["LlamaForCausalLM"], vocab_size=cfg.vocab_size,
                hidden_size=cfg.hidden_size, num_hidden_layers=layers,
                num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, intermediate_size=cfg.intermediate_size,
                rope_theta=cfg.rope_base, rms_norm_eps=cfg.rms_eps,
                max_position_embeddings=cfg.max_position, tie_word_embeddings=False)


def _draw_llama(ck, cfg, layers):
    """Meta-Llama-3-8B's tensor names and shapes ([out, in]), `layers` deep."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    ck.add("model.embed_tokens.weight", (cfg.vocab_size, h))
    for i in range(layers):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (cfg.q_size, h)),
                            ("self_attn.k_proj", (cfg.kv_size, h)),
                            ("self_attn.v_proj", (cfg.kv_size, h)),
                            ("self_attn.o_proj", (h, cfg.q_size)),
                            ("mlp.gate_proj", (f, h)), ("mlp.up_proj", (f, h)),
                            ("mlp.down_proj", (h, f))):
            ck.add(p + name + ".weight", shape)
        ck.add(p + "input_layernorm.weight", (h,), 0.1, 1.0)
        ck.add(p + "post_attention_layernorm.weight", (h,), 0.1, 1.0)
    ck.add("model.norm.weight", (h,), 0.1, 1.0)
    ck.add("lm_head.weight", (cfg.vocab_size, h))
    ck.flush()


def _hf_mla_config(mcfg, layers):
    return dict(architectures=["DeepseekV2ForCausalLM"], vocab_size=mcfg.vocab_size,
                hidden_size=mcfg.hidden_size, num_hidden_layers=layers,
                num_attention_heads=mcfg.num_heads, kv_lora_rank=mcfg.kv_lora_rank,
                qk_rope_head_dim=mcfg.qk_rope_dim, qk_nope_head_dim=mcfg.qk_nope_dim,
                v_head_dim=mcfg.v_head_dim, q_lora_rank=mcfg.q_lora_rank,
                intermediate_size=mcfg.intermediate_size, rms_norm_eps=mcfg.rms_eps,
                max_position_embeddings=mcfg.max_position, tie_word_embeddings=False)


def _draw_mla(ck, mcfg, layers):
    """DeepSeek-V2's attention tensor names (q LoRA, MQA latent) and a dense
    MLP, at `mcfg`'s widths, `layers` deep."""
    h, heads, f = mcfg.hidden_size, mcfg.num_heads, mcfg.intermediate_size
    kvl, rope, nope, vd, ql = (mcfg.kv_lora_rank, mcfg.qk_rope_dim, mcfg.qk_nope_dim,
                               mcfg.v_head_dim, mcfg.q_lora_rank)
    ck.add("model.embed_tokens.weight", (mcfg.vocab_size, h))
    for i in range(layers):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_a_proj", (ql, h)),
                            ("self_attn.q_b_proj", (heads * (nope + rope), ql)),
                            ("self_attn.kv_a_proj_with_mqa", (kvl + rope, h)),
                            ("self_attn.kv_b_proj", (heads * (nope + vd), kvl)),
                            ("self_attn.o_proj", (h, heads * vd)),
                            ("mlp.gate_proj", (f, h)), ("mlp.up_proj", (f, h)),
                            ("mlp.down_proj", (h, f))):
            ck.add(p + name + ".weight", shape)
        for name, n in (("self_attn.q_a_layernorm", ql), ("self_attn.kv_a_layernorm", kvl),
                        ("input_layernorm", h), ("post_attention_layernorm", h)):
            ck.add(p + name + ".weight", (n,), 0.1, 1.0)
    ck.add("model.norm.weight", (h,), 0.1, 1.0)
    ck.add("lm_head.weight", (mcfg.vocab_size, h))
    ck.flush()


def _banks_equal(torch, card, cpu, names):
    """Layer 0 of each named bank and lm_head of two loads bit-equal."""
    for name in names:
        for part in card["layers"][name]:
            if not torch.equal(card["layers"][name][part][0].cpu(), cpu["layers"][name][part][0]):
                raise AssertionError(f"layer 0 {name}.{part}: the card's load differs from the "
                                     "CPU's")
    for part in ("q", "scale"):
        if not torch.equal(card["lm_head"][part].cpu(), cpu["lm_head"][part]):
            raise AssertionError(f"lm_head.{part}: the card's load differs from the CPU's")


def _scaled(expect, full, layers):
    """An engine call's launches at `layers` of `full`'s: per-layer counts
    scaled, the once-a-call ones (append, lm_head) kept."""
    return {kind: {k: (n // full * layers if n % full == 0 and n >= full else n)
                   for k, n in calls.items()} for kind, calls in expect.items()}


def run_hf_llama(torch, serving, llama, loader, build, prompts, late, new_tokens, gpu):
    """Phase 18 (a): a bf16 checkpoint at Meta-Llama-3-8B's widths, 2 of 32
    layers, loaded onto the card (layer 0's banks and lm_head bit-equal to
    the same load on the CPU) and served through LlamaEngine: phase 2's 8
    requests, 16 tokens each, exact launches a call, a repeat identical.
    Then (e) on the same checkpoint. Returns the launch counts of the run."""
    cfg = llama.LlamaConfig()
    layers = HF_LLAMA_LAYERS
    with _Checkpoint(torch, "llama", _hf_llama_config(cfg, layers), 18) as ck:
        _draw_llama(ck, cfg, layers)
        t0 = time.perf_counter()
        lcfg, params = loader.load_llama_w8a8(ck.path, "cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, cpu = loader.load_llama_w8a8(ck.path, "cpu")
        t_cpu = time.perf_counter() - t0
        _banks_equal(torch, params, cpu, ("wqkv", "wo", "w13", "w2"))
        del cpu
        print(f"  (a) Llama checkpoint: {ck.nbytes / 1e9:.2f} GB bf16 in {ck.files} files, "
              f"write {ck.seconds:.1f} s, load_llama_w8a8 on the card {t_card:.1f} s (on the "
              f"CPU {t_cpu:.1f} s: layer 0's banks and lm_head bit-equal)")
        ecfg = dataclasses.replace(lcfg, int8_kv=True)
        expect = _scaled(LLAMA_SERVING, cfg.num_layers, layers)
        build.reset_launches()
        outs, st, wall, reused, launches = run_engine(torch, serving, build, ecfg, params,
                                                      prompts, late, new_tokens, expect=expect)
        if any(len(o) != new_tokens for o in outs):
            raise AssertionError(f"(a) token counts {[len(o) for o in outs]}")
        again = run_engine(torch, serving, build, ecfg, params, prompts, late, new_tokens,
                           expect=expect)[0]
        if again != outs:
            raise AssertionError("(a) a second run gave other tokens")
        missing = [k for k in SERVING_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"(a) kernels never launched: {missing}")
        print(f"  (a) LlamaEngine on the loaded weights: {len(outs)} requests x {new_tokens} "
              f"tokens, radix reuse {reused}, repeat identical; {_ms_per_decode(st):.2f} ms a "
              f"decode call; launches {expect} a call [{gpu}]")
        t0 = time.perf_counter()
        run_tp(torch, llama, loader, build, ck.path, ecfg, params)
        print(f"  (e) {time.perf_counter() - t0:.1f} s")
    return launches


# (e): TP decode from a seeded tm cache, 8 sequences of 150..299 cached tokens
TP_B, TP_STEPS, TP_DIFF = 8, 3, 5e-3


def _tp_inputs(torch, cfg):
    """(tm cache, the steps' (ids, positions, seq_lens, block table, slots))
    from seed 19 on the card: int8 rows and scales, 8 sequences."""
    ps = cfg.page_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    pos = torch.randint(150, 300, (TP_B,), generator=gen, device="cuda", dtype=torch.int32)
    mp = -(-(300 + TP_STEPS) // ps)
    kv = _tm_seeded(torch, cfg, TP_B * mp + 1, gen)
    bt = torch.arange(1, TP_B * mp + 1, dtype=torch.int32, device="cuda").reshape(TP_B, mp)
    rows = torch.arange(TP_B, device="cuda")
    steps = []
    for _ in range(TP_STEPS):
        ids = torch.randint(0, cfg.vocab_size, (TP_B,), generator=gen, device="cuda",
                            dtype=torch.int32)
        steps.append((ids, pos, pos + 1, bt, bt[rows, pos // ps] * ps + pos % ps))
        pos = pos + 1
    return kv, steps


def _tm_seeded(torch, cfg, pages, gen):
    kv = {"k": torch.randint(-127, 128, (cfg.num_layers, pages, cfg.page_size * cfg.num_kv_heads,
                                         cfg.head_dim), generator=gen, dtype=torch.int8,
                             device="cuda")}
    kv["v"] = torch.randint(-127, 128, kv["k"].shape, generator=gen, dtype=torch.int8,
                            device="cuda")
    for name in ("ks", "vs"):
        kv[name] = torch.rand(kv["k"].shape[:2] + (1, kv["k"].shape[2]), generator=gen,
                              device="cuda") * 0.02 + 0.001
    return kv


def _tm_shards(torch, kv, tp, hkv):
    """[tp, ...]-stacked shards of a tm cache (rows t * hkv + h of a page;
    shard s holds heads s * hkv / tp ...)."""
    out = {}
    for name, a in kv.items():
        scales = name in ("ks", "vs")                   # [L, P, 1, ps * hkv]
        x = a.reshape(*a.shape[:-1], -1, hkv) if scales else a.reshape(
            *a.shape[:2], -1, hkv, a.shape[-1])
        parts = x.chunk(tp, dim=-1 if scales else -2)
        out[name] = torch.stack([q.reshape(*a.shape[:-1], -1) if scales else
                                 q.reshape(*a.shape[:2], -1, a.shape[-1]) for q in parts])
    return out


def _tp_rank(rank, world, init_file, path, out_file):
    """One rank of (e)'s TP 2 run: load the checkpoint onto the card, take
    shard `rank`, run decode_step_tp over a gloo group for TP_STEPS steps;
    rank 0 saves the logits."""
    import torch
    import torch.distributed as dist
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.models import llama, loader
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg, params = loader.load_llama_w8a8(path, "cuda")
        cfg = dataclasses.replace(cfg, int8_kv=True)
        kv, steps = _tp_inputs(torch, cfg)
        params_tp = llama.shard_params_tp(params, cfg, world)
        kv_tp = _tm_shards(torch, kv, world, cfg.num_kv_heads)
        del params, kv
        _build.reset_launches()
        out = []
        for args in steps:
            lg, kv_tp = llama.decode_step_tp(params_tp, cfg, kv_tp, *args)
            out.append(lg)
        torch.cuda.synchronize()
        print(f"  (e) tp {world} rank {rank}: launches in {TP_STEPS} steps "
              f"{ {k: n for k, n in _build.launches.items() if n} }", flush=True)
        if rank == 0:
            torch.save(torch.stack(out).cpu(), out_file)
    finally:
        dist.destroy_process_group()


def run_tp(torch, llama, loader, build, path, cfg, params):
    """Phase 18 (e): decode_step_tp on (a)'s weights. tp 1 on a one-rank
    NCCL group bit-identical to decode_step_kv; tp 2 in two processes that
    share the card over a gloo group, TP_STEPS steps within calc_diff TP_DIFF
    of the unsharded decode_step_kv (tests/test_llama_model.py's bar)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    kv, steps = _tp_inputs(torch, cfg)
    kv1 = {k: v.clone() for k, v in kv.items()}
    single = []
    for args in steps:
        lg, kv = llama.decode_step_kv(params, cfg, kv, *args)
        single.append(lg)
    init = os.path.join(HF_DIR, "tp_init")
    for f in (init, init + "2"):
        if os.path.exists(f):
            os.remove(f)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    try:
        params_tp = llama.shard_params_tp(params, cfg, 1)
        kv_tp = {k: v[None] for k, v in kv1.items()}
        build.reset_launches()
        for i, args in enumerate(steps):
            lg, kv_tp = llama.decode_step_tp(params_tp, cfg, kv_tp, *args)
            if not torch.equal(lg, single[i]):
                raise AssertionError(f"(e) tp 1 step {i}: logits differ from decode_step_kv")
        one = {k: n for k, n in build.launches.items() if n}
    finally:
        dist.destroy_process_group()
    print(f"  (e) tp 1 (one-rank NCCL group): {TP_STEPS} steps bit-identical to "
          f"decode_step_kv; launches {one}")
    out_file = os.path.join(HF_DIR, "tp2_logits.pt")
    mp.start_processes(_tp_rank, args=(2, init + "2", path, out_file), nprocs=2, join=True,
                       start_method="spawn")
    got = torch.load(out_file).cuda()
    diffs = [_calc_diff(got[i], single[i]) for i in range(TP_STEPS)]
    if not all(d < TP_DIFF for d in diffs) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"(e) tp 2: calc_diff {diffs} against decode_step_kv (bar "
                             f"{TP_DIFF})")
    print(f"  (e) tp 2 (two processes, gloo, one card): {TP_STEPS} steps, calc_diff against "
          f"decode_step_kv {[float(f'{d:.3g}') for d in diffs]} (bar {TP_DIFF})")


def run_hf_mla(torch, serving, dm, loader, build, mcfg, prompts, late, new_tokens, gpu):
    """Phase 18 (b): a bf16 checkpoint at bench.py's MlaConfig widths
    (DeepSeek-V2-Lite with V2's q LoRA of 1536), 2 of 27 layers, loaded onto
    the card (layer 0's banks and lm_head equal to the CPU load) and served
    through MlaEngine: phase 5's requests, exact launches a call, a repeat
    identical. Returns the launch counts."""
    layers = HF_MLA_LAYERS
    with _Checkpoint(torch, "mla", _hf_mla_config(mcfg, layers), 28) as ck:
        _draw_mla(ck, mcfg, layers)
        t0 = time.perf_counter()
        lcfg, params = loader.load_deepseek_mla_w8a8(ck.path, "cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        _, cpu = loader.load_deepseek_mla_w8a8(ck.path, "cpu")
        _banks_equal(torch, params, cpu, ("wdqkv", "wuq", "wo", "w13", "w2"))
        del cpu
        print(f"  (b) MLA checkpoint: {ck.nbytes / 1e9:.2f} GB bf16 in {ck.files} files, "
              f"write {ck.seconds:.1f} s, load_deepseek_mla_w8a8 on the card {t_card:.1f} s "
              f"(layer 0's banks and lm_head bit-equal to the CPU load)")
        expect = _scaled(MLA_SERVING, mcfg.num_layers, layers)
        build.reset_launches()
        outs, st, _, reused, launches = run_engine(
            torch, serving, build, lcfg, params, prompts, late, new_tokens,
            engine_cls=serving.MlaEngine, expect=expect)
        if any(len(o) != new_tokens for o in outs):
            raise AssertionError(f"(b) token counts {[len(o) for o in outs]}")
        again = run_engine(torch, serving, build, lcfg, params, prompts, late, new_tokens,
                           engine_cls=serving.MlaEngine, expect=expect)[0]
        if again != outs:
            raise AssertionError("(b) a second run gave other tokens")
        missing = [k for k in ("rmsq_gemm_pt", "w8a8_gemm", "decode_mla") if launches[k] <= 0]
        if missing:
            raise AssertionError(f"(b) kernels never launched: {missing}")
        print(f"  (b) MlaEngine on the loaded weights: {len(outs)} requests x {new_tokens} "
              f"tokens, radix reuse {reused}, repeat identical; {_ms_per_decode(st):.2f} ms a "
              f"decode call; launches {expect} a call [{gpu}]")
    return launches


# Qwen/Qwen3-Next-80B-A3B-Instruct's config.json, cut to 4 of 48 layers (the
# least depth that keeps the 3:1 linear:full pattern)
QWEN_NEXT_HF = dict(
    architectures=["Qwen3NextForCausalLM"], vocab_size=151936, hidden_size=2048,
    num_hidden_layers=4, num_attention_heads=16, num_key_value_heads=2, head_dim=256,
    linear_num_key_heads=16, linear_num_value_heads=32, linear_key_head_dim=128,
    linear_value_head_dim=128, linear_conv_kernel_dim=4, num_experts=512,
    num_experts_per_tok=10, moe_intermediate_size=512, shared_expert_intermediate_size=512,
    intermediate_size=5120, partial_rotary_factor=0.25, rope_theta=10000000.0,
    rms_norm_eps=1e-6, norm_topk_prob=True, max_position_embeddings=262144,
    layer_types=["linear_attention"] * 3 + ["full_attention"], tie_word_embeddings=False)
# per decode_step_q step at those 4 layers: K1 wqkvz + wo a GDN layer, wq, wk,
# wv, wo the attention layer, the shared expert's w13 + w2 a layer, lm_head;
# K8 two a layer; K9 a GDN layer; K10 at head dim 256 the attention layer
QWEN_NEXT_PER_STEP = {"w8a8_gemm_tiled": 19, "w8a8_gemm_grouped": 8, "gdn_recurrent": 3,
                      "decode_hm256": 1}
QWEN_NEXT_B, QWEN_NEXT_STEPS = 128, 8
_QWEN_NEXT_BUCKETS = (("K1 w8a8_gemm_tiled", _K1), ("K8 w8a8_gemm_grouped", _K8),
                      ("K9 gdn_recurrent", ("gdn_recurrent_kernel",)),
                      ("K10 decode_hm256", ("decode_hm256_kernel",)), ("memsets", ("Memset",)))


def _draw_qwen_next(ck, c):
    """Qwen3-Next's tensor names and shapes ([out, in]): zero-centred norms
    (0.1 N), A_log and dt_bias at their scale, conv1d without bias."""
    h, e, f, fs = (c["hidden_size"], c["num_experts"], c["moe_intermediate_size"],
                   c["shared_expert_intermediate_size"])
    hk, hv, dk, dv = (c["linear_num_key_heads"], c["linear_num_value_heads"],
                      c["linear_key_head_dim"], c["linear_value_head_dim"])
    r = hv // hk
    nq, nkv, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    ck.add("model.embed_tokens.weight", (c["vocab_size"], h))
    for i, kind in enumerate(c["layer_types"]):
        p = f"model.layers.{i}."
        ck.add(p + "input_layernorm.weight", (h,), 0.1)
        ck.add(p + "post_attention_layernorm.weight", (h,), 0.1)
        if kind == "linear_attention":
            la = p + "linear_attn."
            ck.add(la + "in_proj_qkvz.weight", (hk * (2 * dk + 2 * r * dv), h))
            ck.add(la + "in_proj_ba.weight", (hk * 2 * r, h))
            ck.add(la + "conv1d.weight", (2 * hk * dk + hv * dv, 1, c["linear_conv_kernel_dim"]),
                   0.2)
            ck.add(la + "A_log", (hv,), 0.5, 1.0)
            ck.add(la + "dt_bias", (hv,), 0.2)
            ck.add(la + "norm.weight", (dv,), 0.1, 1.0)
            ck.add(la + "out_proj.weight", (h, hv * dv))
        else:
            sa = p + "self_attn."
            ck.add(sa + "q_proj.weight", (nq * d * 2, h))
            ck.add(sa + "k_proj.weight", (nkv * d, h))
            ck.add(sa + "v_proj.weight", (nkv * d, h))
            ck.add(sa + "o_proj.weight", (h, nq * d))
            ck.add(sa + "q_norm.weight", (d,), 0.1)
            ck.add(sa + "k_norm.weight", (d,), 0.1)
        mp_ = p + "mlp."
        ck.add(mp_ + "gate.weight", (e, h))
        for j in range(e):
            ck.add(f"{mp_}experts.{j}.gate_proj.weight", (f, h))
            ck.add(f"{mp_}experts.{j}.up_proj.weight", (f, h))
            ck.add(f"{mp_}experts.{j}.down_proj.weight", (h, f))
        ck.add(mp_ + "shared_expert.gate_proj.weight", (fs, h))
        ck.add(mp_ + "shared_expert.up_proj.weight", (fs, h))
        ck.add(mp_ + "shared_expert.down_proj.weight", (h, fs))
        ck.add(mp_ + "shared_expert_gate.weight", (1, h))
    ck.add("model.norm.weight", (h,), 0.1)
    ck.add("lm_head.weight", (c["vocab_size"], h))
    ck.flush()


def run_hf_qwen_next(torch, qn, loader, build, gpu, f32_paths=None):
    """Phase 18 (c): Qwen3-Next at Qwen3-Next-80B-A3B's published widths, 4
    of 48 layers, a bf16 checkpoint -> load_qwen_next -> quantize_qwen_weights
    -> decode_step_q: 8 greedy steps at batch 128 over 256..383 cached tokens
    on 128-token pages (phase 7's traffic), exact launches a step (K10 at head
    dim 256 among them), a repeat from the same state bit-identical, the
    first step's logits against the same step under SKT_IMPL=ref within
    calc_diff EPM_DIFF. `f32_paths(cfg, params)`, when given, runs on the
    loaded f32 tree before it is quantised (phase 19 (a) and (b)). Returns
    the launch counts of the run."""
    with _Checkpoint(torch, "qwen_next", QWEN_NEXT_HF, 38) as ck:
        _draw_qwen_next(ck, QWEN_NEXT_HF)
        torch.cuda.empty_cache()
        timings = {}
        t0 = time.perf_counter()
        cfg, params = loader.load_qwen_next(ck.path, "cuda", timings=timings)
        cfg = dataclasses.replace(cfg, page_size=128)    # phase 7's pages
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if f32_paths is not None:
            f32_paths(cfg, params)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        params = qn.quantize_qwen_weights(params, cfg)
        torch.cuda.synchronize()
        print(f"  (c) Qwen3-Next checkpoint: {ck.nbytes / 1e9:.2f} GB bf16 in {ck.files} files, "
              f"write {ck.seconds:.1f} s; load_qwen_next {load_s:.1f} s (the seed-0 "
              f"template's draw {timings['template_s']:.1f} s, the rest "
              f"{timings['load_s']:.1f} s), quantize_qwen_weights {time.perf_counter() - t1:.1f}"
              f" s; cfg: {cfg.num_gdn_layers} GDN + {cfg.num_attn_layers} attention layers, head "
              f"dim {cfg.head_dim}, {cfg.num_experts} experts top-{cfg.top_k}")
    b, ps, steps = QWEN_NEXT_B, cfg.page_size, QWEN_NEXT_STEPS
    mp = -(-(384 + steps) // ps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    state = _qwen_state(torch, qn, cfg, b, b * mp + 1, gen, "cuda")
    pos0 = torch.randint(256, 384, (b,), generator=gen, device="cuda", dtype=torch.int32)
    ids0 = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    bt = torch.arange(1, b * mp + 1, dtype=torch.int32, device="cuda").reshape(b, mp)
    rows = torch.arange(b, device="cuda")
    snap = {k: v.clone() for k, v in state.items()}

    def step(ids, pos):
        slots = bt[rows, pos // ps] * ps + pos % ps
        return qn.decode_step_q(params, cfg, state, ids, pos, pos + 1, bt, slots)[0]

    def run():
        ids, pos, toks, first = ids0, pos0, [], None
        for _ in range(steps):
            logits = step(ids, pos)
            first = logits if first is None else first
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("(c) logits are not finite")
            ids = torch.argmax(logits, -1).to(torch.int32)
            toks.append(ids)
            pos = pos + 1
        return torch.stack(toks), first

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, first = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = dict(build.launches)
    for name, n in launches.items():
        if n != QWEN_NEXT_PER_STEP.get(name, 0) * steps:
            raise AssertionError(f"(c) {name} launched {n} times in {steps} steps, not "
                                 f"{QWEN_NEXT_PER_STEP.get(name, 0)} a step")
    for k, v in snap.items():
        state[k].copy_(v)
    toks2, first2 = run()
    if not (torch.equal(toks, toks2) and torch.equal(first, first2)):
        raise AssertionError("(c) a second run from the same state differs")
    for k, v in snap.items():
        state[k].copy_(v)
    with _env(SKT_IMPL="ref"):
        plain = step(ids0, pos0)
    diff = _calc_diff(first, plain)
    if not diff < EPM_DIFF:
        raise AssertionError(f"(c) step 1 against SKT_IMPL=ref: calc_diff {diff}")
    print(f"  (c) decode_step_q B={b}, 256..383 cached, ps {ps}: {steps} greedy steps, "
          f"{ms:.3f} ms a step (host clock, first run), launches a step "
          f"{QWEN_NEXT_PER_STEP}, repeat bit-identical; step 1 against SKT_IMPL=ref calc_diff "
          f"{diff:.3g} (bar {EPM_DIFF}) [{gpu}]")
    for k, v in snap.items():
        state[k].copy_(v)
    profile_step(torch, lambda: step(ids0, pos0), _QWEN_NEXT_BUCKETS,
                 "Qwen3-Next step (B=128, published widths, 4 layers)")
    return launches


# ---------------------- phase 19: Qwen3-Next's f32 paths and the GDN / conv surface

# launches of one f32 decode_step step at phase 18 (c)'s 4 layers: K9 on the
# f32 pool a GDN layer, K10 at head dim 256 the attention layer; every
# product is torch.matmul
QWEN_F32_PER_STEP = {"gdn_recurrent": 3, "decode_hm256": 1}
_QWEN_F32_BUCKETS = (("K9 gdn_recurrent (f32 pool)", ("gdn_recurrent_kernel",)),
                     ("K10 decode_hm256", ("decode_hm256_kernel",)),
                     ("memsets", ("Memset",)))
# calc_diff of an f32 step against the same step under SKT_IMPL=ref: K9's
# f32 sums in another order and K10's bf16 output an ulp apart, carried
# through f32 products
QWEN_F32_DIFF = 1e-4
# (b): forward_full against decode_step fed a token at a time (its attention
# reads bf16 pages), the bar of tests/test_qwen_loader.py; the chunked GDN's
# final state against K9's f32 pool after T steps (f32 sums in other orders)
QWEN_FULL_DIFF = 1e-3
QWEN_STATE_DIFF = 1e-5
# (b): where a token's top-k route first differs between the two paths,
# its k-th and (k+1)-th router probabilities must sit within this many
# times the largest difference the two paths' probabilities show on the
# tokens whose routes agree in that layer (a near tie, not a fault)
ROUTE_TIE = 2.0
QWEN_FULL_B, QWEN_FULL_T = 2, 192


def _qwen_f32_decode(torch, qn, build, cfg, params, gpu):
    """(a) decode_step on the f32 tree at phase 18 (c)'s traffic: 8 greedy
    steps at batch 128 over 256..383 cached tokens on 128-token pages, the
    generator seed of (c), an f32 SSM pool; exact launches a step, a repeat
    bit-identical, step 1 against SKT_IMPL=ref within QWEN_F32_DIFF, then
    the device split. Returns the launch counts of the run."""
    b, ps, steps = QWEN_NEXT_B, cfg.page_size, QWEN_NEXT_STEPS
    mp = -(-(384 + steps) // ps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    state = _qwen_state(torch, qn, cfg, b, b * mp + 1, gen, "cuda", ssm_dtype=torch.float32)
    pos0 = torch.randint(256, 384, (b,), generator=gen, device="cuda", dtype=torch.int32)
    ids0 = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    bt = torch.arange(1, b * mp + 1, dtype=torch.int32, device="cuda").reshape(b, mp)
    rows = torch.arange(b, device="cuda")
    snap = {k: v.clone() for k, v in state.items()}

    def step(ids, pos):
        slots = bt[rows, pos // ps] * ps + pos % ps
        return qn.decode_step(params, cfg, state, ids, pos, pos + 1, bt, slots)[0]

    def run():
        ids, pos, toks, first = ids0, pos0, [], None
        for _ in range(steps):
            logits = step(ids, pos)
            first = logits if first is None else first
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("19 (a) logits are not finite")
            ids = torch.argmax(logits, -1).to(torch.int32)
            toks.append(ids)
            pos = pos + 1
        return torch.stack(toks), first

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, first = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = dict(build.launches)
    for name, n in launches.items():
        if n != QWEN_F32_PER_STEP.get(name, 0) * steps:
            raise AssertionError(f"19 (a) {name} launched {n} times in {steps} steps, not "
                                 f"{QWEN_F32_PER_STEP.get(name, 0)} a step")
    for k, v in snap.items():
        state[k].copy_(v)
    toks2, first2 = run()
    if not (torch.equal(toks, toks2) and torch.equal(first, first2)):
        raise AssertionError("19 (a) a second run from the same state differs")
    for k, v in snap.items():
        state[k].copy_(v)
    with _env(SKT_IMPL="ref"):
        plain = step(ids0, pos0)
    diff = _calc_diff(first, plain)
    if not diff < QWEN_F32_DIFF:
        raise AssertionError(f"19 (a) step 1 against SKT_IMPL=ref: calc_diff {diff}")
    print(f"  19 (a) f32 decode_step B={b}, 256..383 cached, ps {ps}, f32 SSM pool: {steps} "
          f"greedy steps, {ms:.3f} ms a step (host clock, first run), launches a step "
          f"{QWEN_F32_PER_STEP} and nothing else, repeat bit-identical; step 1 against "
          f"SKT_IMPL=ref calc_diff {diff:.3g} (bar {QWEN_F32_DIFF}) [{gpu}]")
    for k, v in snap.items():
        state[k].copy_(v)
    profile_step(torch, lambda: step(ids0, pos0), _QWEN_F32_BUCKETS,
                 "19 (a) f32 Qwen3-Next step (B=128, published widths, 4 layers)")
    return launches


def _routes_of(torch, qn, fn):
    """Run fn() with every _moe_mlp call's router probabilities recorded:
    (fn's result, [probs [T, E] per call, in call order])."""
    seen, orig = [], qn._moe_mlp

    def spy(x, p, cfg):
        seen.append(torch.softmax((x @ p["router"]).float(), dim=-1))
        return orig(x, p, cfg)
    qn._moe_mlp = spy
    try:
        return fn(), seen
    finally:
        qn._moe_mlp = orig


def _route_swaps(torch, full_routes, dec_routes, b, t, nl, k):
    """Compare forward_full's router probabilities (full_routes[l] [B * T, E],
    b-major) with decode_step's (dec_routes[ti * nl + l] [B, E]). Returns
    (swapped [B, T]: the position's top-k set differs in some layer, ratio):
    at each swapped position's first differing layer, the gap between the
    k-th and (k+1)-th probability (forward_full's) over the largest
    |full - decode| probability difference on that layer's agreeing
    tokens; ratio is the largest such quotient (0 when nothing swaps)."""
    swapped = torch.zeros((b, t), dtype=torch.bool, device=full_routes[0].device)
    ratio = 0.0
    for li in range(nl):
        pf = full_routes[li].reshape(b, t, -1)
        pd = torch.stack([dec_routes[ti * nl + li] for ti in range(t)], 1)
        top_f = torch.sort(torch.topk(pf, k, dim=-1).indices, -1).values
        top_d = torch.sort(torch.topk(pd, k, dim=-1).indices, -1).values
        differ = (top_f != top_d).any(-1)
        first = differ & ~swapped
        if bool(first.any()):
            agree = ~differ & ~swapped
            spread = float((pf - pd).abs().amax(-1)[agree].max()) if bool(agree.any()) else 0.0
            srt = torch.sort(pf, -1, descending=True).values
            gap = float((srt[..., k - 1] - srt[..., k])[first].max())
            ratio = max(ratio, gap / spread if spread > 0 else float("inf"))
        swapped |= differ
    return swapped, ratio


def _qwen_f32_full(torch, qn, build, cfg, params, gpu):
    """(b) forward_full at B 2, T 192 (three chunks of 64) against
    decode_step fed the same tokens a token at a time from an empty state,
    and prefill_gdn_layer's final state of GDN layer 0 against that run's
    SSM pool rows after T steps (QWEN_STATE_DIFF): the chunked GDN against
    K9 on the f32 pool. The logits are held within QWEN_FULL_DIFF as a whole
    and at every position but those where the two paths route the token to
    other top-k experts in some layer (_route_swaps): the random router
    puts a token's k-th and (k+1)-th probabilities close enough, now and
    then, that the two paths' differences (decode_step reads bf16 pages)
    swap them, and a swapped expert changes the token's output outright."""
    b, t, ps = QWEN_FULL_B, QWEN_FULL_T, cfg.page_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    ids = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device="cuda",
                        dtype=torch.int32)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = qn.forward_full(params, cfg, ids)
    torch.cuda.synchronize()
    full_ms = 1e3 * (time.perf_counter() - t0)
    again, full_routes = _routes_of(torch, qn, lambda: qn.forward_full(params, cfg, ids))
    if not torch.equal(again, full):
        raise AssertionError("19 (b) a second forward_full differs")
    x0 = params["embed"][ids.long()]
    t0 = time.perf_counter()
    _, final = qn.prefill_gdn_layer(params, cfg, x0, 0)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    if any(build.launches.values()):
        raise AssertionError(f"19 (b) forward_full launched kernels: "
                             f"{ {k: n for k, n in build.launches.items() if n} }")
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("19 (b) forward_full's logits are not finite")
    mp = -(-t // ps)
    state = qn.init_state(cfg, b, b * mp + 1, device="cuda")
    bt = torch.arange(1, b * mp + 1, dtype=torch.int32, device="cuda").reshape(b, mp)
    rows = torch.arange(b, device="cuda")

    def decode_all():
        out = []
        for ti in range(t):
            pos = torch.full((b,), ti, dtype=torch.int32, device="cuda")
            slots = bt[rows, pos // ps] * ps + pos % ps
            out.append(qn.decode_step(params, cfg, state, ids[:, ti], pos, pos + 1, bt,
                                      slots)[0])
        return torch.stack(out, 1)
    t0 = time.perf_counter()
    dec, dec_routes = _routes_of(torch, qn, decode_all)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    for name, n in build.launches.items():
        if n != QWEN_F32_PER_STEP.get(name, 0) * t:
            raise AssertionError(f"19 (b) {name} launched {n} times in {t} decode steps")
    swapped, ratio = _route_swaps(torch, full_routes, dec_routes, b, t, cfg.num_layers,
                                  cfg.top_k)
    pos_diff = torch.tensor([[_calc_diff(full[bi, i], dec[bi, i]) for i in range(t)]
                             for bi in range(b)])
    kept = pos_diff[~swapped.cpu()]
    diff = _calc_diff(full, dec)
    worst_kept = float(kept.max()) if kept.numel() else 0.0
    worst_swapped = float(pos_diff[swapped.cpu()].max()) if bool(swapped.any()) else 0.0
    sdiff = _calc_diff(final, state["ssm"][0])
    serr = float((final - state["ssm"][0]).abs().max() / final.abs().max())
    if not (diff < QWEN_FULL_DIFF and worst_kept < QWEN_FULL_DIFF and ratio <= ROUTE_TIE
            and sdiff < QWEN_STATE_DIFF):
        raise AssertionError(
            f"19 (b) forward_full against decode_step: calc_diff {diff} (worst position "
            f"without a swapped route {worst_kept}; {int(swapped.sum())} positions with one, "
            f"worst {worst_swapped}, gap ratio {ratio}); GDN layer 0 final state against "
            f"the pool: calc_diff {sdiff}")
    print(f"  19 (b) forward_full B={b} T={t} (chunks of {cfg.chunk_size}) {full_ms:.1f} ms, "
          f"prefill_gdn_layer {prefill_ms:.1f} ms (host clock, first calls, no kernel "
          f"launched; a second call, routes recorded, bit-identical); decode_step a token at "
          f"a time from an empty state, routes recorded, {dec_s:.2f} s ({1e3 * dec_s / t:.2f} "
          f"ms a step, K9 and K10 exact); logits calc_diff {diff:.3g} "
          f"(bar {QWEN_FULL_DIFF}), worst position {worst_kept:.3g} over the {kept.numel()} "
          f"positions whose routes agree (bar {QWEN_FULL_DIFF}); {int(swapped.sum())} "
          f"positions with a swapped top-{cfg.top_k} route in some layer, worst "
          f"{worst_swapped:.3g} (each a near tie where its route first swaps: its gap at most "
          f"{ratio:.3g} of the paths' largest probability difference on unswapped tokens, "
          f"bar {ROUTE_TIE}); GDN layer 0's chunked final state against K9's f32 pool rows "
          f"after {t} steps: calc_diff {sdiff:.3g} (bar {QWEN_STATE_DIFF}), max-abs "
          f"{serr:.3g} of max [{gpu}]")


def run_qwen_f32(torch, qn, build, cfg, params, gpu):
    """Phase 19 (a) and (b) on phase 18 (c)'s f32 tree (Qwen3-Next-80B-A3B's
    widths, 4 of 48 layers, loaded from its bf16 checkpoint), before it is
    quantised. Prints each part's seconds and the peak device memory.
    Returns (a)'s launch counts."""
    prec, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    print(f"  19: f32 matmul precision {prec!r}, allow_tf32 {tf32}")
    if prec != "highest" or tf32:
        raise AssertionError("19: the f32 paths need full-f32 matmuls (TF32 is on)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches = _qwen_f32_decode(torch, qn, build, cfg, params, gpu)
    print(f"  19 (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _qwen_f32_full(torch, qn, build, cfg, params, gpu)
    print(f"  19 (b) {time.perf_counter() - t0:.1f} s; peak device memory of (a) and (b) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the f32 tree included)")
    return launches


# (c) bench.py --config qwen --smoke (bench.py:507-510): the default
# QwenNextConfig, batch 4, context 64, 4 steps a call, a warm call and 2
# more; launches of a decode_step_q step there: K1 wqkvz + wo a GDN layer,
# wq, wk, wv, wo the attention layer, the shared w13 + w2 a layer, lm_head;
# K8 two a layer; K9 at D 32 a GDN layer; the attention at head dim 32 is
# decode_gqa's plain version, as in the JAX package
QWEN_SMOKE_B, QWEN_SMOKE_CTX, QWEN_SMOKE_STEPS = 4, 64, 12
QWEN_SMOKE_PER_STEP_Q = {"w8a8_gemm_tiled": 19, "w8a8_gemm_grouped": 8, "gdn_recurrent": 3}
QWEN_SMOKE_PER_STEP = {"gdn_recurrent": 3}          # decode_step: K9 alone
QWEN_SMOKE_LORA = (0, 1, -1, 1)


def run_qwen_default(torch, qn, build, gpu):
    """Phase 19 (c): decode_step on an f32 pool (init_params, seed 0) and
    decode_step_q on a bf16 and on an f32 pool (init_params_q, seed 0), each
    with lora_indices over the config's 2 adapters, from a seeded random
    state: 12 greedy steps, exact launches a step (K9 at D 32), a repeat
    bit-identical, step 1 against SKT_IMPL=ref (QWEN_F32_DIFF for the f32
    step, EPM_DIFF for the int8 one). Returns {variant: launch counts}."""
    cfg = qn.QwenNextConfig()
    b, ctx, steps, ps = QWEN_SMOKE_B, QWEN_SMOKE_CTX, QWEN_SMOKE_STEPS, cfg.page_size
    mp = -(-(ctx + steps) // ps)
    pages = b * mp + 1
    rng = np.random.default_rng(0)
    bt = torch.from_numpy((rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1)
                          .astype(np.int32)).cuda()
    ids0 = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).cuda()
    pos0 = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    lora = torch.tensor(QWEN_SMOKE_LORA, dtype=torch.int32, device="cuda")
    rows = torch.arange(b, device="cuda")
    p32, pq = qn.init_params(cfg, 0, "cuda"), qn.init_params_q(cfg, 0, "cuda")
    out = {}
    for label, fn, params, dtype, per_step, bar in (
            ("decode_step, f32 pool", qn.decode_step, p32, torch.float32,
             QWEN_SMOKE_PER_STEP, QWEN_F32_DIFF),
            ("decode_step_q, bf16 pool", qn.decode_step_q, pq, torch.bfloat16,
             QWEN_SMOKE_PER_STEP_Q, EPM_DIFF),
            ("decode_step_q, f32 pool", qn.decode_step_q, pq, torch.float32,
             QWEN_SMOKE_PER_STEP_Q, EPM_DIFF)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        state = _qwen_state(torch, qn, cfg, b, pages, gen, "cuda", ssm_dtype=dtype)
        snap = {k: v.clone() for k, v in state.items()}

        def step(ids, pos, fn=fn, params=params, state=state):
            slots = bt[rows, pos // ps] * ps + pos % ps
            return fn(params, cfg, state, ids, pos, pos + 1, bt, slots, lora_indices=lora)[0]

        def run(step=step):
            ids, pos, toks, first = ids0, pos0, [], None
            for _ in range(steps):
                logits = step(ids, pos)
                first = logits if first is None else first
                ids = torch.argmax(logits, -1).to(torch.int32)
                toks.append(ids)
                pos = pos + 1
            return torch.stack(toks), first

        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, first = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        launches = dict(build.launches)
        for name, n in launches.items():
            if n != per_step.get(name, 0) * steps:
                raise AssertionError(f"19 (c) {label}: {name} launched {n} times in {steps} "
                                     f"steps, not {per_step.get(name, 0)} a step")
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"19 (c) {label}: logits are not finite")
        for k, v in snap.items():
            state[k].copy_(v)
        toks2, first2 = run()
        if not (torch.equal(toks, toks2) and torch.equal(first, first2)):
            raise AssertionError(f"19 (c) {label}: a second run from the same state differs")
        for k, v in snap.items():
            state[k].copy_(v)
        with _env(SKT_IMPL="ref"):
            plain = step(ids0, pos0)
        diff = _calc_diff(first, plain)
        if not diff < bar:
            raise AssertionError(f"19 (c) {label}: step 1 against SKT_IMPL=ref calc_diff {diff}")
        print(f"  19 (c) {label}, lora_indices {list(QWEN_SMOKE_LORA)}: B={b}, context {ctx}, "
              f"{steps} greedy steps, {ms:.3f} ms a step (host clock), launches a step "
              f"{per_step} and nothing else, repeat bit-identical; step 1 against "
              f"SKT_IMPL=ref calc_diff {diff:.3g} (bar {bar}) [{gpu}]")
        out[label] = launches
    return out


# (d) the card against the CPU on the same inputs: copies and the conv's
# ordered f32 taps exact but for the activation (CUDA's and the CPU's exp
# differ in the last bits); the chunked and recurrent rules and the
# per-head RMSNorm + RoPE: f32 products in other orders; share of max|cpu|
SURFACE_SHARE = {"copy": 0.0, "conv": 1e-5, "chunk": 1e-4, "recurrent": 1e-5, "qkv": 1e-5}


def _surface_check(torch, name, kind, got, ref):
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    worst = 0.0
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        g, r = g.float().cpu(), r.float()
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"19 (d) {name}: shape {tuple(g.shape)} / {tuple(r.shape)} "
                                 f"or not finite")
        err = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        if not err <= SURFACE_SHARE[kind]:
            raise AssertionError(f"19 (d) {name}: max-abs {err:.3g} of max|cpu| (bar "
                                 f"{SURFACE_SHARE[kind]})")
        worst = max(worst, err)
    return worst


def run_gdn_surface(torch, build, gpu):
    """Phase 19 (d): the speculative and varlen surface at Qwen3-Next-80B-A3B's
    GDN widths (conv dim 8192, 32 v-heads of 128 over 16 qk heads) and the
    five qkv_fusion functions at its attention widths (16 query and 2 kv
    heads of 256, rotary 64; fused_split_qk_norm at DeepSeek-V3's MLA split
    of 1536 | 512 | 64), each run once on CUDA tensors and held against the
    same call on CPU copies (SURFACE_SHARE). No kernel runs here: the
    counters stay 0."""
    from sgl_kernel_npu_tpu_torch.ops import gdn, mamba, qkv_fusion as qf
    gen = torch.Generator()
    gen.manual_seed(191)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen) * s

    def both(fn, *args, **kw):
        """fn on CUDA copies of the tensor arguments (then synchronised) and
        on the CPU originals; in-place results compared as returned."""
        cuda = [a.to("cuda", copy=True) if isinstance(a, torch.Tensor) else a for a in args]
        ckw = {k: v.to("cuda", copy=True) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        got = fn(*cuda, **ckw)
        torch.cuda.synchronize()
        return got, fn(*[a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                       **{k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in kw.items()})

    hk, hv, d, dim, w = 16, 32, 128, 8192, 4
    lens = torch.tensor([37, 300, 128, 191])
    cu = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(lens, 0)]).to(torch.int32)
    total = int(cu[-1])
    build.reset_launches()
    t0 = time.perf_counter()
    res = {}
    cw, cb = rn(dim, w, s=0.2), rn(dim, s=0.1)
    g1 = both(mamba.causal_conv1d_fn, rn(4, dim, 300), cw, cb, rn(4, dim, w - 1),
              return_final_states=True, seqlens=lens.to(torch.int32))
    res["causal_conv1d_fn"] = _surface_check(torch, "causal_conv1d_fn", "conv", *g1)
    res["causal_conv1d_fn final states"] = _surface_check(torch, "final", "copy", g1[0][1],
                                                          g1[1][1])
    g2 = both(mamba.causal_conv1d_varlen, rn(dim, total), cu, cw, cb,
              conv_states=rn(6, dim, w - 1), cache_indices=torch.tensor([5, 0, 3, 2]),
              has_initial_state=torch.tensor([True, False, True, True]), max_seq_len=300)
    res["causal_conv1d_varlen"] = _surface_check(torch, "causal_conv1d_varlen", "conv",
                                                 g2[0][0], g2[1][0])
    res["causal_conv1d_varlen final states"] = _surface_check(torch, "varlen final", "copy",
                                                              g2[0][1], g2[1][1])
    q, k = rn(1, total, hk, d), rn(1, total, hk, d)
    g3 = both(gdn.chunk_gated_delta_rule_varlen, q, k, rn(1, total, hv, d),
              -0.3 * rn(1, total, hv).abs(), torch.sigmoid(rn(1, total, hv)), cu,
              rn(4, hv, d, d, s=0.1), max_seq_len=300, chunk_size=64)
    res["chunk_gated_delta_rule_varlen"] = _surface_check(torch, "chunk varlen", "chunk",
                                                          *g3)
    nseq, draft = 8, 4
    t = nseq * draft
    slots_line = torch.arange(nseq) * draft
    ssm_idx = (slots_line[:, None] + torch.arange(draft)[None, :]).reshape(-1).to(torch.int32)
    g4 = both(gdn.recurrent_gated_delta_rule, rn(t, 2 * hk * d + hv * d),
              rn(16, hv, d, d, s=0.1), rn(t, hv), None,
              torch.full((nseq,), draft, dtype=torch.int32), ssm_idx, hk, hv,
              intermediate_state=rn(nseq, draft, hv, d, d, s=0.1),
              cache_indices=torch.arange(nseq, dtype=torch.int32),
              num_accepted_tokens=torch.tensor([1, 2, 3, 4, 4, 3, 2, 1], dtype=torch.int32),
              g=-0.3 * rn(t, hv).abs())
    res["recurrent_gated_delta_rule"] = _surface_check(torch, "recurrent", "recurrent", *g4)
    ci = torch.tensor([3, 9, -1, 0, 15, 7, 2, 11], dtype=torch.int32)
    g5 = both(mamba.causal_conv1d_update, rn(8, dim, draft), rn(16, dim, w - 1), cw, cb,
              activation="silu", conv_state_indices=ci,
              intermediate_conv_window=torch.zeros(8, draft, dim, w - 1))
    res["causal_conv1d_update [B, dim, S]"] = _surface_check(torch, "conv update", "conv",
                                                             g5[0][0], g5[1][0])
    res["causal_conv1d_update state, windows"] = _surface_check(
        torch, "conv update state", "copy", g5[0][1:], g5[1][1:])
    g6 = both(mamba.conv_state_rollback, rn(3, 16, w - 1, dim), ci.clamp_min(0),
              torch.tensor([0, 3, -1, 1, 2, 0, 3, 1], dtype=torch.int32), draft)
    res["conv_state_rollback"] = _surface_check(torch, "rollback", "copy", *g6)
    g7 = both(mamba.move_intermediate_cache, rn(3, 16, hv, d, d), rn(3, nseq, draft, hv, d, d),
              torch.tensor([4, 12, 0], dtype=torch.int32),
              torch.tensor([7, 0, 3], dtype=torch.int32),
              torch.tensor([3, 0, 2], dtype=torch.int32))
    res["move_intermediate_cache"] = _surface_check(torch, "move", "copy", *g7)
    nq, nkv, ad, rd, b = 16, 2, 256, 64, 128
    ang = torch.rand(b, rd // 2, generator=gen) * 3
    sin, cos = torch.sin(ang).repeat(1, 2), torch.cos(ang).repeat(1, 2)
    qw, kw = 1 + rn(ad, s=0.1), 1 + rn(ad, s=0.1)
    x = rn(b, (nq + 2 * nkv) * ad)
    for neox in (True, False):
        tag = "neox" if neox else "interleaved"
        res[f"split_qkv_rmsnorm_rope {tag}"] = _surface_check(
            torch, "split_qkv_rmsnorm_rope", "qkv",
            *both(qf.split_qkv_rmsnorm_rope, x, sin, cos, nq * ad, nkv * ad, ad, 1e-6, qw, kw,
                  is_neox_style=neox))
        res[f"split_qkv_rmsnorm_rope_pos_cache {tag}"] = _surface_check(
            torch, "pos_cache", "qkv",
            *both(qf.split_qkv_rmsnorm_rope_pos_cache, x,
                  torch.randint(0, 4096, (b,), generator=gen),
                  torch.cat([torch.cos(ang.repeat(32, 1)), torch.sin(ang.repeat(32, 1))], -1),
                  nq * ad, nkv * ad, ad, 1e-6, qw, kw, is_neox_style=neox))
        res[f"split_qkv_tp_rmsnorm_rope {tag}"] = _surface_check(
            torch, "tp", "qkv",
            *both(qf.split_qkv_tp_rmsnorm_rope, x[:, : (nq + 2 * nkv) * ad // 2], sin, cos, nq,
                  nkv, ad, tp_rank=1, tp_size=2, eps=1e-6, q_weight=qw, k_weight=kw,
                  is_neox_style=neox))
    res["fused_split_qk_norm"] = _surface_check(
        torch, "fused_split_qk_norm", "qkv",
        *both(qf.fused_split_qk_norm, rn(b, 1536 + 512 + 64), 1 + rn(1536, s=0.1),
              1 + rn(512, s=0.1), 1536, 512, 64))
    res["split_qkvgate_gemma_rmsnorm_rope"] = _surface_check(
        torch, "gemma", "qkv",
        *both(qf.split_qkvgate_gemma_rmsnorm_rope, rn(b, 2 * nq * ad + 2 * nkv * ad), sin, cos,
              nq * ad, nkv * ad, ad, rd, 1e-6, rn(ad, s=0.1), rn(ad, s=0.1)))
    if any(build.launches.values()):
        raise AssertionError(f"19 (d) kernels launched: "
                             f"{ {k: n for k, n in build.launches.items() if n} }")
    print(f"  19 (d) the GDN / conv / qkv_fusion surface on the card against CPU copies, "
          f"{time.perf_counter() - t0:.1f} s, no kernel launched (every counter 0); max-abs "
          "error as a share of max|cpu| (bars " + ", ".join(f"{k} {v:g}" for k, v in
                                                           SURFACE_SHARE.items()) + "): "
          + "; ".join(f"{k} {v:.3g}" for k, v in res.items()) + f" [{gpu}]")


def run_hf_moe_bank(torch, par, loader, build, gpu):
    """Phase 18 (d): DeepSeek-V3's expert names for phase 8's layer (8
    experts of 7168 / 2048 and a shared expert), load_moe_expert_bank, then
    phase 8's pallas_fused and rounds=1 calls on the loaded bank: exact
    launches, a repeat bit-identical, within MOE_LAYER_DIFF of the same call
    under SKT_IMPL=ref, pallas_fused within the tier bound of rounds=1."""
    el, h, f = MOE_EL, MOE_H, MOE_F
    with _Checkpoint(torch, "moe_bank", {"architectures": ["DeepseekV3ForCausalLM"]}, 48) as ck:
        p = "model.layers.0.mlp."
        for j in range(el):
            ck.add(f"{p}experts.{j}.gate_proj.weight", (f, h))
            ck.add(f"{p}experts.{j}.up_proj.weight", (f, h))
            ck.add(f"{p}experts.{j}.down_proj.weight", (h, f))
        ck.add(p + "gate.weight", (el, h))
        for name, shape in (("gate_proj", (f, h)), ("up_proj", (f, h)), ("down_proj", (h, f))):
            ck.add(f"{p}shared_experts.{name}.weight", shape)
        ck.flush()
        t0 = time.perf_counter()
        bank = loader.load_moe_expert_bank(ck.path, 1, el, "cuda")
        torch.cuda.synchronize()
        print(f"  (d) MoE bank checkpoint: {ck.nbytes / 1e9:.2f} GB bf16, write "
              f"{ck.seconds:.1f} s, load_moe_expert_bank {time.perf_counter() - t0:.1f} s; "
              f"router {tuple(bank['router'].shape)}, shared w13 "
              f"{tuple(bank['shared_w13'].shape)}")
    data = moe_bench_data(torch)[:3] + [bank["w13"]["q"][0], bank["w13"]["scale"][0],
                                        bank["w2"]["q"][0], bank["w2"]["scale"][0]]
    calls = {k: v for k, v in moe_variants(torch, par, data).items()
             if k in ("rounds=1", "pallas_fused")}
    build.reset_launches()
    outs = {}
    for name, fn in calls.items():
        before = dict(build.launches)
        outs[name] = fn()
        delta = {k: v - before[k] for k, v in build.launches.items() if v != before[k]}
        if delta != MOE_VARIANTS[name]:
            raise AssertionError(f"(d) {name}: launches {delta}, not {MOE_VARIANTS[name]}")
        if not torch.equal(fn(), outs[name]) or not bool(torch.isfinite(outs[name]).all()):
            raise AssertionError(f"(d) {name}: not finite, or a second call differs")
    launches = dict(build.launches)
    with _env(SKT_IMPL="ref"):
        diffs = {name: _calc_diff(outs[name], fn()) for name, fn in calls.items()}
    share = _tier_share(outs["pallas_fused"], outs["rounds=1"])
    if not all(d < MOE_LAYER_DIFF for d in diffs.values()) or share > 1.0:
        raise AssertionError(f"(d) calc_diff against the plain runs {diffs}, tier share {share}")
    print(f"  (d) phase 8's calls on the loaded bank: launches "
          f"{ {k: MOE_VARIANTS[k] for k in calls} } each, repeats identical, calc_diff against "
          f"SKT_IMPL=ref { {k: float(f'{d:.3g}') for k, d in diffs.items()} } (bar "
          f"{MOE_LAYER_DIFF}), pallas_fused {share:.3f} of the tier bound of rounds=1 [{gpu}]")
    return launches


# (f): launches of one tm2 decode step at Llama-3-8B's 32 layers by route
K2_ROUTES = {
    "off": {"w8a8_gemm_tiled": 65, "rmsq_gemm": 64, "decode_tm2": 32, "append_tm2": 1},
    "SKT_FUSED_LM=1": {"w8a8_gemm_tiled": 64, "rmsq_gemm": 65, "decode_tm2": 32,
                       "append_tm2": 1},
    "SKT_FUSED_LM=1 SKT_FUSED_QGEMM=1": {"rmsq_gemm": 129, "decode_tm2": 32, "append_tm2": 1},
}
K2_ROUTE_STEPS, K2_ROUTE_DIFF = 4, 8e-3


def run_k2_routes(torch, llama, build, params, gpu):
    """Phase 18 (f): phase 4's decode path (tm2 pages of 512, batch 128,
    context 256, pretiled banks) with the knobs off, SKT_FUSED_LM=1, then
    also SKT_FUSED_QGEMM=1, K2_ROUTE_STEPS steps each from the same seeded
    state fed the same ids: exact launches a step by route (lm_head K1 -> K2,
    then wo and w2 K1 -> K2), each step's logits within calc_diff
    K2_ROUTE_DIFF of the knobs-off step's. Returns {route: launches}."""
    cfg = llama.LlamaConfig(int8_kv=True, page_size=512)
    b, ps = BENCH_BATCH, cfg.page_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    num_pages = b + 1
    kv0 = llama.init_kv_cache(cfg, num_pages, layout="tm2", device="cuda")
    for name in ("k", "v"):
        kv0[name].copy_(torch.randint(-127, 128, kv0[name].shape, generator=gen,
                                      dtype=torch.int8, device="cuda"))
    for name in ("ks", "vs"):
        kv0[name].copy_(torch.rand(kv0[name].shape, generator=gen, device="cuda") * 0.02
                        + 0.001)
    bt = torch.arange(1, num_pages, dtype=torch.int32, device="cuda")[:, None]
    pos0 = torch.full((b,), BENCH_CTX - 1, dtype=torch.int32, device="cuda")
    ids = [torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda",
                         dtype=torch.int32) for _ in range(K2_ROUTE_STEPS)]
    rows = torch.arange(b, device="cuda")
    out, launches = {}, {}
    for route, flags in (("off", {}), ("SKT_FUSED_LM=1", {"SKT_FUSED_LM": "1"}),
                         ("SKT_FUSED_LM=1 SKT_FUSED_QGEMM=1",
                          {"SKT_FUSED_LM": "1", "SKT_FUSED_QGEMM": "1"})):
        kv = {k: v.clone() for k, v in kv0.items()}
        pos, logits = pos0, []
        build.reset_launches()
        with _env(**flags):
            for t in range(K2_ROUTE_STEPS):
                slots = bt[rows, pos // ps] * ps + pos % ps
                lg, kv = llama.decode_step_kv(params, cfg, kv, ids[t], pos, pos + 1, bt, slots)
                logits.append(lg)
                pos = pos + 1
            torch.cuda.synchronize()
            launches[route] = {k: n for k, n in build.launches.items() if n}
            want = {k: n * K2_ROUTE_STEPS for k, n in K2_ROUTES[route].items()}
            if launches[route] != want:
                raise AssertionError(f"(f) {route}: launches {launches[route]}, not {want}")
            t0 = time.perf_counter()
            for _ in range(3):
                llama.decode_step_kv(params, cfg, kv, ids[0], pos, pos + 1, bt,
                                     bt[rows, pos // ps] * ps + pos % ps)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 3
        out[route] = logits
        diffs = [_calc_diff(a, r) for a, r in zip(logits, out["off"])]
        if not all(d < K2_ROUTE_DIFF for d in diffs):
            raise AssertionError(f"(f) {route}: calc_diff against the knobs off {diffs}")
        print(f"  (f) {route}: launches a step {K2_ROUTES[route]}, calc_diff against the knobs "
              f"off {[float(f'{d:.3g}') for d in diffs]} (bar {K2_ROUTE_DIFF}), {ms:.3f} ms a "
              f"step (host clock) [{gpu}]")
    return launches


# ------------------------------------------------ phase 20: the last modules

# (a) scripts/accuracy_delta.py's two configs and seed (:24-68) and T, and
# ACCURACY.md's CPU-JAX row for each
ACC_CONFIGS = {
    "llama": (dict(vocab_size=4096, hidden_size=1024, num_layers=8, num_heads=8, num_kv_heads=4,
                   head_dim=128, intermediate_size=2816, page_size=128, max_position=2048), 512),
    "mla": (dict(vocab_size=4096, hidden_size=1024, num_layers=6, num_heads=8, kv_lora_rank=512,
                 qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128, q_lora_rank=768,
                 intermediate_size=2048, page_size=128, max_position=2048), 384),
}
ACC_SEED = 0
ACCURACY_MD = {
    "llama": dict(ppl_f32=5253.45, ppl_int8=5252.13, ppl_delta_pct=-0.03, kl_mean=0.0009,
                  kl_max=0.0014, greedy_agreement=0.852),
    "mla": dict(ppl_f32=4866.37, ppl_int8=4890.93, ppl_delta_pct=0.50, kl_mean=0.0017,
                kl_max=0.0034, greedy_agreement=0.846),
}
ACC_PPL_RTOL = 1e-3         # the card's f32 perplexity against ACCURACY.md's CPU-JAX one
# tests/test_accuracy_delta.py's gates: |ppl delta| <= 2 %, KL mean <= 0.02 (0.05 MLA)
ACC_GATES = {"llama": (2.0, 0.02), "mla": (2.0, 0.05)}
ACC_FULL_T, ACC_FULL_LAYERS = 512, 2
# (b) decode_mla_int8_ref over the int8 caches against K7 over the bf16 ones:
# the int8 codes of ctkv (per tensor) and q_nope (per head) carry about 2^-8
# of their range as error, which the attention averages
MLA_INT8_DIFF = 1e-3
# (c) openai/gpt-oss-120b's attention (config.json: num_attention_heads 64,
# num_key_value_heads 8, head_dim 64, sliding_window 128)
SINK_HQ, SINK_HKV, SINK_D, SINK_WINDOW = 64, 8, 64, 128
SINK_B, SINK_CTX, SINK_PS = 128, 4096, 128
SINK_PREFILL = (1000, 1100, 996, 1000)                # 4,096 tokens in 4 sequences
SINK_SHARE = 1e-4
# (d) deepseek-ai/DeepSeek-V3.2-Exp's indexer (config.json: index_n_heads 64,
# index_head_dim 128, index_topk 2048)
IDX_H, IDX_D, IDX_TOPK = 64, 128, 2048
IDX_SCORE_SHARE = 1e-5      # f32 scores against float64 ones, of max|score|


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _part(torch, dev, label, fn):
    """Run one part of phase 20; print its seconds and, on the card, its peak
    device memory. Returns fn's result."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    peak = (f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if dev.type == "cuda" else "")
    print(f"  20 ({label}) {time.perf_counter() - t0:.1f} s{peak}")
    return out


def _expect(dev, launches):
    """The launches a call must make: `launches` on the card, none on the
    CPU (plain versions)."""
    return launches if dev.type == "cuda" else {}


def _check_launches(name, delta, expect):
    got = {k: n for k, n in delta.items() if n}
    if got != expect:
        raise AssertionError(f"{name}: launches {got}, not {expect}")


def _acc_launches(kind, layers):
    """quant_delta's launches, all its prefill_step's: kernel A for each
    stacked GEMM of a layer (Llama wqkv, wo, w13, w2; MLA wo, w13, w2), A at
    L = 1 for lm_head, K2 per_tensor for MLA's two mla_preprocess stages."""
    if kind == "llama":
        return {"w8a8_gemm": 4 * layers, "w8a8_gemm_l1": 1}
    return {"rmsq_gemm_pt": 2 * layers, "w8a8_gemm": 3 * layers, "w8a8_gemm_l1": 1}


def _acc_line(label, m, ref=None):
    keys = ("ppl_f32", "ppl_int8", "ppl_delta_pct", "kl_mean", "kl_max", "greedy_agreement")
    cells = []
    for k in keys:
        cells.append(f"{k} {m[k]:.6g}" + (f" [{ref[k]:g}]" if ref else ""))
    print(f"    {label}: " + ", ".join(cells))


def run_quant_accuracy(torch, qr, llama, dm, build, mcfg, dev, configs=None, full=True):
    """Phase 20 (a): quant_ref.quant_delta, its f32 forward and the int8
    prefill_step on the same tokens,
    first at scripts/accuracy_delta.py's configs (each metric printed beside
    ACCURACY.md's CPU-JAX value in brackets; ppl_f32 within ACC_PPL_RTOL of
    it), then at Meta-Llama-3-8B's widths (LlamaConfig(), 32 -> 2 layers)
    and bench.py's DeepSeek-V2-Lite MlaConfig (27 -> 2 layers), T 512. Every
    row within tests/test_accuracy_delta.py's gates; every prefill's
    launches exactly A (and K2 for MLA). Returns the launches by row."""
    prec, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    print(f"  (a) f32 matmul precision {prec!r}, allow_tf32 {tf32}")
    if tf32 or prec != "highest":
        raise AssertionError("(a) needs f32 products in f32: TF32 is on")
    cfgs = {"llama": llama.LlamaConfig, "mla": dm.MlaConfig}
    rows = [(kind, f"{kind} (scripts/accuracy_delta.py, seed {ACC_SEED}, T {t})",
             cfgs[kind](**kw), t) for kind, (kw, t) in (configs or ACC_CONFIGS).items()]
    if full:
        rows += [("llama", f"llama at Meta-Llama-3-8B's widths, {ACC_FULL_LAYERS} of 32 layers, "
                  f"T {ACC_FULL_T}", llama.LlamaConfig(num_layers=ACC_FULL_LAYERS), ACC_FULL_T),
                 ("mla", f"mla at DeepSeek-V2-Lite's widths (bench.py), {ACC_FULL_LAYERS} of "
                  f"27 layers, T {ACC_FULL_T}",
                  dataclasses.replace(mcfg, num_layers=ACC_FULL_LAYERS), ACC_FULL_T)]
    launches = {}
    for i, (kind, label, cfg, t) in enumerate(rows):
        t0 = time.perf_counter()
        c = _Launches(build)
        m = qr.quant_delta(kind, cfg, t, ACC_SEED, dev)
        _sync(torch, dev)
        delta = c.delta()
        ref = ACCURACY_MD[kind] if i < 2 and configs is None else None
        _acc_line(f"{label} ({time.perf_counter() - t0:.1f} s)", m, ref)
        _check_launches(f"(a) {label}", delta, _expect(dev, _acc_launches(kind, cfg.num_layers)))
        if ref and not abs(m["ppl_f32"] / ref["ppl_f32"] - 1) <= ACC_PPL_RTOL:
            raise AssertionError(f"(a) {label}: ppl_f32 {m['ppl_f32']:.6g} is not within "
                                 f"{ACC_PPL_RTOL:g} of ACCURACY.md's {ref['ppl_f32']}")
        dppl, kl = ACC_GATES[kind]
        if not (abs(m["ppl_delta_pct"]) <= dppl and m["kl_mean"] <= kl):
            raise AssertionError(f"(a) {label}: ppl delta {m['ppl_delta_pct']:.4g} %, KL mean "
                                 f"{m['kl_mean']:.4g} outside the gates ({dppl} %, {kl})")
        launches[label] = delta
        print(f"      launches of the prefill: { {k: n for k, n in delta.items() if n} }")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return launches


def _mla_layer(torch, mcfg, gen, dev):
    """One seeded mla_preprocess layer at mcfg's widths in init_params'
    conventions (int8 weights, ones and zeros for the norms, the static
    quant scale 0.05), with descales that put q_pe, k_pe and the scores
    near 1, and the [in, out] copies that route both stages through K2.
    Returns the positional weights, the kn copies and the tail scalars."""
    h, hid = mcfg.num_heads, mcfg.hidden_size
    kn, kp, qn, qr = mcfg.kv_lora_rank, mcfg.qk_rope_dim, mcfg.qk_nope_dim, mcfg.q_lora_rank
    mm1, nq = kn + kp + qr, h * (qn + kp)

    def i8(*s):
        return torch.randint(-127, 128, s, generator=gen, dtype=torch.int8, device=dev)

    def full(n, v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=dev)

    wdqkv, wuq = i8(mm1, hid), i8(nq, qr)
    wuk = 0.05 * torch.randn((h, qn, kn), generator=gen, device=dev)
    weights = (full(hid, 1.0), full(hid, 0.0), wdqkv, full(mm1, 1e-5), full(qr, 1.0),
               full(qr, 0.0), wuq, full(nq, 1.7e-5), full(kn, 1.0))
    tail = (full(1, 0.05), full(1, 0.0), full(mm1, 0, torch.int32), full(1, 0.05),
            full(1, 0.0), full(nq, 0, torch.int32))
    return weights, wuk, tail, (wdqkv.t().contiguous(), wuq.t().contiguous())


def run_mla_cache_modes(torch, mp, dec, dm, build, mcfg, dev, b=128, ctx=256):
    """Phase 20 (b): mla_preprocess's cache modes at the MLA bench widths on
    one decode step of `b` sequences with `ctx` cached tokens (pages of
    mcfg.page_size; seeded rows of unit scale), both stages on K2: "full"'s
    combined cache and packed q bit-equal to "krope_ctkv"'s two caches and
    q joined; then "int8_nzcache" (ctkv_scale calibrated over the cached
    rows per tensor, q_nope_scale over this step's q_nope per head) through
    decode_mla_int8_ref, held within calc_diff MLA_INT8_DIFF of K7's
    decode_mla over the bf16 caches and within 1e-3 of max|out| of
    decode_mla_ref over the dequantised codes (the JAX test's check)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2002)
    kn, kp, ps, h = mcfg.kv_lora_rank, mcfg.qk_rope_dim, mcfg.page_size, mcfg.num_heads
    weights, wuk, tail, kn_w = _mla_layer(torch, mcfg, gen, dev)
    mpg = -(-(ctx + 1) // ps)
    pages = b * mpg + 1
    bt = (torch.randperm(pages - 1, generator=gen, device=dev)[: b * mpg].reshape(b, mpg)
          .to(torch.int32) + 1)
    slots = bt[:, ctx // ps].long() * ps + ctx % ps
    lens = torch.full((b,), ctx + 1, dtype=torch.int32, device=dev)
    cos, sin = dm.make_mla_cos_sin(mcfg, device=dev)
    cos, sin = cos[ctx].expand(b, kp).contiguous(), sin[ctx].expand(b, kp).contiguous()
    hidden = torch.randn((b, mcfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    hist_ckv = torch.randn((pages, ps, kn), generator=gen, device=dev)
    hist_kr = torch.randn((pages, ps, kp), generator=gen, device=dev)
    sm = (mcfg.qk_nope_dim + kp) ** -0.5

    def pre(kc, kr, mode, **kw):
        c = _Launches(build)
        out = mp.mla_preprocess(hidden, *weights, cos, sin, wuk, kc, kr, slots, *tail,
                                cache_mode=mode, wdqkv_kn=kn_w[0], wuq_kn=kn_w[1], **kw)
        _sync(torch, dev)
        _check_launches(f"(b) {mode}", c.delta(), _expect(dev, {"rmsq_gemm_pt": 2}))
        return out

    comb = torch.cat([hist_ckv, hist_kr], -1).to(torch.bfloat16)
    ckv, kr = hist_ckv.to(torch.bfloat16), hist_kr.to(torch.bfloat16)
    full = pre(comb, None, "full")
    split = pre(ckv, kr, "krope_ctkv")
    q_bf16 = torch.cat([split.q_nope, split.q_pe], -1)
    if not (torch.equal(comb, torch.cat([ckv, kr], -1)) and torch.equal(full.q_nope, q_bf16)
            and full.krope_cache is None):
        raise AssertionError("(b) full: the combined rows or the packed q differ from "
                             "krope_ctkv's joined")
    print(f"    full vs krope_ctkv (B {b}, {ctx} cached on pages of {ps}): combined cache and "
          f"packed q [{b}, {h}, {kn + kp}] bit-equal; launches rmsq_gemm_pt 2 a call")
    cs = hist_ckv.abs().amax() / 127.0
    ckv_q = torch.round(hist_ckv / cs).clamp(-128, 127).to(torch.int8)
    kr8 = hist_kr.to(torch.bfloat16)
    qns = 127.0 / split.q_nope.float().abs().amax(dim=(0, 2))
    out8 = pre(ckv_q, kr8, "int8_nzcache", ctkv_scale=cs, q_nope_scale=qns)
    if out8.q_nope.dtype != torch.int8 or not torch.equal(kr8, kr):
        raise AssertionError("(b) int8_nzcache: q_nope not int8, or its krope rows differ")
    args8 = (out8.q_nope, out8.q_pe, ckv_q, kr8, qns, cs, lens, bt, sm, ps)
    t0 = time.perf_counter()
    att8 = dec.decode_mla_int8_ref(*args8)
    _sync(torch, dev)
    t8 = time.perf_counter() - t0
    c = _Launches(build)
    att = dec.decode_mla(q_bf16, ckv, kr, lens, bt, sm, ps)
    _sync(torch, dev)
    _check_launches("(b) decode_mla", c.delta(), _expect(dev, {"decode_mla": 1}))
    diff = _calc_diff(att8, att.float())
    deq_q = torch.cat([out8.q_nope.float() / qns[None, :, None], out8.q_pe.float()], -1)
    golden = dec.decode_mla_ref(deq_q, ckv_q.float() * cs, kr8.float(), lens, bt, sm, ps)
    gerr = float((att8 - golden).abs().max())
    print(f"    int8_nzcache -> decode_mla_int8_ref ({t8 * 1e3:.1f} ms, int32 sums by "
          f"{'torch._int_mm' if dev.type == 'cuda' else 'an int32 product'}) against K7 "
          f"decode_mla over the bf16 caches: calc_diff {diff:.3g} (bar {MLA_INT8_DIFF:g}); "
          f"against decode_mla_ref over the dequantised codes: max-abs {gerr:.3g} (max|out| "
          f"{float(golden.abs().max()):.3g})")
    if not (diff <= MLA_INT8_DIFF and gerr <= 1e-3 * float(golden.abs().max())):
        raise AssertionError("(b) int8_nzcache: decode_mla_int8_ref off its bars")


def _sinks_sdpa(torch, q, k, v, sink, allowed, sm):
    """The sinks reference by one SDPA call: q [N, Hkv, R, D] f32 (the query
    rows of each kv head: its G heads, or its G heads' tokens), k, v [N,
    Hkv, n, D]; sink [1 or N, Hkv, R, 1], each row's sink logit; allowed
    [N, R, n] bool. One extra key column has the sink logit as its score (an
    additive mask on a zero key row) and a zero value row. Returns [N, Hkv,
    R, D]."""
    n_, hkv, rows, d = q.shape
    zero = k.new_zeros((n_, hkv, 1, d))
    ke, ve = torch.cat([k, zero], 2), torch.cat([v, zero], 2)
    mask = torch.where(allowed, 0.0, float("-inf"))[:, None].expand(n_, hkv, rows, -1)
    mask = torch.cat([mask, sink.float().expand(n_, hkv, rows, 1)], -1)
    return torch.nn.functional.scaled_dot_product_attention(q, ke, ve, attn_mask=mask, scale=sm)


def run_sinks(torch, sk, build, dev, b=SINK_B, ctx=SINK_CTX, seqs=SINK_PREFILL):
    """Phase 20 (c): attention with sinks at gpt-oss-120b's widths (64 query,
    8 kv heads of 64), the sliding window of 128 and off: the decode over
    head-major bf16 pages (B `b`, `ctx` cached, lengths 1, 127-129 and
    ctx - 1 among them) and the varlen causal prefill of `seqs`, each
    against SDPA in f32 with one extra key column whose score is the sink
    logit and whose value row is zero; within one bf16 ulp + SINK_SHARE of
    max|ref|. No kernel (the module is plain)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2003)
    hq, hkv, d, ps = SINK_HQ, SINK_HKV, SINK_D, SINK_PS
    g, sm = hq // hkv, d ** -0.5
    sinks = torch.randn((hq,), generator=gen, device=dev)
    mpg = ctx // ps
    pages = b * mpg + 1
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((hkv, pages, ps, d), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    bt = (torch.randperm(pages - 1, generator=gen, device=dev).reshape(b, mpg)
          .to(torch.int32) + 1)
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    edge = [1, ps - 1, ps, ps + 1, ctx - 1]
    lens[: len(edge)] = torch.tensor(edge, dtype=torch.int32, device=dev)
    c = _Launches(build)
    for window in (-1, SINK_WINDOW):
        t0 = time.perf_counter()
        out = sk.decode_attention_with_sinks(q, kc, vc, sinks, lens, bt, sm, ps, window)
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        err = ratio = 0.0
        for lo in range(0, b, 32):                  # the f32 reference in 4 slices
            hi = min(b, lo + 32)
            k = kc[:, bt[lo:hi].long()].transpose(0, 1).reshape(hi - lo, hkv, -1, d).float()
            v = vc[:, bt[lo:hi].long()].transpose(0, 1).reshape(hi - lo, hkv, -1, d).float()
            pos = torch.arange(k.shape[2], device=dev)[None]
            ln = lens[lo:hi, None].long()
            allowed = pos < ln
            if window != -1:
                allowed &= pos >= (ln - window).clamp_min(0)
            ref = _sinks_sdpa(torch, q[lo:hi].float().reshape(hi - lo, hkv, g, d), k, v,
                              sinks.reshape(1, hkv, g, 1), allowed[:, None],
                              sm).reshape(hi - lo, hq, d)
            e, r = _bf16_check(f"(c) decode window {window}", out[lo:hi], ref, SINK_SHARE)
            err, ratio = max(err, e), max(ratio, r)
            del k, v, ref
        print(f"    decode B {b} x {ctx} cached, window {window}: {ms:.1f} ms (eager), max-abs "
              f"vs SDPA {err:.3g} ({ratio:.3g} of its bound)")
    t = sum(seqs)
    cu = torch.tensor([0, *np.cumsum(seqs)], dtype=torch.int32, device=dev)
    qp = torch.randn((t, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    kp_, vp = (torch.randn((t, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(2))
    for window in (-1, SINK_WINDOW):
        t0 = time.perf_counter()
        out = sk.prefill_attention_with_sinks(qp, kp_, vp, sinks, cu, sm, window)
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        err = ratio = 0.0
        for lo, n in zip(np.cumsum((0,) + tuple(seqs[:-1])).tolist(), seqs):
            i = torch.arange(n, device=dev)
            allowed = i[None, :] <= i[:, None]
            if window != -1:
                allowed &= i[None, :] > i[:, None] - window
            qs = qp[lo:lo + n].float().reshape(n, hkv, g, d).permute(1, 2, 0, 3)  # [hkv, g, n, d]
            ks, vs = (x[lo:lo + n].float().permute(1, 0, 2) for x in (kp_, vp))
            sink = sinks.reshape(hkv, g, 1, 1).expand(hkv, g, n, 1).reshape(1, hkv, g * n, 1)
            ref = _sinks_sdpa(torch, qs.reshape(1, hkv, g * n, d), ks[None], vs[None], sink,
                              allowed.repeat(g, 1)[None], sm)
            ref = ref.reshape(hkv, g, n, d).permute(2, 0, 1, 3).reshape(n, hq, d)
            e, r = _bf16_check(f"(c) prefill window {window}", out[lo:lo + n], ref, SINK_SHARE)
            err, ratio = max(err, e), max(ratio, r)
        print(f"    prefill {t} tokens in sequences of {list(seqs)}, window {window}: {ms:.1f} "
              f"ms (eager), max-abs vs SDPA {err:.3g} ({ratio:.3g} of its bound)")
    _check_launches("(c) sinks", c.delta(), {})


def _topk_agree(torch, name, got, score64, k, tol):
    """got [R, K'] ids (-1 pads) against the float64 scores [R, N] (-inf where
    a key is not valid): the same number of ids a row; after ties are
    removed the same set: every id whose score clears the K-th best valid
    score by more than `tol` is in both got and the float64 top-k, and each
    id of got that does not clear it scores within `tol` of it. Returns the
    number of rows whose sets differ (on ties only)."""
    r, n = score64.shape
    kk = min(k, n)
    top, ref = score64.topk(kk, dim=-1)
    rv = top > float("-inf")
    gv = got >= 0
    if not torch.equal(rv.sum(1), gv.sum(1)):
        raise AssertionError(f"{name}: valid ids a row differ from the float64 top-k")
    kth = torch.where(rv, top, float("inf")).amin(1, keepdim=True)
    gm = torch.zeros((r, n), dtype=torch.int32, device=got.device)
    gm.scatter_add_(1, got.long().clamp_min(0), gv.int())
    rm = torch.zeros((r, n), dtype=torch.int32, device=got.device)
    rm.scatter_add_(1, ref.clamp_min(0), rv.int())
    if int(gm.max()) > 1:
        raise AssertionError(f"{name}: an id taken twice")
    clear = score64 > kth + tol
    if not torch.equal(gm.bool() & clear, rm.bool() & clear):
        raise AssertionError(f"{name}: the top-k sets differ beyond ties")
    tie = gm.bool() & ~clear
    if bool(((score64 - kth).abs() > tol)[tie].any()):
        raise AssertionError(f"{name}: an id below the k-th score taken")
    return int((gm.bool() != rm.bool()).any(1).sum())


def _scores64(torch, q, k, w, rows=256):
    """sum_g w_g relu(q_g . k) in float64: q [R, G, D], k [N, D] shared by
    the rows or [R, N, D] a row, w [R, G]; in slices of `rows`."""
    out = []
    for lo in range(0, q.shape[0], rows):
        qs = q[lo:lo + rows].double()
        s = (torch.einsum("rgd,nd->rgn", qs, k.double()) if k.dim() == 2
             else torch.einsum("rgd,rnd->rgn", qs, k[lo:lo + rows].double()))
        out.append(torch.einsum("rgn,rg->rn", s.relu(), w[lo:lo + rows].double()))
    return torch.cat(out)


def run_lightning_indexer(torch, li, build, dev, sq=2048, sk=8192, pb=8, pctx=8192, pps=64,
                          qlens=(512, 1024, 256, 256), klens=(2048, 4096, 1024, 1024),
                          topk=IDX_TOPK):
    """Phase 20 (d): the lightning indexer at DeepSeek-V3.2-Exp's widths (64
    heads of 128, top 2048), bf16 q and k, f32 weights: batched (one
    sequence, the last `sq` queries of `sk` keys, causal), paged (batch
    `pb`, up to `pctx` cached on pages of `pps`, lengths 1, 100, 2,048,
    4,097 among them) and varlen (queries `qlens` over keys `klens`,
    end-aligned causal). Scores within IDX_SCORE_SHARE of max|score| of
    float64 ones; the top-k id sets equal to the float64 top-k's after ties
    are removed (_topk_agree). No kernel (the module is plain)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2004)
    h, d = IDX_H, IDX_D

    def bf(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    def wts(*s):
        return torch.randn(s, generator=gen, device=dev) * h ** -0.5

    c = _Launches(build)
    # batched
    q, k, w = bf(1, sq, h, d), bf(1, sk, d), wts(1, sq, h)
    qpos = (sk - sq + torch.arange(sq, device=dev))[None]
    t0 = time.perf_counter()
    idx, sc = li.lightning_indexer(q, k, w, topk, torch.tensor([sk], device=dev), True, qpos)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    s64 = _scores64(torch, q[0], k[0], w[0])
    s64 = torch.where(torch.arange(sk, device=dev)[None] <= qpos[0][:, None], s64,
                      float("-inf"))
    top = s64[s64 > float("-inf")].abs().max()
    serr = float((sc[0].double() - s64).abs()[s64 > float("-inf")].max() / top)
    ties = _topk_agree(torch, "(d) batched", idx[0], s64, topk, IDX_SCORE_SHARE * float(top))
    if serr > IDX_SCORE_SHARE:
        raise AssertionError(f"(d) batched: scores {serr:.3g} of max|score| off float64")
    print(f"    batched {sq} queries over {sk} keys: {ms:.1f} ms (eager), scores within "
          f"{serr:.2g} of max|score| of float64, top-{topk} sets equal ({ties} rows differ on "
          "ties only)")
    del q, k, w, idx, sc, s64
    # paged
    mpg = pctx // pps
    pages = pb * mpg + 1
    qg, kc, wg = bf(pb, h, d), bf(pages, pps, d), wts(pb, h)
    bt = (torch.randperm(pages - 1, generator=gen, device=dev).reshape(pb, mpg)
          .to(torch.int32) + 1)
    lens = torch.full((pb,), pctx, dtype=torch.int32, device=dev)
    lens[:4] = torch.tensor([1, 100, 2048, 4097], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    slots = li.lightning_indexer_paged(qg, kc, wg, bt, lens, topk)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    s64 = torch.full((pb, pages * pps), float("-inf"), dtype=torch.float64, device=dev)
    logical = (bt.long()[:, :, None] * pps + torch.arange(pps, device=dev)).reshape(pb, -1)
    live = torch.arange(mpg * pps, device=dev)[None] < lens.long()[:, None]
    sl = _scores64(torch, qg, kc[bt.long()].reshape(pb, -1, d), wg)
    s64.scatter_(1, logical, torch.where(live, sl, float("-inf")))
    top = float(sl[live].abs().max())
    ties = _topk_agree(torch, "(d) paged", slots, s64, topk, IDX_SCORE_SHARE * top)
    print(f"    paged B {pb}, {pctx} cached on pages of {pps} (lengths {lens.tolist()}): "
          f"{ms:.1f} ms (eager), top-{topk} slot sets equal to float64's ({ties} rows differ on "
          "ties only)")
    del qg, kc, wg, s64, sl
    # varlen
    t, tk = sum(qlens), sum(klens)
    qv, kv, wv = bf(t, h, d), bf(tk, d), wts(t, h)
    cu_q, cu_k = np.cumsum(qlens).tolist(), np.cumsum(klens).tolist()
    t0 = time.perf_counter()
    idx, sc = li.lightning_indexer_varlen(qv, kv, wv, cu_q, cu_k, topk, True)
    _sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    seg = torch.repeat_interleave(torch.arange(len(qlens), device=dev),
                                  torch.tensor(qlens, device=dev))
    starts_q = torch.tensor([0, *cu_q[:-1]], device=dev)
    starts_k = torch.tensor([0, *cu_k[:-1]], device=dev)
    kl = torch.tensor(klens, device=dev)
    local_q = torch.arange(t, device=dev) - starts_q[seg]
    frontier = starts_k[seg] + local_q + kl[seg] - torch.tensor(qlens, device=dev)[seg]
    kpos = torch.arange(tk, device=dev)[None]
    allowed = (kpos >= starts_k[seg][:, None]) & (kpos <= frontier[:, None])
    s64 = torch.where(allowed, _scores64(torch, qv, kv, wv), float("-inf"))
    top = s64[allowed].abs().max()
    serr = float((sc.double() - s64).abs()[allowed].max() / top)
    glob = torch.where(idx >= 0, idx.long() + starts_k[seg][:, None], -1)
    ties = _topk_agree(torch, "(d) varlen", glob, s64, topk, IDX_SCORE_SHARE * float(top))
    if serr > IDX_SCORE_SHARE:
        raise AssertionError(f"(d) varlen: scores {serr:.3g} of max|score| off float64")
    print(f"    varlen {list(qlens)} queries over {list(klens)} keys: {ms:.1f} ms (eager), "
          f"scores within {serr:.2g} of max|score|, top-{topk} local sets equal ({ties} rows "
          "differ on ties only)")
    _check_launches("(d) lightning_indexer", c.delta(), {})


def _engine_tokens(torch, serving, cfg, params, dev, seed=2005):
    """8 prompts of 64 tokens through a LlamaEngine on `params`, 2 tokens
    each: one prefill call, then one decode call. Returns the tokens."""
    rng = np.random.default_rng(seed)
    eng = serving.LlamaEngine(cfg, params=params, device=dev, num_pages=64, decode_batch=8,
                              token_budget=512)
    calls = {"prefill": 0, "decode": 0}
    inner_pre, inner_dec = eng._prefill_batch, eng._decode

    def pre(*a):
        calls["prefill"] += 1
        return inner_pre(*a)

    def decode(*a):
        calls["decode"] += 1
        return inner_dec(*a)

    eng._prefill_batch, eng._decode = pre, decode
    rids = [eng.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 2) for _ in range(8)]
    while eng.step():
        pass
    del eng._prefill_batch, eng._decode       # no cycle keeps the engine (and params) alive
    if calls != {"prefill": 1, "decode": 1}:
        raise AssertionError(f"(e) the engine made {calls} calls, not one of each")
    return [eng.reqs[r]["out"] for r in rids]


def run_memsaver(torch, serving, saver, tag, cfg, dev):
    """Phase 20 (e): MemorySaver on phase 2's Llama weights, tracked under
    `tag` by the caller, who holds no other reference to them: one engine
    decode call's tokens first; pause (a pinned host backup) frees exactly
    the tracked bytes on the card (torch.cuda.memory_allocated, within the
    allocator's block rounding) and releases them from PyTorch's cache
    (memory_reserved); resume brings them back;
    the restored weights are bit-equal to a host copy taken before, on the
    device each came from; the engine's tokens again the same. Returns the
    restored tree."""
    import gc
    params = saver.get(tag)
    leaves = list(_leaves(params))
    tracked = sum(t.numel() * t.element_size() for t in leaves)
    # the caching allocator hands out blocks of 512 bytes, and keeps the
    # tail of a segment (at most 2 MiB) in a block it does not split
    slack = len(leaves) * (2 << 20)
    devices = [t.device for t in leaves]
    host = [t.cpu() for t in leaves]
    before = _engine_tokens(torch, serving, cfg, params, dev)
    del params, leaves
    gc.collect()
    _sync(torch, dev)
    on_card = dev.type == "cuda"
    a0 = torch.cuda.memory_allocated() if on_card else 0
    r0 = torch.cuda.memory_reserved() if on_card else 0
    t0 = time.perf_counter()
    saver.pause(tag)
    _sync(torch, dev)
    t_pause = time.perf_counter() - t0
    a1 = torch.cuda.memory_allocated() if on_card else 0
    r1 = torch.cuda.memory_reserved() if on_card else 0
    if saver.get(tag) is not None or (on_card and not tracked <= a0 - a1 <= tracked + slack):
        raise AssertionError(f"(e) pause freed {a0 - a1} bytes for {tracked} tracked")
    t0 = time.perf_counter()
    restored = saver.resume(tag)
    _sync(torch, dev)
    t_resume = time.perf_counter() - t0
    a2 = torch.cuda.memory_allocated() if on_card else 0
    if on_card and not tracked <= a2 - a1 <= tracked + slack:
        raise AssertionError(f"(e) resume took {a2 - a1} bytes back for {tracked} tracked")
    for t, h, d in zip(_leaves(restored), host, devices):
        if t.device != d or not torch.equal(t, h.to(d)):
            raise AssertionError("(e) a restored tensor differs from its copy before pause")
    after = _engine_tokens(torch, serving, cfg, restored, dev)
    if after != before:
        raise AssertionError("(e) the engine's tokens after resume differ")
    print(f"    {len(host)} tensors, {tracked} bytes tracked: pause {t_pause:.2f} s, freed "
          f"{a0 - a1} bytes (memory_allocated {a0 / 1e9:.3f} -> {a1 / 1e9:.3f} GB, reserved "
          f"{r0 / 1e9:.3f} -> "
          f"{r1 / 1e9:.3f} GB), resume {t_resume:.2f} s (allocated back to {a2 / 1e9:.3f} GB); "
          "restored weights bit-equal; one engine prefill and decode call give the same tokens")
    return restored


def _compat_cases(torch, compat, dm, dev, gen):
    """(f)'s calls: (name, fn, the launches on the card, check(out, ref)).
    Each fn makes what it writes anew, so that calls do not share outputs."""
    bf = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    cases = []

    def pages(p, hkv, ps, dd, head_major=True):
        shape = (hkv, p, ps, dd) if head_major else (p, hkv, ps, dd)
        return bf(*shape), bf(*shape)

    def bt_lens(b, mp, ps, p):
        bt = (torch.randperm(p - 1, generator=gen, device=dev)[: b * mp].reshape(b, mp)
              .to(torch.int32) + 1)
        lens = torch.randint(1, mp * ps + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        lens[:3] = torch.tensor([1, ps, mp * ps], dtype=torch.int32, device=dev)
        return bt, lens

    def bf16_check(share):
        return lambda name, o, r: _bf16_check(name, o, r, share)

    def exact(name, o, r):
        if not torch.equal(o, r):
            raise AssertionError(f"{name}: not equal")

    x, y = bf(64, 256), bf(64, 256)
    cases.append(("npu.helloworld", lambda: compat.npu.helloworld(x, y), {"helloworld": 1},
                  exact))
    # mla_preprocess with the [in, out] copies: both stages on K2 per_tensor
    # (K % 64 and N % 16: 256 -> 208, 128 -> 192)
    small = dm.MlaConfig(vocab_size=256, hidden_size=256, num_layers=1, num_heads=4,
                         kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
                         q_lora_rank=128, intermediate_size=256, page_size=16)
    weights, wuk, tail, kn_w = _mla_layer(torch, small, gen, dev)
    hid = bf(6, small.hidden_size)
    ang = torch.rand((6, small.qk_rope_dim), generator=gen, device=dev) * 6
    kc0 = bf(4, 16, small.kv_lora_rank)
    kr0 = bf(4, 16, small.qk_rope_dim)
    sl = torch.tensor([5, 17, -1, 33, 40, 63], device=dev)

    def mla():
        out = compat.npu.mla_preprocess(hid, *weights, ang.cos(), ang.sin(), wuk, kc0.clone(),
                                        kr0.clone(), sl, *tail, wdqkv_kn=kn_w[0],
                                        wuq_kn=kn_w[1])
        return out.q_nope, out.q_pe, out.kv_cache, out.krope_cache

    def mla_check(name, o, r):
        for a, b_ in zip(o, r):
            diff, same = _calc_diff(a, b_), float((a == b_).float().mean())
            if not (diff <= 1e-4 and same >= 0.99):
                raise AssertionError(f"{name}: calc_diff {diff:.3g}, {same:.4f} equal")
    cases.append(("npu.mla_preprocess", mla, {"rmsq_gemm_pt": 2}, mla_check))
    # the soft-FP8 GEMMs: e4m3 weights with f32 block scales
    w8 = (0.05 * torch.randn((3, 256, 384), generator=gen, device=dev)).to(torch.float8_e4m3fn)
    ws = torch.rand((3, 2, 3), generator=gen, device=dev) * 0.01 + 0.005
    xa = bf(96, 256)
    gl = torch.tensor([40, 0, 56], dtype=torch.int32, device=dev)
    fp8 = lambda name, o, r: _gemm_check(name, o, r)  # noqa: E731
    cases.append(("npu.softfp8_w8a16_matmul",
                  lambda: compat.npu.softfp8_w8a16_matmul(xa[:16], w8[0], ws[0]),
                  {"wfp8a16_gemm": 1}, fp8))
    cases.append(("npu.softfp8_w8a16_grouped_matmul",
                  lambda: compat.npu.softfp8_w8a16_grouped_matmul(xa, w8, ws, gl),
                  {"wfp8a16_gemm_grouped": 1}, fp8))
    # laser attention and the estimator at D 128
    ql, kl, vl = bf(1, 32, 256, 128), bf(1, 8, 256, 128), bf(1, 8, 256, 128)
    cases.append(("attentions.la", lambda: compat.attentions.la(ql, kl, vl, 128 ** -0.5, True),
                  {"laser_attention": 1}, bf16_check(ATT_SHARE)))
    qe, ke = bf(1, 8, 1024, 128), bf(1, 8, 1024, 128)

    def est_check(name, o, r):
        if not torch.equal(o[0], r[0]):
            from sgl_kernel_npu_tpu_torch.ops.attention import sparse as sp
            ref_scores = sp.block_scores_ref(qe[0], ke[0], 128).reshape(o[0].shape)
            _mask_flips(name, ref_scores, o[0], r[0], 2)
    cases.append(("attentions.sparse_block_estimate",
                  lambda: compat.attentions.sparse_block_estimate(qe, ke, 128, keep_ratio=0.25),
                  {"sparse_estimate": 2}, est_check))
    # the decodes
    ckv, kr = bf(33, 128, 512), bf(33, 128, 64)
    btm, lm = bt_lens(8, 4, 128, 33)
    qm = (1.5 * torch.randn((8, 16, 576), generator=gen, device=dev)).to(torch.bfloat16)
    cases.append(("sgl_kernel.decode_mla",
                  lambda: compat.sgl_kernel.decode_mla(qm, ckv, kr, lm, btm, 192 ** -0.5, 128),
                  {"decode_mla": 1}, bf16_check(K7_SHARE)))
    kh, vh = pages(17, 2, 128, 128)
    bth, lh = bt_lens(4, 4, 128, 17)
    qh = (1.5 * torch.randn((4, 16, 128), generator=gen, device=dev)).to(torch.bfloat16)
    cases.append(("sgl_kernel.decode_gqa",
                  lambda: compat.sgl_kernel.decode_gqa(qh, kh, vh, lh, bth, 128 ** -0.5, 128),
                  {"decode_hm": 1}, bf16_check(K10_SHARE)))
    kp_, vp = pages(17, 2, 128, 128, head_major=False)
    cases.append(("sgl_kernel.decode_gqa_high_performance",
                  lambda: compat.sgl_kernel.decode_gqa_high_performance(
                      qh, kp_, vp, lh, bth, 128 ** -0.5, 128),
                  {"decode_v3": 1}, bf16_check(HM_SHARE)))
    # the gated delta rule's decode step (K9): B 8, 4 qk / 8 v heads of 128
    b, hh, hv, dd = 8, 4, 8, 128
    pool0 = (0.1 * torch.randn((16, hv, dd, dd), generator=gen, device=dev)).to(torch.bfloat16)
    g_args = (torch.randn((hv,), generator=gen, device=dev),
              torch.randn((b, 1, hv), generator=gen, device=dev),
              torch.randn((hv,), generator=gen, device=dev), 1.0, 20.0,
              torch.randn((b, 1, hh, dd), generator=gen, device=dev),
              torch.randn((b, 1, hh, dd), generator=gen, device=dev),
              torch.randn((b, 1, hv, dd), generator=gen, device=dev),
              torch.randn((b, 1, hv), generator=gen, device=dev))
    gidx = torch.arange(3, 3 + b, dtype=torch.int32, device=dev)

    def gdn():
        return compat.sgl_kernel.fused_sigmoid_gating_delta_rule_update(
            *g_args, pool0.clone(), gidx, None, True)

    def gdn_check(name, o, r):
        err = float((o[0].float() - r[0].float()).abs().max())
        if not err <= GDN_SHARE * float(r[0].float().abs().max()):
            raise AssertionError(f"{name}: o max-abs {err:.3g}")
        _bf16_check(f"{name} pool", o[1], r[1], 1e-6)
    cases.append(("sgl_kernel.fused_sigmoid_gating_delta_rule_update", gdn,
                  {"gdn_recurrent": 1}, gdn_check))
    # add_rmsnorm_bias with the static int8 quant (K20), swiglu_quant (K13)
    nx, nr = bf(64, 512), bf(64, 512)
    nw = 1.0 + 0.1 * torch.randn((512,), generator=gen, device=dev)
    nb = 0.1 * torch.randn((512,), generator=gen, device=dev)
    nqs = 20.0 + 20.0 * torch.rand((512,), generator=gen, device=dev)
    nqo = torch.randn((512,), generator=gen, device=dev)
    cases.append(("sgl_kernel.add_rmsnorm_bias",
                  lambda: compat.sgl_kernel.add_rmsnorm_bias(nx, nr, nw, nb, 1e-6, nqs, nqo),
                  {"add_rmsnorm_quant": 1}, lambda name, o, r: _norm_check(torch, name, o, r)))
    sx = (2 * torch.randn((256, 512), generator=gen, device=dev)).to(torch.bfloat16)
    sgl = torch.tensor([100, 60], dtype=torch.int32, device=dev)

    def swiglu_check(name, o, r):
        d_ = (o[0].int() - r[0].int()).abs()
        if int(d_.max()) > 1 or float((d_ > 0).double().mean()) > MOE_FLIP_SHARE:
            raise AssertionError(f"{name}: int8 beyond the flip bar")
        ulp = torch.nextafter(r[1].abs(), torch.full_like(r[1], float("inf"))) - r[1].abs()
        if not bool(((o[1] - r[1]).abs() <= ulp).all()):
            raise AssertionError(f"{name}: scales beyond one f32 ulp")
    cases.append(("sgl_kernel.swiglu_quant", lambda: compat.sgl_kernel.swiglu_quant(sx, sgl),
                  {"swiglu_quant": 1}, swiglu_check))
    return cases


def run_compat(torch, compat, dm, build, dev):
    """Phase 20 (f): every compat name resolves to a callable of the port
    (and of no other package); each name that reaches a kernel is called
    once on `dev`'s tensors at a small valid shape: the call launches
    exactly its kernel (two launches for mla_preprocess's two K2 stages and
    for K18's pooling and score kernels), nothing else, a second call is
    bit-identical, and the same call under SKT_IMPL=ref (no launch) agrees
    within phase 1's bar for that kernel."""
    names = 0
    for ns in ("npu", "attentions", "sgl_kernel", "deep_ep", "torch_memory_saver"):
        for key, fn in vars(getattr(compat, ns)).items():
            if not callable(fn) or not fn.__module__.startswith("sgl_kernel_npu_tpu_torch."):
                raise AssertionError(f"(f) compat.{ns}.{key} is not a callable of the port")
            names += 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(2006)
    cases = _compat_cases(torch, compat, dm, dev, gen)
    c = _Launches(build)
    for name, fn, expect, check in cases:
        before = _Launches(build)
        out = fn()
        _sync(torch, dev)
        _check_launches(f"(f) {name}", before.delta(), _expect(dev, expect))
        outs = out if isinstance(out, tuple) else (out,)
        if not all(bool(torch.isfinite(o.float()).all()) for o in outs if o is not None):
            raise AssertionError(f"(f) {name}: output not finite")
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, o) for a, o in zip(again, outs) if o is not None):
            raise AssertionError(f"(f) {name}: a second call differs")
        mid = _Launches(build)
        with _env(SKT_IMPL="ref"):
            ref = fn()
        _sync(torch, dev)
        _check_launches(f"(f) {name} under SKT_IMPL=ref", mid.delta(), {})
        check(f"(f) {name}", out, ref)
        print(f"    {name}: launches {_expect(dev, expect) or 'none (CPU)'}, a second call "
              "bit-identical, within its bar of SKT_IMPL=ref")
    total = {k: n for k, n in c.delta().items() if n}
    print(f"  (f) {names} compat names resolve to callables of the port; {len(cases)} names "
          f"that reach a kernel driven, launches in all (three calls each, the third under "
          f"SKT_IMPL=ref): {total}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ------------------------- phase 21: the attentions surface at public widths

# Public models' attention widths, each from its config.json:
# deepseek-ai/DeepSeek-V3 (128 heads, qk_nope_head_dim 128 + qk_rope_head_dim
# 64, v_head_dim 128: MLA prefill in its MHA form), Qwen/Qwen3-Next-80B-A3B
# (16 / 2 heads of 256), stabilityai/stable-diffusion-3-medium's joint
# attention (24 heads of 64 over the 4096 latent tokens of a 1024^2 image and
# 333 text tokens), microsoft/Phi-3-mini-4k-instruct (32 / 32 heads of 96),
# microsoft/phi-2 (hidden 2560: 32 heads of 80, 2048 positions); batch 1.
# (row, part, model, Hq, Hkv, D, Dv, T, causal, dtype) of laser attention
# through compat.attentions.la, each its kernels-line row; "padded": a bf16 /
# fp16 width the laser_attention kernel runs on a larger tile
# (prefill.laser_tile; D 96 and 80 on (128, 128)). New rows go at the end:
# a row's inputs are drawn from seed 2100 + its index.
WIDTH_LA = (
    ("laser_attention (D 192 / 128, DeepSeek-V3 MLA prefill)", "a", "DeepSeek-V3 MLA prefill",
     128, 128, 192, 128, 4096, True, "bfloat16"),
    ("laser_attention (D 256, Qwen3-Next)", "b", "Qwen3-Next-80B-A3B", 16, 2, 256, 256, 8192,
     True, "bfloat16"),
    ("laser_attention (D 64, SD3)", "c", "SD3 joint attention", 24, 24, 64, 64, 4429, False,
     "bfloat16"),
    ("laser_attention (D 64, SD3, fp16)", "c", "SD3 joint attention", 24, 24, 64, 64, 4429,
     False, "float16"),
    ("laser_attention (D 96, Phi-3, padded)", "d", "Phi-3-mini", 32, 32, 96, 96, 4096, True,
     "bfloat16"),
    ("laser_attention_general (D 96, Phi-3, f32)", "d", "Phi-3-mini", 32, 32, 96, 96, 4096, True,
     "float32"),
    # the JAX tests' head dim and type at a T no block divides
    ("laser_attention_general (D 32, f32, T 1000)", "f", "edge", 8, 2, 32, 32, 1000, True,
     "float32"),
    ("laser_attention (D 80, Phi-2, fp16, padded)", "g", "Phi-2", 32, 32, 80, 80, 2048, True,
     "float16"),
    # zero-filled columns past 96 and rows past T in one tile, GQA
    ("laser_attention (D 96, GQA 8 / 2, T 1000, padded)", "h", "edge", 8, 2, 96, 96, 1000, True,
     "bfloat16"),
)
# (row, part, model, H, T, D, block, causal, dtype) of the estimator through
# compat.attentions.sparse_block_estimate (keep 0.25), each on the q and k
# of the first laser case of its part and dtype (k's kv heads repeated to
# H), drawn where there is none
WIDTH_EST = (
    ("sparse_estimate (D 192, DeepSeek-V3)", "a", "DeepSeek-V3 MLA prefill", 128, 4096, 192, 128,
     True, "bfloat16"),
    ("sparse_estimate (D 256, Qwen3-Next)", "b", "Qwen3-Next-80B-A3B", 16, 8192, 256, 128, True,
     "bfloat16"),
    ("sparse_estimate (D 64, SD3, fp16)", "c", "SD3 joint attention", 24, 4429, 64, 64, False,
     "float16"),
    ("sparse_estimate (D 96, Phi-3, f32)", "d", "Phi-3-mini", 32, 4096, 96, 128, True,
     "float32"),
)
# top-k block-sparse decode on one shared kv head, 256 blocks of 8 a row,
# pages of 128: tiiuae/falcon-7b (71 heads of 64, multi-query),
# google/gemma-3-1b-it (4 heads of 256, one kv head), deepseek-ai/
# DeepSeek-V3.2-Exp's latent rows (128 heads, D 576, Dv 512). (row, model, B,
# H, D, Dv, pages, dtype); row 2 of each selects nothing (the mean of block
# 0's V rows).
WIDTH_TOPK = (
    ("topk_block_sparse (D 64, Falcon-7B, 71 heads)", "Falcon-7B", 64, 71, 64, 64, 512,
     "bfloat16"),
    ("topk_block_sparse (D 256, Gemma-3-1B)", "Gemma-3-1B", 128, 4, 256, 256, 512, "bfloat16"),
    ("topk_block_sparse (D 256, Gemma-3-1B, fp16)", "Gemma-3-1B", 128, 4, 256, 256, 512,
     "float16"),
    ("topk_block_sparse (D 576 / 512, DeepSeek-V3.2-Exp, 128 heads)", "DeepSeek-V3.2-Exp", 32,
     128, 576, 512, 4096, "bfloat16"),
)
# Bars against the plain version: bf16 one bf16 ulp (2^-7 of |plain|) plus
# ATT_SHARE of max|plain|; fp16 the same with one fp16 ulp (2^-10); f32 within
# F32_WIDTH_SHARE of max|plain| (the same f32 steps, sums in another order);
# K18's scores within 1e-5 of the largest |score| and its keep-0.25 masks
# equal or flipped only within f32 rounding of the threshold (_mask_flips)
F32_WIDTH_SHARE = 2e-5
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _width_check(name, out, ref, dtype):
    """The phase-21 bar of `dtype` (above). Returns (max-abs, share of the
    bar) and says which bar."""
    a, b = out.double(), ref.double()
    err = (a - b).abs()
    top = float(b.abs().max())
    if dtype == "float32":
        bound = F32_WIDTH_SHARE * top
        ratio = float(err.max()) / bound if bound else 0.0
        what = f"{F32_WIDTH_SHARE:g} of max|plain|"
    else:
        ratio = float((err / (ULP[dtype] * b.abs() + ATT_SHARE * top)).max())
        what = f"one {dtype} ulp + {ATT_SHARE:g} of max|plain|"
    if not ratio <= 1.0 or not bool(out.float().isfinite().all()):
        raise AssertionError(f"{name}: max-abs {float(err.max()):.3g} is {ratio:.3g} x its bar "
                             f"({what}; max|plain| {top:.3g})")
    return float(err.max()), ratio, what


def _width_randn(torch, gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))


def _width_cases(torch, compat, pf, sp, dev, small):
    """Phase 21's cases in drive order: dicts of the row, its part, the
    counter it must launch and how often a call, the entry-point call, the
    check against the same call under SKT_IMPL=ref, and what pass 2 times
    (the kernel alone, its plain version, the library call, the bound).
    `small` cuts T, B and pages for a rehearsal on the CPU."""
    cases = []
    la_inputs = {}
    for i, (row, part, model, hq, hkv, d, dv, t, causal, dtype) in enumerate(WIDTH_LA):
        if small:
            hq, hkv, t = min(hq, 4), min(hkv, 2), min(t, 200 + 37 * i)
            hkv = hkv if hq % hkv == 0 else 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(2100 + i)
        q = _width_randn(torch, gen, (1, hq, t, d), dtype, dev)
        k = _width_randn(torch, gen, (1, hkv, t, d), dtype, dev)
        v = _width_randn(torch, gen, (1, hkv, t, dv), dtype, dev)
        la_inputs.setdefault((part, dtype), (q, k))
        sm = 1.0 / float(d) ** 0.5
        elt = q.element_size()
        pairs = t * (t + 1) / 2 if causal else float(t) * t
        ops = 2.0 * (d + dv) * hq * pairs
        nbytes = elt * (q.numel() + k.numel() + v.numel() + hq * t * dv)
        tile = pf.laser_tile(d, dv) if dtype != "float32" else None
        cases.append(dict(
            row=row, part=part, kind="la", dtype=dtype,
            label=f"{model}: la Hq {hq} / Hkv {hkv}, D {d}, Dv {dv}, T {t}, "
                  f"{'causal' if causal else 'not causal'}, {dtype}",
            counter=row.split(" (")[0],
            call=lambda q=q, k=k, v=v, sm=sm, c=causal: compat.attentions.la(q, k, v, sm, c),
            kernel=None, plain_fn=None, inputs=(q, k, v, sm, causal), ops=ops, nbytes=nbytes,
            padded_ops=2.0 * sum(tile) * hq * pairs if tile and tile != (d, dv) else None))
    for i, (row, part, model, h, t, d, bs, causal, dtype) in enumerate(WIDTH_EST):
        if (part, dtype) in la_inputs:
            q, k = la_inputs[(part, dtype)]
            h, t = q.shape[1], q.shape[2]
            k = k.repeat_interleave(h // k.shape[1], dim=1)
        else:
            if small:
                h, t = min(h, 4), min(t, 300 + 13 * i)
                bs = min(bs, 32)
            gen = torch.Generator(device=dev)
            gen.manual_seed(2110 + i)
            q = _width_randn(torch, gen, (1, h, t, d), dtype, dev)
            k = _width_randn(torch, gen, (1, h, t, d), dtype, dev)
        if small:
            bs = min(bs, 32)
        nq = -(-t // bs)
        cases.append(dict(
            row=row, part=part, kind="est", dtype=dtype,
            label=f"{model}: sparse_block_estimate [1, {h}, {t}, {d}], blocks of {bs} "
                  f"(NQ = NK = {nq}), {'causal' if causal else 'not causal'}, {dtype}",
            counter="sparse_estimate",
            call=lambda q=q, k=k, bs=bs, c=causal: compat.attentions.sparse_block_estimate(
                q, k, bs, keep_ratio=0.25, causal=c),
            inputs=(q, k, bs, causal)))
    for i, (row, model, b, h, d, dv, pages, dtype) in enumerate(WIDTH_TOPK):
        if small:
            b, pages = 4, 8
        kb = TOPK_KB if not small else 24
        q, kc, vc, ids, tok = _topk_case(torch, model, b, d, dv, pages, 2120 + i, h,
                                         getattr(torch, dtype), dev, kb)
        sm = 1.0 / float(d) ** 0.5
        cases.append(dict(
            row=row, part="e", kind="topk", dtype=dtype,
            label=f"{model}: topk_block_sparse_attention B {b}, H {h}, D {d}, Dv {dv}, "
                  f"{pages} pages of {TOPK_PS}, {kb} blocks a row, {dtype}",
            counter="topk_block_sparse",
            call=lambda q=q, kc=kc, vc=vc, ids=ids, sm=sm: sp.topk_block_sparse_attention(
                q, kc, vc, ids, sm, TOPK_PS),
            inputs=(q, kc, vc, ids, tok, sm)))
    return cases


def _width_expect(case):
    return {case["counter"]: 2 if case["kind"] == "est" else 1}


def _width_check_case(torch, sp, case, out, ref):
    """Hold one phase-21 call to the same call under SKT_IMPL=ref by its
    kind's bar. Returns (max-abs, share of the bar, the bar, a note)."""
    name, dtype = case["row"], case["dtype"]
    if case["kind"] == "la":
        return (*_width_check(name, out, ref, dtype), "")
    if case["kind"] == "topk":
        q, kc, vc, ids, tok, sm = case["inputs"]
        err, ratio, what = _width_check(name, out, ref, dtype)
        dv = vc.shape[-1]
        mean0 = vc.reshape(-1, 8, dv)[0].float().mean(0)
        tol = ULP[dtype] * mean0.abs() + ATT_SHARE * float(mean0.abs().max())
        if not bool(((out[2].float() - mean0).abs() <= tol).all()):
            raise AssertionError(f"{name}: the row of only -1 ids is not block 0's mean")
        return err, ratio, what, "; the row of only -1 ids block 0's mean"
    # the estimator: masks equal or flipped at the threshold, counts their sums
    q, k, bs, causal = case["inputs"]
    (mask, cnt), (ref_mask, ref_cnt) = out, ref
    if not torch.equal(cnt, mask.sum(-1, dtype=torch.int32)):
        raise AssertionError(f"{name}: counts are not the mask's row sums")
    flips = []
    if not torch.equal(mask, ref_mask):
        qp, kp = (sp.padded_rows(x, bs) for x in (q, k))
        ref_scores = sp.block_scores_ref(qp, kp, bs, causal).reshape(mask.shape)
        flips = _mask_flips(name, ref_scores, mask, ref_mask, max(1, int(mask.shape[-1] * 0.25)))
    return 0.0, 0.0, "masks equal or flipped at the threshold", (
        f"; keep-0.25 masks {'equal' if not flips else f'{len(flips)} flips at the threshold'}")


def _width_times(torch, pf, sp, case):
    """Pass 2 of one case: the kernel alone by graph replay, its plain
    version by events, the library call by graph replay (None for K18),
    the bound; K18's scores also held to block_scores_ref. Returns the
    kernels-line row (without launches) and a note."""
    kind, dtype = case["kind"], case["dtype"]
    note = ""
    if kind == "la":
        q, k, v, sm, causal = case["inputs"]
        ms = _time_ms(lambda: pf.laser_attention(q, k, v, sm, causal), 5, graph=True)
        plain_ms = _time_ms(lambda: pf.laser_attention_blocked_ref(q, k, v, sm, causal), 1, 1)
        library, backend = _sdpa_yardstick(torch, q, k, v, None, sm, is_causal=causal,
                                           enable_gqa=q.shape[1] != k.shape[1])
        lib = _time_ms(library, 5, graph=True)
        note = f"SDPA ({backend}, is_causal {causal})"
        nbytes, ops = case["nbytes"], case["ops"]
        if dtype == "float32":
            # split TF32: three TF32 products for each f32 one
            bound, by = _bound_ms(nbytes, 3.0 * ops, "tf32_flops")
            note += (f"; {ops:.3e} operations, bound in split TF32 (3x at the TF32 "
                     f"tensor-core rate); {_bound_ms(nbytes, ops, 'f32_flops')[0]:.4f} ms at "
                     f"the CUDA cores' f32 rate")
        else:
            bound, by = _bound_ms(nbytes, ops, "bf16_flops")
            note += f"; {ops:.3e} operations, bound at the bf16 / fp16 tensor-core rate"
            if case["padded_ops"]:
                note += (f" at the real width; {case['padded_ops']:.3e} operations and "
                         f"{_bound_ms(nbytes, case['padded_ops'], 'bf16_flops')[0]:.4f} ms at "
                         f"the padded tile")
    elif kind == "est":
        q, k, bs, causal = case["inputs"]
        qp, kp = (sp.padded_rows(x, bs) for x in (q, k))
        sc = sp.block_scores(qp, kp, bs, causal)
        ref = sp.block_scores_ref(qp, kp, bs, causal)
        torch.cuda.synchronize()
        live = ref > -1e29
        if not torch.equal(sc[~live], ref[~live]):
            raise AssertionError(f"{case['row']}: the causal -1e30 entries differ")
        err = float((sc[live] - ref[live]).abs().max())
        top = float(ref[live].abs().max())
        if not err <= 1e-5 * top:
            raise AssertionError(f"{case['row']}: scores max-abs {err:.3g} over 1e-5 of "
                                 f"{top:.3g}")
        case["err"], case["ratio"] = err, err / (1e-5 * top)
        case["bar"] = "scores within 1e-5 of the largest |score|; " + case["bar"]
        ms = _time_ms(lambda: sp.block_scores(qp, kp, bs, causal), 10, graph=True)
        plain_ms = _time_ms(lambda: sp.block_scores_ref(qp, kp, bs, causal), 2, 1)
        lib = None
        bh, nq, nk = qp.shape[0], qp.shape[1] // bs, kp.shape[1] // bs
        nbytes = q.element_size() * (q.numel() + k.numel()) + 4.0 * bh * nq * nk
        ops = float(q.numel() + k.numel()) + 2.0 * bh * nq * nk * qp.shape[2]
        bound, by = _bound_ms(nbytes, ops, "f32_flops")
        note = "no library call"
    else:
        q, kc, vc, ids, tok, sm = case["inputs"]
        b, h, d = q.shape
        dv = vc.shape[-1]
        ms = _time_ms(lambda: sp.topk_block_sparse_attention(q, kc, vc, ids, sm, TOPK_PS), 10,
                      graph=True)
        plain_ms = _time_ms(lambda: sp.topk_block_sparse_attention_ref(q, kc, vc, ids, sm,
                                                                       TOPK_PS), 1, 1)
        flat = tok.clamp_min(0).long().reshape(-1)
        kg = kc.reshape(-1, d).index_select(0, flat).reshape(b, 1, -1, d)
        vg = vc.reshape(-1, dv).index_select(0, flat).reshape(b, 1, -1, dv)
        live = (tok >= 0)[:, None, None, :]
        library, backend = _sdpa_yardstick(torch, q[:, None], kg, vg, live, sm)
        lib = _time_ms(library, 10, graph=True)
        del kg, vg
        selected = float((ids >= 0).sum()) * 8
        distinct = torch.cat([ids[ids >= 0], ids.new_zeros(1)]).unique().numel()
        nbytes = (8.0 * distinct * 2.0 * (d + dv) + 2.0 * b * h * (d + dv) + 4.0 * ids.numel())
        bound, by = _bound_ms(nbytes, 2.0 * selected * h * (d + dv), "bf16_flops")
        note = (f"SDPA ({backend}, over rows gathered by index_select beforehand); "
                f"{distinct} distinct blocks")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bound, bound_by=by,
               max_abs_err=case["err"])
    return row, note


def _width_refusals(torch, pf, sp, build, dev):
    """Widths outside every route raise on the card's tensors, naming the
    widths they take, and launch nothing."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2130)
    before = _Launches(build)
    x = torch.randn((1, 2, 64, 320), generator=gen, device=dev).to(torch.bfloat16)
    tries = [("la at D 320", lambda: pf.laser_attention(x, x, x, 0.1), ValueError, "(64, 64)")]
    q = torch.randn((2, 4, 96), generator=gen, device=dev).to(torch.bfloat16)
    c96 = torch.randn((2, 128, 96), generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    tries.append(("topk_block_sparse at (96, 96)", lambda: sp.topk_block_sparse_attention(
        q, c96, c96, ids, 0.1, 128), ValueError, "(576, 512)"))
    c64 = torch.randn((2, 128, 64), generator=gen, device=dev)
    tries.append(("topk_block_sparse on f32", lambda: sp.topk_block_sparse_attention(
        c64[:, :4].contiguous(), c64, c64, ids, 0.1, 128), TypeError, "bf16 or fp16"))
    for name, fn, exc, says in tries:
        try:
            fn()
        except exc as e:
            if says not in str(e):
                raise AssertionError(f"{name}: {exc.__name__} does not name the widths it takes "
                                     f"({e})")
            print(f"    {name}: {exc.__name__}: {e}")
            continue
        raise AssertionError(f"{name}: did not raise {exc.__name__}")
    if any(before.delta().values()):
        raise AssertionError(f"the refused widths launched {before.delta()}")


def run_attention_widths(torch, build, compat, pf, sp, dev, gpu, small=False):
    """Phase 21: the attentions surface at public models' widths (WIDTH_LA,
    WIDTH_EST, WIDTH_TOPK). Pass 1, the main path, with every count set to
    0 first: each case through its entry point (compat.attentions.la,
    compat.attentions.sparse_block_estimate, sp.topk_block_sparse_attention)
    with exact launches, finite, a second call bit-identical, held to the
    same call under SKT_IMPL=ref (no launch) by its dtype's bar; the counts
    read right after. Pass 2 (the card only): each case's kernel alone,
    plain version, library call and bound, K18's scores against
    block_scores_ref. Then the refused widths. Returns {row: kernels-line
    row} with each row's launches from pass 1."""
    t0 = time.perf_counter()
    cases = _width_cases(torch, compat, pf, sp, dev, small)
    print(f"  inputs of {len(cases)} cases drawn ({time.perf_counter() - t0:.1f} s)")
    build.reset_launches()
    for case in cases:
        before = _Launches(build)
        out = case["call"]()
        _sync(torch, dev)
        _check_launches(case["row"], before.delta(), _expect(dev, _width_expect(case)))
        outs = out if isinstance(out, tuple) else (out,)
        if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
            raise AssertionError(f"{case['row']}: output not finite")
        again = case["call"]()
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, o) for a, o in zip(again, outs)):
            raise AssertionError(f"{case['row']}: a second call differs")
        case["launches"] = {k: n for k, n in before.delta().items() if n}
        mid = _Launches(build)
        with _env(SKT_IMPL="ref"):
            ref = case["call"]()
        _sync(torch, dev)
        _check_launches(f"{case['row']} under SKT_IMPL=ref", mid.delta(), {})
        case["err"], case["ratio"], case["bar"], note = _width_check_case(torch, sp, case, out,
                                                                          ref)
        print(f"  ({case['part']}) {case['label']}: launches {case['launches'] or 'none (CPU)'} "
              f"(two calls, the second bit-identical); vs SKT_IMPL=ref max-abs "
              f"{case['err']:.3g}, {case['ratio']:.3g} of its bar ({case['bar']}){note}")
        del out, again, ref, outs
    totals = {k: n for k, n in build.launches.items() if n}
    want = {}
    for case in cases:
        for k, n in case["launches"].items():
            want[k] = want.get(k, 0) + n
    if totals != want:
        raise AssertionError(f"phase 21 launched {totals}, its cases {want}")
    kernels = {"laser_attention", "laser_attention_general", "sparse_estimate",
               "topk_block_sparse"}
    if dev.type == "cuda" and set(totals) != kernels:
        raise AssertionError(f"phase 21's kernels launched: {totals}")
    print(f"  pass 1 (the main path, counts set to 0 first) {time.perf_counter() - t0:.1f} s, "
          f"launches {totals or 'none (CPU)'}")
    rows = {}
    if dev.type == "cuda":
        for case in cases:
            row, note = _width_times(torch, pf, sp, case)
            row["launches"] = case["launches"].get(case["counter"], 0)
            rows[case["row"]] = row
            print(f"  {case['row']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
                  + ("library none" if row["library_ms"] is None
                     else f"library {row['library_ms']:.4f} ms")
                  + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                  f"{row['bound_ms'] / row['ms']:.1%} of it); {note}; max-abs "
                  f"{row['max_abs_err']:.3g} ({case['ratio']:.3g} of its bar) [{gpu}]")
        _width_refusals(torch, pf, sp, build, dev)
    del cases
    print(f"  phase 21 (both passes) {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> int:
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to drive",
              file=sys.stderr)
        return 2
    try:
        from sgl_kernel_npu_tpu_torch import _build, compat, memsaver, serving
        from sgl_kernel_npu_tpu_torch import runtime
        from sgl_kernel_npu_tpu_torch.models import (deepseek_mla, llama, loader, quant_ref,
                                                     qwen_next)
        from sgl_kernel_npu_tpu_torch import parallel
        from sgl_kernel_npu_tpu_torch.ops import (activation, helloworld, matmul, mla_preprocess,
                                                  norm, quant, rmsq_gemm)
        from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v4 as attic_v4
        from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v5 as attic_v5
        from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v7 as attic_v7
        from sgl_kernel_npu_tpu_torch.parallel.strategies import (fused_moe_pallas,
                                                                  low_latency, pallas_ll)
        from sgl_kernel_npu_tpu_torch.ops.gdn import recurrent_pallas
        from sgl_kernel_npu_tpu_torch.ops.attention import (decode, decode_mla_v2,
                                                            decode_v3, decode_v6,
                                                            decode_v8, decode_v9,
                                                            decode_v11, decode_v13,
                                                            lightning_indexer,
                                                            paged_prefill, paged_prefill_tm,
                                                            prefill, sinks, sparse)
        from sgl_kernel_npu_tpu_torch.utils import env
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    gpu = _gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    floor_build = start_launch_floor_build(_build)
    times = _build.build()
    print(f"nvcc ({len(times)} in parallel) {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    t0 = time.perf_counter()
    runtime.build_native()
    print(f"g++ runtime {time.perf_counter() - t0:.1f} s")

    cfg = llama.LlamaConfig(int8_kv=True)
    # bench.py --config mla (bench.py:281-284): DeepSeek-V2-Lite's dimensions
    # with V2's q-LoRA of 1536
    mcfg = deepseek_mla.MlaConfig(vocab_size=102400, hidden_size=2048, num_layers=27,
                                  num_heads=16, kv_lora_rank=512, qk_rope_dim=64,
                                  qk_nope_dim=128, v_head_dim=128, q_lora_rank=1536,
                                  intermediate_size=10944, page_size=128)
    rng = torch.Generator(device="cuda")
    rng.manual_seed(0)

    qcfg = qwen_bench_config(qwen_next)
    t0 = time.perf_counter()
    moe_data = moe_bench_data(torch)
    torch.cuda.synchronize()
    print(f"  bench.py --config moe data (seed 0) {time.perf_counter() - t0:.1f} s")

    print("phase 1: kernels vs plain versions at Llama-3-8B, DeepSeek-V2-Lite, the Qwen and "
          "the MoE bench shapes")
    _warm_up_card(torch)
    floors = launch_floor(torch, floor_build)
    rows = {}
    gemm_rows = check_gemm(torch, matmul, quant, cfg, mcfg, rng)
    compare_split_policy(torch, matmul, quant, cfg, rng)
    rows["l1"] = check_matmul_l1(torch, matmul, quant, cfg, mcfg, rng)
    torch.cuda.empty_cache()
    rows["dec"], rows["v8"] = check_decode(torch, decode_v9, decode_v8, cfg, rng)
    check_decode_edges(torch, decode_v9, decode_v8, cfg)
    torch.cuda.empty_cache()
    rows["pre"], rows["pre512"] = check_prefill(torch, paged_prefill_tm, cfg, rng)
    torch.cuda.empty_cache()
    rows["app"], rows["app_pre"] = check_append(torch, decode_v8, cfg, rng, floors["D B 8"])
    torch.cuda.empty_cache()
    rows["k1"] = check_gemm_tiled(torch, matmul, quant, cfg, rng)
    torch.cuda.empty_cache()
    rows["k2"] = check_rmsq(torch, matmul, rmsq_gemm, quant, cfg, rng)
    torch.cuda.empty_cache()
    rows["k3"], rows["k3p4"] = check_decode_tm2(torch, decode_v11, decode_v13, cfg, rng)
    check_decode_tm2_edges(torch, decode_v11)
    torch.cuda.empty_cache()
    rows["k4"] = check_append_tm2(torch, decode_v11, cfg, rng)
    torch.cuda.empty_cache()
    rows["k2pt"], rows["k2pt_m8"] = check_rmsq_pt(torch, matmul, rmsq_gemm, mcfg, rng)
    check_rmsq_edges(torch, matmul, rmsq_gemm)
    torch.cuda.empty_cache()
    rows["k5"] = check_decode_mla_c(torch, decode_mla_v2, mcfg, rng)
    check_decode_mla_c_edges(torch, decode_mla_v2, mcfg)
    check_decode_mla_c_sharp(torch, decode_mla_v2, mcfg)
    torch.cuda.empty_cache()
    rows["k6"] = check_append_mla(torch, decode_mla_v2, mcfg, rng, floors["K6 B 128"])
    check_append_mla_edges(torch, decode_mla_v2)
    torch.cuda.empty_cache()
    rows["k7"] = check_decode_mla(torch, decode, mcfg, rng)
    check_decode_mla_edges(torch, decode, mcfg)
    torch.cuda.empty_cache()
    rows["k8"] = check_grouped(torch, matmul, quant, qwen_next, qcfg, rng)
    check_grouped_edges(torch, matmul)
    torch.cuda.empty_cache()
    rows["k9"] = check_gdn(torch, recurrent_pallas, qcfg, rng)
    rng19 = torch.Generator(device="cuda")        # phase 19's rows draw apart from the rest
    rng19.manual_seed(19)
    rows["k9_f32"], rows["k9_d32"], rows["k9_d32_f32"] = check_gdn_widths(
        torch, recurrent_pallas, rng19)
    torch.cuda.empty_cache()
    rows["k10"] = check_decode_hm(torch, decode, qcfg, rng)
    check_decode_hm_edges(torch, decode, decode_v3)
    torch.cuda.empty_cache()
    rng18 = torch.Generator(device="cuda")        # phase 18's rows draw apart from the rest
    rng18.manual_seed(18)
    rows["k10_256"] = check_decode_hm256(torch, decode, rng18)
    check_decode_hm_edges(torch, decode, decode_v3, d=256)
    torch.cuda.empty_cache()
    rows["k2_qgemm"], rows["k2_lm"] = check_rmsq_routes(torch, matmul, rmsq_gemm, cfg, rng18)
    torch.cuda.empty_cache()
    rows["k10f32"] = check_decode_hm_f32(torch, decode, decode_v3, rng)
    check_decode_hm_f32_edges(torch, decode, decode_v3)
    torch.cuda.empty_cache()
    rows.update(check_decode_v6(torch, decode_v6, cfg, rng))
    check_decode_v6_edges(torch, decode_v6)
    torch.cuda.empty_cache()
    rows["k15"], rows["k15_int8"] = check_prefill_hm(torch, paged_prefill, cfg, rng)
    torch.cuda.empty_cache()
    rows.update(check_decode_v3(torch, decode_v3, decode, cfg, rng))
    check_decode_v3_edges(torch, decode_v3, decode, attic_v4)
    torch.cuda.empty_cache()
    rows["k11"], comp_ms = check_fused_moe(
        torch, low_latency, pallas_ll, fused_moe_pallas,
        moe_variants(torch, parallel, moe_data)["rounds=1"], parallel.EPGroup, moe_data)
    torch.cuda.empty_cache()
    rows["k8moe"] = check_moe_gemms(torch, parallel, parallel.fused_moe, matmul, moe_data)
    torch.cuda.empty_cache()
    rows["k12"] = check_remote_scatter(torch, low_latency, pallas_ll, parallel.comm, moe_data)
    check_remote_scatter_edges(torch, pallas_ll, parallel.comm)
    torch.cuda.empty_cache()
    rows["k13"] = check_swiglu_quant(torch, activation, floors["K13 2,048 rows"])
    torch.cuda.empty_cache()
    rows.update(zip(LASER_NAMES, check_laser(torch, prefill)))
    check_laser_edges(torch, prefill)
    torch.cuda.empty_cache()
    rows["sparse_estimate"], rows["k18_long"] = check_sparse_estimate(torch, sparse)
    torch.cuda.empty_cache()
    rows.update(zip(TOPK_NAMES, check_topk(torch, sparse)))
    check_topk_edges(torch, sparse)
    torch.cuda.empty_cache()
    rows.update(zip(NORM_NAMES, check_add_rmsnorm_quant(torch, norm, floors["K20 N 128"])))
    check_add_rmsnorm_quant_edges(torch, norm)
    torch.cuda.empty_cache()
    rows["k21"], rows["k21_m4096"], rows["k21g"] = check_wfp8a16(torch, matmul, quant, moe_data)
    torch.cuda.empty_cache()
    rows["k22"] = check_helloworld(torch, helloworld)
    torch.cuda.empty_cache()
    rows.update(check_attic(torch, attic_v4, attic_v5, attic_v7, cfg))
    check_decode_v7_edges(torch, attic_v7)
    torch.cuda.empty_cache()
    check_tie_prone(torch, paged_prefill_tm, decode_mla_v2, prefill, paged_prefill, matmul, cfg,
                    mcfg)
    torch.cuda.empty_cache()

    print("phase 2: LlamaEngine at Llama-3-8B width, int8 KV, seed-0 weights")
    t0 = time.perf_counter()
    params = llama.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    print(f"  init_params {time.perf_counter() - t0:.1f} s")
    prompts, late = _prompts(np.random.default_rng(0), cfg.vocab_size)
    new_tokens = 16
    _build.reset_launches()
    outs, st, wall, reused, launches = run_engine(
        torch, serving, _build, cfg, params, prompts, late, new_tokens, profile=True,
        expect=LLAMA_SERVING)
    if any(len(o) != new_tokens for o in outs):
        raise AssertionError(f"token counts {[len(o) for o in outs]}")
    if reused != 256:
        raise AssertionError(f"the shared 256-token prefix was not reused ({reused})")
    missing = [k for k in SERVING_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    outs2 = run_engine(torch, serving, _build, cfg, params, prompts, late,
                       new_tokens, expect=LLAMA_SERVING)[0]
    if outs2 != outs:
        raise AssertionError("a second run from the same seed gave other tokens")
    print(f"  {len(outs)} requests (lengths {[len(p) for p in prompts + [late]]}), "
          f"{new_tokens} tokens each, radix reuse {reused} tokens, repeat run identical")
    print(f"  {st['prefill_steps']} prefill calls, {st['prefill_tok']} tokens, "
          f"{st['prefill_s']:.3f} s -> {st['prefill_tok'] / st['prefill_s']:.1f} prefill tok/s; "
          f"{st['decode_steps']} decode calls, {st['decode_tok']} tokens, "
          f"{st['decode_s']:.3f} s -> {st['decode_tok'] / st['decode_s']:.1f} decode tok/s, "
          f"{1e3 * st['decode_s'] / st['decode_steps']:.2f} ms/decode step; "
          f"wall {wall:.2f} s [{gpu}]")
    print(f"  launches in the run: {launches}; every prefill call exactly "
          f"{LLAMA_SERVING['prefill']}, every decode call exactly {LLAMA_SERVING['decode']}")
    # lm_head goes through quant_matmul_int8 (kernel A, L = 1) once per call
    if launches["w8a8_gemm_l1"] != st["prefill_steps"] + st["decode_steps"]:
        raise AssertionError(f"quant_matmul_int8 launched {launches['w8a8_gemm_l1']} times "
                             f"in {st['prefill_steps'] + st['decode_steps']} model calls")
    torch.cuda.empty_cache()

    # phase 17 runs here, on phase 2's weights before phase 4 pretiles them
    print("phase 17: the rest of the Llama serving surface (sampling, grammar bitmasks, "
          "multi-LoRA, pause / resume, the step functions, speculative decoding) at "
          "Llama-3-8B width")
    t0 = time.perf_counter()
    run_serving_surface(torch, serving, llama, env, _build, cfg, params, prompts, late,
                        new_tokens, outs, st, gpu)
    print(f"  phase 17 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phase 20 (e) runs here too, on phase 2's weights, which main hands to
    # the saver and holds no other reference to while they are paused
    print("phase 20 (e): MemorySaver on phase 2's Llama-3-8B weights (pause, resume, one "
          "engine prefill and decode call before and after)")
    dev = torch.device("cuda")
    saver = memsaver.MemorySaver()
    saver.track(params, tag="llama weights")
    del params
    params = _part(torch, dev, "e", lambda: run_memsaver(torch, serving, saver, "llama weights",
                                                         cfg, dev))
    del saver

    print("phase 3: small configs, card vs CPU plain versions")
    check_small_config(torch, llama)
    check_small_tm_engine(torch, llama, serving)
    check_small_tm2(torch, llama)
    check_small_mla(torch, deepseek_mla)
    check_small_qwen(torch, qwen_next)
    check_small_hm(torch, llama, serving)

    print("phase 4: the bench.py decode path (tm2 pages, pretiled banks, batch 128) "
          "at Llama-3-8B width")
    bench_launches = run_bench_path(torch, llama, _build, params, gpu)
    torch.cuda.empty_cache()

    # phases 9 and 10 run here, on phase 4's pretiled weights
    print("phase 9: the bench.py --bf16-kv decode path (bf16 hm pages, pretiled banks, batch "
          "128) at Llama-3-8B width")
    hm_launches, hm_variants, hm_int8_launches = run_bench_hm(torch, llama, env, _build,
                                                              params, gpu)
    print("phase 10: LlamaEngine on hm pages (int8_kv=False, and int8 with kv_layout='hm') "
          "at Llama-3-8B width")
    hm_engine_launches = run_hm_engines(torch, llama, serving, _build, params, prompts, late,
                                        new_tokens, gpu)
    print("phase 18 (f): SKT_FUSED_LM and SKT_FUSED_QGEMM on the bench.py decode path "
          "(tm2 pages, pretiled banks, batch 128) at Llama-3-8B width")
    t0 = time.perf_counter()
    route_launches = run_k2_routes(torch, llama, _build, params, gpu)
    print(f"  (f) {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    print("phase 5: MlaEngine at DeepSeek-V2-Lite width, seed-0 weights")
    t0 = time.perf_counter()
    mparams = deepseek_mla.init_params(mcfg, 0, "cuda")
    torch.cuda.synchronize()
    print(f"  init_params {time.perf_counter() - t0:.1f} s")
    mprompts, mlate = _prompts(np.random.default_rng(0), mcfg.vocab_size)
    _build.reset_launches()
    mouts, mst, mwall, mreused, mla_launches = run_engine(
        torch, serving, _build, mcfg, mparams, mprompts, mlate, new_tokens, profile=True,
        engine_cls=serving.MlaEngine, expect=MLA_SERVING, buckets=_MLA_ENGINE_BUCKETS)
    if any(len(o) != new_tokens for o in mouts):
        raise AssertionError(f"MLA token counts {[len(o) for o in mouts]}")
    if mreused != 256:
        raise AssertionError(f"MLA: the shared 256-token prefix was not reused ({mreused})")
    mouts2 = run_engine(torch, serving, _build, mcfg, mparams, mprompts, mlate, new_tokens,
                        engine_cls=serving.MlaEngine, expect=MLA_SERVING)[0]
    if mouts2 != mouts:
        raise AssertionError("MLA: a second run from the same seed gave other tokens")
    print(f"  {len(mouts)} requests (lengths {[len(p) for p in mprompts + [mlate]]}), "
          f"{new_tokens} tokens each, radix reuse {mreused} tokens, repeat run identical")
    print(f"  {mst['prefill_steps']} prefill calls, {mst['prefill_tok']} tokens, "
          f"{mst['prefill_s']:.3f} s -> {mst['prefill_tok'] / mst['prefill_s']:.1f} prefill "
          f"tok/s; {mst['decode_steps']} decode calls, {mst['decode_tok']} tokens, "
          f"{mst['decode_s']:.3f} s -> {mst['decode_tok'] / mst['decode_s']:.1f} decode tok/s, "
          f"{1e3 * mst['decode_s'] / mst['decode_steps']:.2f} ms/decode step; "
          f"wall {mwall:.2f} s [{gpu}]")
    print(f"  launches in the run: { {k: n for k, n in mla_launches.items() if n} }; every "
          f"decode call exactly {MLA_SERVING['decode']}, every prefill call exactly "
          f"{MLA_SERVING['prefill']} (no attention kernel)")
    torch.cuda.empty_cache()

    print("phase 6: the bench.py --config mla decode path (int8 combined latent cache, "
          "pretiled banks, batch 128) at DeepSeek-V2-Lite width")
    mla_bench_launches = run_mla_bench_path(torch, deepseek_mla, _build, mparams, mcfg, gpu)
    del mparams
    torch.cuda.empty_cache()

    print("phase 7: the bench.py --config qwen decode path (int8 banks, grouped expert GEMM, "
          "bf16 SSM pool, batch 128) at its full width")
    qwen_launches = run_qwen_bench_path(torch, qwen_next, _build, qcfg, gpu)
    torch.cuda.empty_cache()

    print("phase 8: the bench.py --config moe layer at EP = 1 (8 experts of DeepSeek-V3 "
          "width, 128 tokens top-8)")
    moe_launches = run_moe_bench_path(torch, parallel, _build, moe_data, gpu)
    torch.cuda.empty_cache()

    print("phase 11: the attentions surface (laser prefill, sparse estimator -> block-sparse "
          "paged prefill, top-k block decode, add_rmsnorm_bias) at full width")
    t0 = time.perf_counter()
    att_launches, rows["k15_sparse"] = run_attentions(torch, _build, prefill, sparse,
                                                      paged_prefill, norm, gpu)
    print(f"  phase 11 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 12: the soft-FP8 surface (mm_wfp8a16, gmm_wfp8a16, helloworld) at DeepSeek-V3 "
          "widths")
    t0 = time.perf_counter()
    fp8_launches = run_fp8_surface(torch, _build, matmul, quant, helloworld, moe_data, gpu)
    print(f"  phase 12 {time.perf_counter() - t0:.1f} s")
    del moe_data
    torch.cuda.empty_cache()

    print("phase 13: the attic (v5, v4b, the fused v4 pair, the v7 two-tier loop) at "
          "Llama-3-8B heads, batch 64")
    t0 = time.perf_counter()
    attic_launches = run_attic(torch, _build, attic_v4, attic_v5, attic_v7, cfg, gpu)
    print(f"  phase 13 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 14: the EP normal surface (dispatch / combine, notify_verify, long-seq, "
          "layered, fp8 / MX low-latency modes) through Buffer(None, 256) at DeepSeek-V3's "
          "prefill shape")
    t0 = time.perf_counter()
    run_ep_normal(torch, parallel, _build, env, gpu)
    print(f"  phase 14 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 15: models/deepseek_v3.py at DeepSeek-V3's widths (2 of 61 layers), EP = 1, "
          "batch 128")
    t0 = time.perf_counter()
    run_deepseek_v3(torch, _build, gpu)
    print(f"  phase 15 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 16: models/moe.py at Qwen1.5-MoE-A2.7B's widths, 24 layers, EP = 1, batch 128, "
          "f32 caches")
    t0 = time.perf_counter()
    qmoe_launches = run_qwen_moe(torch, _build, gpu)
    print(f"  phase 16 {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 18: HF checkpoints (Llama, MLA, Qwen3-Next at its published widths, the MoE "
          "bank), Llama TP")
    t18, phase18, phase19 = time.perf_counter(), {}, {}

    def f32_paths(qcfg_hf, qparams):
        print("phase 19 (a), (b): Qwen3-Next's f32 decode_step, forward_full and "
              "prefill_gdn_layer on phase 18 (c)'s f32 tree, before it is quantised")
        phase19["a"] = run_qwen_f32(torch, qwen_next, _build, qcfg_hf, qparams, gpu)

    for part, fn in (
            ("a", lambda: run_hf_llama(torch, serving, llama, loader, _build, prompts, late,
                                       new_tokens, gpu)),
            ("b", lambda: run_hf_mla(torch, serving, deepseek_mla, loader, _build, mcfg,
                                     mprompts, mlate, new_tokens, gpu)),
            ("c", lambda: run_hf_qwen_next(torch, qwen_next, loader, _build, gpu,
                                           f32_paths=f32_paths)),
            ("d", lambda: run_hf_moe_bank(torch, parallel, loader, _build, gpu))):
        t0 = time.perf_counter()
        phase18[part] = fn()
        print(f"  ({part}) {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    print(f"  phase 18 {time.perf_counter() - t18:.1f} s (19 (a) and (b) included)")

    print("phase 19 (c), (d): the default QwenNextConfig (bench.py --smoke's), and the GDN / "
          "conv / qkv_fusion surface at Qwen3-Next-80B-A3B's widths")
    t0 = time.perf_counter()
    phase19["c"] = run_qwen_default(torch, qwen_next, _build, gpu)
    print(f"  19 (c) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_gdn_surface(torch, _build, gpu)
    print(f"  19 (d) {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("phase 20 (a)-(d), (f): quant_ref's accuracy delta, the MLA cache modes, sinks, the "
          f"lightning indexer and compat [{gpu}]")
    t20 = time.perf_counter()
    _part(torch, dev, "a", lambda: run_quant_accuracy(torch, quant_ref, llama, deepseek_mla,
                                                      _build, mcfg, dev))
    _part(torch, dev, "b", lambda: run_mla_cache_modes(torch, mla_preprocess, decode,
                                                       deepseek_mla, _build, mcfg, dev))
    _part(torch, dev, "c", lambda: run_sinks(torch, sinks, _build, dev))
    _part(torch, dev, "d", lambda: run_lightning_indexer(torch, lightning_indexer, _build, dev))
    _part(torch, dev, "f", lambda: run_compat(torch, compat, deepseek_mla, _build, dev))
    print(f"  phase 20 (a)-(d), (f) {time.perf_counter() - t20:.1f} s")
    torch.cuda.empty_cache()

    print("phase 21: the attentions surface at public widths (DeepSeek-V3's MLA prefill, "
          "Qwen3-Next, SD3, Phi-3-mini, Falcon-7B, Gemma-3-1B, DeepSeek-V3.2-Exp's latent rows) "
          f"[{gpu}]; its sources built with the rest at the start: "
          + ", ".join(f"{k} {times[k]:.1f} s" for k in ("laser_attention",
                                                        "laser_attention_general",
                                                        "sparse_estimate", "topk_sparse")
                      if k in times))
    width_rows = run_attention_widths(torch, _build, compat, prefill, sparse, dev, gpu)
    torch.cuda.empty_cache()

    g8 = [r for r in gemm_rows if r["m"] == 8 and r["name"] != "lm_head"]
    base = "sgl_kernel_npu_tpu"
    src = "sgl_kernel_npu_tpu_torch/csrc"
    kernels = [
        dict(name="w8a8_gemm", route="cuda", source=f"{src}/w8a8_gemm_tiled.cu",
             replaces=f"{base}/ops/matmul.py:496", launches=launches["w8a8_gemm"],
             **_sum_rows(g8)),
        dict(name="prefill_tm", route="cuda", source=f"{src}/prefill_tm.cu",
             replaces=f"{base}/ops/attention/paged_prefill_tm.py:133",
             launches=launches["prefill_tm"], **rows["pre"]),
        dict(name="prefill_tm (prefix 512)", route="cuda", source=f"{src}/prefill_tm.cu",
             replaces=f"{base}/ops/attention/paged_prefill_tm.py:133",
             launches=launches["prefill_tm"], **rows["pre512"]),
        dict(name="decode_tm", route="cuda", source=f"{src}/decode_tm.cu",
             replaces=f"{base}/ops/attention/decode_v9.py:163",
             launches=launches["decode_tm"], **rows["dec"]),
        dict(name="append_tm", route="cuda", source=f"{src}/append_mla.cu",
             replaces=f"{base}/ops/attention/decode_v8.py:148",
             launches=launches["append_tm"], **rows["app"]),
        dict(name="append_tm (prefill chunk)", route="cuda", source=f"{src}/append_mla.cu",
             replaces=f"{base}/ops/attention/decode_v8.py:148",
             launches=launches["append_tm"], **rows["app_pre"]),
        dict(name="w8a8_gemm_tiled", route="cuda", source=f"{src}/w8a8_gemm_tiled.cu",
             replaces=f"{base}/ops/matmul.py:161",
             launches=bench_launches["w8a8_gemm_tiled"], **rows["k1"]),
        dict(name="rmsq_gemm", route="cuda", source=f"{src}/rmsq_gemm.cu",
             replaces=f"{base}/ops/rmsq_gemm.py:148",
             launches=bench_launches["rmsq_gemm"], **rows["k2"]),
        dict(name="decode_tm2", route="cuda", source=f"{src}/decode_tm2.cu",
             replaces=f"{base}/ops/attention/decode_v13.py:160",
             launches=bench_launches["decode_tm2"], **rows["k3"]),
        dict(name="decode_tm2 (phase 4 shape)", route="cuda", source=f"{src}/decode_tm2.cu",
             replaces=f"{base}/ops/attention/decode_v13.py:160", launches=0, **rows["k3p4"]),
        dict(name="append_tm2", route="cuda", source=f"{src}/append_tm2.cu",
             replaces=f"{base}/ops/attention/decode_v11.py:238",
             launches=bench_launches["append_tm2"], **rows["k4"]),
        dict(name="decode_tm (decode_v8 contract)", route="cuda", source=f"{src}/decode_tm.cu",
             replaces=f"{base}/ops/attention/decode_v8.py:388", launches=0, **rows["v8"]),
        dict(name="w8a8_gemm (L = 1 contract)", route="cuda",
             source=f"{src}/w8a8_gemm_tiled.cu",
             replaces=f"{base}/ops/matmul.py:71", launches=launches["w8a8_gemm_l1"],
             **rows["l1"]),
        dict(name="rmsq_gemm (apply_norm=False, wo + w2)", route="cuda",
             source=f"{src}/rmsq_gemm.cu", replaces=f"{base}/ops/rmsq_gemm.py:148",
             launches=(route_launches["SKT_FUSED_LM=1 SKT_FUSED_QGEMM=1"]["rmsq_gemm"]
                       - route_launches["SKT_FUSED_LM=1"]["rmsq_gemm"]), **rows["k2_qgemm"]),
        dict(name="rmsq_gemm (lm_head, f32 out)", route="cuda", source=f"{src}/rmsq_gemm.cu",
             replaces=f"{base}/ops/rmsq_gemm.py:148",
             launches=(route_launches["SKT_FUSED_LM=1"]["rmsq_gemm"]
                       - route_launches["off"]["rmsq_gemm"]), **rows["k2_lm"]),
        dict(name="rmsq_gemm (per_tensor)", route="cuda", source=f"{src}/rmsq_gemm.cu",
             replaces=f"{base}/ops/rmsq_gemm.py:148",
             launches=mla_bench_launches["rmsq_gemm_pt"], **rows["k2pt"]),
        dict(name="rmsq_gemm (per_tensor, M 8)", route="cuda", source=f"{src}/rmsq_gemm.cu",
             replaces=f"{base}/ops/rmsq_gemm.py:148", launches=mla_launches["rmsq_gemm_pt"],
             **rows["k2pt_m8"]),
        dict(name="decode_mla_c", route="cuda", source=f"{src}/decode_mla_c.cu",
             replaces=f"{base}/ops/attention/decode_mla_v2.py:409",
             launches=mla_bench_launches["decode_mla_c"], **rows["k5"]),
        dict(name="append_mla", route="cuda", source=f"{src}/append_mla.cu",
             replaces=f"{base}/ops/attention/decode_mla_v2.py:493",
             launches=mla_bench_launches["append_mla"], **rows["k6"]),
        dict(name="decode_mla", route="cuda", source=f"{src}/decode_mla.cu",
             replaces=f"{base}/ops/attention/decode.py:240",
             launches=mla_launches["decode_mla"], **rows["k7"]),
        dict(name="w8a8_gemm_grouped", route="cuda", source=f"{src}/w8a8_gemm.cu",
             replaces=f"{base}/ops/matmul.py:496",
             launches=qwen_launches["w8a8_gemm_grouped"], **rows["k8"]),
        dict(name="gdn_recurrent", route="cuda", source=f"{src}/gdn_recurrent.cu",
             replaces=f"{base}/ops/gdn/recurrent_pallas.py:136",
             launches=qwen_launches["gdn_recurrent"], **rows["k9"]),
        dict(name="gdn_recurrent (f32 pool)", route="cuda", source=f"{src}/gdn_recurrent.cu",
             replaces=f"{base}/ops/gdn/recurrent_pallas.py:136",
             launches=phase19["a"]["gdn_recurrent"], **rows["k9_f32"]),
        dict(name="gdn_recurrent (D 32)", route="cuda", source=f"{src}/gdn_recurrent.cu",
             replaces=f"{base}/ops/gdn/recurrent_pallas.py:136",
             launches=phase19["c"]["decode_step_q, bf16 pool"]["gdn_recurrent"],
             **rows["k9_d32"]),
        dict(name="gdn_recurrent (D 32, f32 pool)", route="cuda",
             source=f"{src}/gdn_recurrent.cu", replaces=f"{base}/ops/gdn/recurrent_pallas.py:136",
             launches=(phase19["c"]["decode_step, f32 pool"]["gdn_recurrent"]
                       + phase19["c"]["decode_step_q, f32 pool"]["gdn_recurrent"]),
             **rows["k9_d32_f32"]),
        dict(name="decode_hm", route="cuda", source=f"{src}/decode_hm.cu",
             replaces=f"{base}/ops/attention/decode_v2.py:97",
             launches=qwen_launches["decode_hm"], **rows["k10"]),
        dict(name="decode_hm_f32", route="cuda", source=f"{src}/decode_hm_f32.cu",
             replaces=f"{base}/ops/attention/decode_v2.py:97",
             launches=qmoe_launches["decode_hm_f32"], **rows["k10f32"]),
        dict(name="decode_hm (D 256)", route="cuda", source=f"{src}/decode_hm.cu",
             replaces=f"{base}/ops/attention/decode_v2.py:97",
             launches=phase18["c"]["decode_hm256"], **rows["k10_256"]),
        dict(name="w8a8_gemm_grouped (EP MoE shape)", route="cuda",
             source=f"{src}/w8a8_gemm.cu", replaces=f"{base}/ops/matmul.py:496",
             launches=moe_launches["w8a8_gemm_grouped"], **rows["k8moe"]),
        dict(name="fused_moe", route="cuda", source=f"{src}/fused_moe.cu",
             replaces=f"{base}/parallel/strategies/fused_moe_pallas.py:343",
             launches=moe_launches["fused_moe"], **rows["k11"]),
        dict(name="remote_scatter (dispatch)", route="cuda", source=f"{src}/remote_scatter.cu",
             replaces=f"{base}/parallel/strategies/pallas_ll.py:191",
             launches=moe_launches["remote_scatter"] // 2, **rows["k12"][0]),
        dict(name="remote_scatter (combine)", route="cuda", source=f"{src}/remote_scatter.cu",
             replaces=f"{base}/parallel/strategies/pallas_ll.py:191",
             launches=moe_launches["remote_scatter"] // 2, **rows["k12"][1]),
        dict(name="swiglu_quant", route="cuda", source=f"{src}/swiglu_quant.cu",
             replaces=f"{base}/ops/activation.py:79", launches=moe_launches["swiglu_quant"],
             **rows["k13"]),
        dict(name="decode_v6_defer", route="cuda", source=f"{src}/decode_v6.cu",
             replaces=f"{base}/ops/attention/decode_v6.py:309",
             launches=hm_launches["decode_v6_defer"], **rows["decode_v6_defer"]),
        dict(name="decode_v6_int8_defer", route="cuda", source=f"{src}/decode_v6.cu",
             replaces=f"{base}/ops/attention/decode_v6.py:168",
             launches=hm_int8_launches["decode_v6_int8_defer"],
             **rows["decode_v6_int8_defer"]),
        dict(name="prefill_hm", route="cuda", source=f"{src}/prefill_hm.cu",
             replaces=f"{base}/ops/attention/paged_prefill.py:134",
             launches=sum(n["prefill_hm"] for n in hm_engine_launches.values()),
             **rows["k15"]),
        dict(name="prefill_hm (int8)", route="cuda", source=f"{src}/prefill_hm.cu",
             replaces=f"{base}/ops/attention/paged_prefill.py:134",
             launches=hm_engine_launches["int8_kv=True, kv_layout='hm'"]["prefill_hm"],
             **rows["k15_int8"]),
        dict(name="prefill_hm (sparse T 8192 keep 0.25)", route="cuda",
             source=f"{src}/prefill_hm.cu", replaces=f"{base}/ops/attention/paged_prefill.py:134",
             launches=att_launches["prefill_hm (sparse T 8192 keep 0.25)"],
             **rows["k15_sparse"]),
        dict(name="decode_v3_defer", route="cuda", source=f"{src}/decode_v3.cu",
             replaces=f"{base}/ops/attention/decode_v3.py:492",
             launches=hm_variants["SKT_DECODE_ATTN=v3"]["decode_v3_defer"],
             **rows["decode_v3_defer"]),
        dict(name="decode_v3_int8_defer", route="cuda", source=f"{src}/decode_v3.cu",
             replaces=f"{base}/ops/attention/decode_v3.py:368",
             launches=hm_variants["int8 SKT_DECODE_ATTN=v3"]["decode_v3_int8_defer"],
             **rows["decode_v3_int8_defer"]),
        dict(name="decode_v3", route="cuda", source=f"{src}/decode_v3.cu",
             replaces=f"{base}/ops/attention/decode_v3.py:94",
             launches=hm_variants["SKT_DECODE_DEFER=0"]["decode_v3"], **rows["decode_v3"]),
        dict(name="decode_v3_int8", route="cuda", source=f"{src}/decode_v3.cu",
             replaces=f"{base}/ops/attention/decode_v3.py:217",
             launches=hm_variants["int8 SKT_DECODE_DEFER=0"]["decode_v3_int8"],
             **rows["decode_v3_int8"]),
        dict(name="decode_int8kv", route="cuda", source=f"{src}/decode_v3.cu",
             replaces=f"{base}/ops/attention/decode.py:366", launches=0,
             **rows["decode_int8kv"]),
    ]
    att = [(LASER_NAMES, "laser_attention.cu", "ops/attention/prefill.py:80"),
           (("sparse_estimate",), "sparse_estimate.cu", "ops/attention/sparse.py:323"),
           (TOPK_NAMES, "topk_sparse.cu", "ops/attention/sparse.py:231"),
           (NORM_NAMES, "add_rmsnorm_quant.cu", "ops/norm.py:70")]
    kernels += [dict(name=name, route="cuda", source=f"{src}/{cu}", replaces=f"{base}/{tpu}",
                     launches=att_launches[name], **rows[name])
                for names, cu, tpu in att for name in names]
    kernels.append(dict(name="sparse_estimate (T 32768, not causal)", route="cuda",
                        source=f"{src}/sparse_estimate.cu",
                        replaces=f"{base}/ops/attention/sparse.py:323", launches=0,
                        **rows["k18_long"]))
    kernels += [
        dict(name="wfp8a16_gemm", route="cuda", source=f"{src}/wfp8a16_gemm.cu",
             replaces=f"{base}/ops/matmul.py:309", launches=fp8_launches["wfp8a16_gemm"],
             **rows["k21"]),
        dict(name="wfp8a16_gemm (M 4096)", route="cuda", source=f"{src}/wfp8a16_gemm.cu",
             replaces=f"{base}/ops/matmul.py:309",
             launches=fp8_launches["wfp8a16_gemm (M 4096)"], **rows["k21_m4096"]),
        dict(name="wfp8a16_gemm_grouped", route="cuda", source=f"{src}/wfp8a16_gemm.cu",
             replaces=f"{base}/ops/matmul.py:381",
             launches=fp8_launches["wfp8a16_gemm_grouped"], **rows["k21g"]),
        dict(name="helloworld", route="cuda", source=f"{src}/helloworld.cu",
             replaces=f"{base}/ops/helloworld.py:36", launches=fp8_launches["helloworld"],
             **rows["k22"]),
    ]
    kernels += [dict(name=name, route="cuda",
                     source=f"{src}/{'decode_v7' if name == 'decode_v7_int8' else 'decode_v3'}"
                            ".cu",
                     replaces=f"attic/ops_attention/{ATTIC_TPU[name]}",
                     launches=attic_launches.get(name, 0), **rows[name])
                for name in ATTIC_TPU]
    idle = [k["name"] for k in kernels[-10:] if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on phases 12 and 13: {idle}")
    width_src = {"laser_attention": ("laser_attention.cu", "ops/attention/prefill.py:80"),
                 "laser_attention_general": ("laser_attention_general.cu",
                                             "ops/attention/prefill.py:80"),
                 "sparse_estimate": ("sparse_estimate.cu", "ops/attention/sparse.py:323"),
                 "topk_block_sparse": ("topk_sparse.cu", "ops/attention/sparse.py:231")}
    for name, row in width_rows.items():
        cu, tpu = width_src[name.split(" (")[0]]
        kernels.append(dict(name=name, route="cuda", source=f"{src}/{cu}",
                            replaces=f"{base}/{tpu}", **row))
    idle = [name for name, row in width_rows.items() if row["launches"] <= 0]
    if idle or len(width_rows) != len(WIDTH_LA) + len(WIDTH_EST) + len(WIDTH_TOPK):
        raise AssertionError(f"kernels never launched on phase 21: {idle}")
    idle = [k["name"] for k in kernels if k["name"] in (
        "decode_hm (D 256)", "rmsq_gemm (apply_norm=False, wo + w2)",
        "rmsq_gemm (lm_head, f32 out)") and k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on phase 18: {idle}")
    idle = [k["name"] for k in kernels if k["name"].startswith("gdn_recurrent (")
            and k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on phase 19: {idle}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print("rmsq_gemm (apply_norm=False, wo + w2) row: K2 as SKT_FUSED_QGEMM routes wo and w2 "
          "at M 128 (bf16 out), launches from phase 18 (f); rmsq_gemm (lm_head, f32 out) row: "
          "K2 as SKT_FUSED_LM routes lm_head (K 4096, N 128,256), launches from phase 18 (f)")
    print("w8a8_gemm row: sum of the four M=8 decode GEMMs on stacked banks (wqkv, wo, "
          "w13, w2); w8a8_gemm_tiled row: sum of wo, w2 and lm_head at M=128; rmsq_gemm "
          "row: sum of wqkv and w13 at M=128 (library: the GEMM part alone); prefill_tm rows "
          "(B): phase 1's bucket and the engine's largest call (256 tokens over 512), "
          "launches of both every prefill call's of phase 2; append_tm rows (D): the "
          "decode step's 8 rows and phase 2's first prefill chunk (8 x 512 rows), launches "
          "of both every call's of phase 2; every ms is warm (graph replay), and D's and K4's "
          "rows also carry cold_ms (calls cycling over more than twice the L2); launches "
          "of A-D and of the L = 1 contract (lm_head, its own counter) from phase 2, of "
          "K1-K4 from phase 4 (all its 128 steps); decode_tm2 rows (K3): 2 pages with "
          "0..1023 cached, and phase 4's shape (one page, 256..383 cached), each with its "
          "own bound, phase 4's launches on the first row only (the second shows 0 so that "
          "a sum of the launches counts K3 once); the decode_v8 contract is on no main "
          "path; rmsq_gemm (per_tensor) row: sum of wdqkv and wuq at M=128, launches of it, "
          "K5 and K6 from phase 6 (all its 64 steps), of K7 from phase 5; rmsq_gemm "
          "(per_tensor, M 8) row: wdqkv on the plain weight at the engine's decode "
          "batch, launches from phase 5 (every MLA engine call, prefill ones at larger "
          "M); decode_mla_c row: "
          "the int8 cache (decode_mla_v2.py:224 is the same contract, bf16); "
          "w8a8_gemm_grouped row (K8): sum of the expert w13 and w2 GEMMs at the Qwen bench "
          "shape; launches of K8-K10 from phase 7 (all its 32 steps); w8a8_gemm_grouped (EP "
          "MoE shape) row: GMM1 and GMM2 of rounds = 1 summed, launches from phase 8; "
          "decode_hm row (K10): "
          "decode_v2.py:97 is what decode.py::decode_gqa runs, decode.py:145 the same "
          "contract one page per grid step; decode_hm_f32 row (K10 on f32 pages, the same TPU "
          "kernels on f32 caches): phase 16's attention shape, launches from phase 16 (all its "
          "8 steps), library SDPA over the gathered f32 rows; decode_hm (D 256) row (K10 at "
          "head dim 256): Qwen3-Next-80B-A3B's attention shape, launches from phase 18 (c); "
          "gdn_recurrent (f32 pool) row (K9 on an f32 pool): Qwen3-Next-80B-A3B's GDN shape "
          "(128 sequences, 16 qk / 32 v heads of 128), launches from phase 19 (a); "
          "gdn_recurrent (D 32) rows (K9 at the default QwenNextConfig's heads, 4 qk / 8 v of "
          "32, batch 128): the bf16 pool, launches from phase 19 (c)'s decode_step_q on a "
          "bf16 pool, and the f32 pool, launches from its decode_step and decode_step_q on "
          "f32 pools; no library call computes the delta-rule step; "
          "fused_moe row (K11): one launch "
          "at the bench "
          f"shape, no library call computes it (the composition at rounds = 1, K8 twice and "
          f"glue, takes {comp_ms:.4f} ms); remote_scatter rows (K12): the quantising dispatch "
          "(no library call quantises and scatters) and the bf16 combine (library: "
          "index_copy_ of the same rows), each half of phase 8's launches (every K12 "
          "variant launches one of each); swiglu_quant row (K13): on no main path, held at "
          "GMM1's output shape; launches of K11 and K12 from phase 8 (every variant twice); "
          "decode_v6_defer (K14) row: the bench shape, launches from phase 9's bf16 run (all "
          "its 128 steps); decode_v6_int8_defer: the bench shape, launches from phase 9's "
          "SKT_KV_LAYOUT=hm int8 run; prefill_hm (K15) row: the bf16 pages, launches from "
          "phase 10 (the first run of each engine); prefill_hm (int8) row: the int8 pages, "
          "launches from phase 10's int8 hm engine; prefill_hm (sparse T 8192 keep 0.25) row: "
          "K15 alone on the page lists of phase 11's keep-0.25 mask, made before the timed "
          "call (library: SDPA with the mask spread to tokens), launches from phase 11's keep-0.25 drive; K16 rows (decode_v3*, decode_int8kv): the bench "
          "shape (bound: q . k and three p . v products at the bf16 tensor-core rate, as for "
          "K23), launches of the four v3 contracts from phase 9's SKT_DECODE_ATTN=v3 and "
          "SKT_DECODE_DEFER=0 runs on the bf16 and the int8 cache, decode_int8kv on no "
          "bench or engine run (no model calls it); K17-K20 rows: one row per phase-11 case, its "
          "launches that case's in phase 11 (the counts set to 0 first; each call twice, a "
          "warm-up and the timed calls), laser_attention rows causal T 8192, not causal T "
          "4096, causal T 8000 (bound at the bf16 tensor-core rate), sparse_estimate row the "
          "sparse prefill's [1, 8, 8192, 128] (keep 0.25 and 1.0; two launches a call, the "
          "pooling and the score kernel), its T 32768 row on no main path, topk_block_sparse rows "
          "bench_ops.py's shape and the latent rows (bound: each distinct block read once), "
          "add_rmsnorm_quant rows N 8192 and 128; wfp8a16_gemm (K21) row: the sum of "
          "gate_proj, down_proj and kv_a_proj_with_mqa at M 128 (library: torch.matmul on the "
          "pre-dequantised bf16 weight), its M 4096 row gate_proj, the grouped row GMM1 + "
          "GMM2 on phase 8's routed rows (library: torch.matmul per expert group), launches "
          "from phase 12 by case; helloworld (K22): [4096, 7168]; K23 rows (decode_v5*, "
          "decode_v4b_int8, decode_fused_v4*) and K24 (decode_v7_int8): 64 sequences of "
          "256..383 cached tokens at Llama-3-8B's heads, launches from phase 13; the rows "
          "named after a model (laser_attention*, sparse_estimate*, topk_block_sparse* with "
          "a width in brackets): phase 21's cases, launches from its pass 1 (two calls a "
          "case; K18 two kernels a call), library SDPA on the first backend that takes the "
          "shape (none for K18), bounds at the tensor-core rate for bf16 / fp16 inputs and "
          "at the f32 rate for f32 ones")
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all, the builds included")
    # D's, K4's and K10 f32's rows also carry cold_ms
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + ("cold_ms",) if k in kern}
                                  for kern in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
