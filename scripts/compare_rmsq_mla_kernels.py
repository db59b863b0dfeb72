#!/usr/bin/env python3
"""Time the port's fused RMSNorm-quant GEMM (K2) and paged MLA decode (K7)
from two checkouts on one card, in turns (a, b, b, a, repeated), at the
shapes of chip_smoke.py's phase 1, with their library yardsticks and, as a
control, the GEMM kernels A, K1, K8 and K11 (all four on K2's int8 stage,
csrc/w8a8_wgmma.cuh).

  python3 scripts/compare_rmsq_mla_kernels.py ROOT_A ROOT_B [ROUNDS]

Each turn is a fresh process that imports sgl_kernel_npu_tpu_torch from its
root (building the kernels there first, one nvcc per source in parallel),
keeps the card busy for a second so that its clocks ramp up, checks each
kernel against its plain version (phase 1's bars: K2 within 4 quant flips
with >= 99% of rows exact, K7 within one bf16 ulp plus 1e-4 of max|plain|,
A, K1 and K8 exact, K11's recv exact) and times every shape on the same
seeded inputs by replaying a CUDA graph of the calls (median of 5 replays).
The shapes: K2 per_token at Llama-3-8B's wqkv and w13 (M 128, banks
pretiled at 512); K2 per_tensor with the int32 bias and the fp16 cast at
DeepSeek-V2-Lite's wdqkv (M 128, bank pretiled at 1024) and wuq (an f32
column slice), and wdqkv on the plain weight at the MLA engine's M 8; K7 at
the MLA engine's decode (8 sequences of 41..701 tokens, 16 heads, 128-token
pages); A at the Llama engine's M 8 GEMMs; K1 at the bench path's M 128 wo
and w2 (banks pretiled at 512) and lm_head (at 768); K8 at the Qwen bench
path's expert w13; K11 at the MoE layer's bench shape. The yardsticks,
timed the same way in every turn: torch._int_mm with the epilogue on the
plain quantised rows (K2, the GEMM part only) and SDPA over rows gathered
beforehand (K7). Prints one JSON line per turn and, per shape, the median
over each checkout's turns and the ratio b / a, then the card's name and
power limit. ROUNDS (default 1) repeats a, b, b, a. Needs one CUDA card; a
turn takes about a minute.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 5
H, Q, KV, F, V = 4096, 4096, 1024, 14336, 128256           # Llama-3-8B
MH, QLORA, LKV, LROPE, NOPE, MHEADS, PS = 2048, 1536, 512, 64, 128, 16, 128
CACHED = (40, 127, 128, 129, 255, 384, 511, 700)


def _graph_ms(torch, fn, iters):
    """ms per call: `iters` calls captured in one CUDA graph, the median of
    REPS replays."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[REPS // 2]


def _flip_close(name, out, ref, flip):
    """chip_smoke.py's K2 bar: every element within 4 quant flips, >= 99%
    of rows bit-exact."""
    import torch
    a, b = out.double(), ref.double()
    if not bool(((a - b).abs() <= 1e-3 * b.abs() + 4 * flip).all()):
        raise AssertionError(f"{name}: max-abs {float((a - b).abs().max())} beyond 4 flips")
    exact = float(torch.isclose(a, b, rtol=1e-6, atol=1e-6).all(dim=-1).double().mean())
    if exact < 0.99:
        raise AssertionError(f"{name}: only {exact:.4f} of rows exact")


def _int_mm(torch, xq, w, xs, ws, bias=None):
    """torch._int_mm + the epilogue on a [K, N] weight (rows padded to 32
    below 17, as _int_mm asks)."""
    m, k = xq.shape
    xp = xq if m > 16 else torch.cat([xq, xq.new_zeros((32 - m, k))])

    def call():
        acc = torch._int_mm(xp, w)
        if bias is not None:
            acc = acc + bias
        y = acc.float() * ws[None]
        return y * xs if xs is not None else y
    return call


def _k2(torch, mm, rq, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    for name, k, n in (("wqkv", H, Q + 2 * KV), ("w13", H, 2 * F)):
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, 512)
        x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")).to(torch.bfloat16)
        beta = torch.zeros((k,), device="cuda")
        kw = dict(li=1, quant_mode="per_token", eps=1e-5, out_dtype=torch.bfloat16)

        def kernel():
            return rq.rmsnorm_quant_gemm(x, gamma, beta, wt, ws, **kw)
        _, scale = rq._row_stats(x, gamma, beta, True, 1e-5)
        _flip_close(f"K2 per_token {name}", kernel(),
                    rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, ws, **kw),
                    float(w[1].abs().max()) * float(ws[1].max()) * float(scale.max()))
        out[f"K2 per_token {name} M 128"] = _graph_ms(torch, kernel, 20)
        rstd, _ = rq._row_stats(x, gamma, beta, True, 1e-5)
        xq = torch.round((x.float() * rstd * gamma.float()[None] + beta[None]) / scale) \
            .clamp(-128, 127).to(torch.int8)
        wk = w[1].contiguous()
        out[f"_int_mm {name} M 128"] = _graph_ms(torch, _int_mm(torch, xq, wk, scale, ws[1]), 20)
        del w, wt, wk
    c = LKV + LROPE
    for name, m, k, n, bn, f32 in (("wdqkv", 128, MH, QLORA + c, 1024, False),
                                   ("wuq", 128, QLORA, MHEADS * (NOPE + LROPE), 1024, True),
                                   ("wdqkv plain", 8, MH, QLORA + c, None, False)):
        n_pad = -(-n // bn) * bn if bn else n
        w = torch.zeros((2, k, n_pad), dtype=torch.int8, device="cuda")
        w[..., :n] = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8,
                                   device="cuda")
        ds = torch.rand((2, n_pad), generator=gen, device="cuda") * 1e-3
        bias = torch.randint(-50, 50, (2, n_pad), generator=gen, dtype=torch.int32,
                             device="cuda")
        if f32:
            x = torch.randn((m, 2 * c + k), generator=gen, device="cuda")[:, c:c + k]
        else:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        gamma = 1 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
        beta = 0.05 * torch.randn((k,), generator=gen, device="cuda")
        qs, qo = torch.tensor([0.05], device="cuda"), torch.tensor([0.5], device="cuda")
        if bn:
            wt, dsl, bl, li = mm.pretile_weight_bank(w, bn), ds, bias, 1
        else:
            wt, dsl, bl, li = w[1], ds[1], bias[1], None
        kw = dict(li=li, quant_mode="per_tensor", eps=1e-6, quant_cast="fp16")

        def kernel():
            return rq.rmsnorm_quant_gemm(x, gamma, beta, wt, dsl, bl, qs, qo, **kw)
        _flip_close(f"K2 per_tensor {name}", kernel(),
                    rq.rmsnorm_quant_gemm_ref(x, gamma, beta, wt, dsl, bl, qs, qo, **kw),
                    float(w[1].abs().max()) * float(ds[1].max()))
        out[f"K2 per_tensor {name} M {m}"] = _graph_ms(torch, kernel, 20)
        rstd = rq._rstd(x, True, 1e-6)
        xq = torch.round(((x.float() * rstd * gamma[None] + beta[None]) / qs + qo)
                         .to(torch.float16).float()).clamp(-128, 127).to(torch.int8)
        wn = w[1][:, :n].contiguous()
        out[f"_int_mm {name} M {m}"] = _graph_ms(
            torch, _int_mm(torch, xq, wn, None, ds[1][:n], bias[1][:n]), 20)
        del w, wt, wn


def _k7(torch, dec, out):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(70)
    b, pages, mp = len(CACHED), 512, 64
    seq = torch.tensor(CACHED, dtype=torch.int32, device="cuda") + 1
    perm = (torch.randperm(pages - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    bt = torch.zeros((b, mp), dtype=torch.int32, device="cuda")
    at = 0
    for i, n in enumerate(seq.tolist()):
        k = -(-n // PS)
        bt[i, :k] = perm[at:at + k]
        at += k
    ckv = torch.randn((pages, PS, LKV), generator=gen, device="cuda").to(torch.bfloat16)
    kr = torch.randn((pages, PS, LROPE), generator=gen, device="cuda").to(torch.bfloat16)
    q = (1.5 * torch.randn((b, MHEADS, LKV + LROPE), generator=gen, device="cuda")) \
        .to(torch.bfloat16)
    sm = (NOPE + LROPE) ** -0.5
    args = (q, ckv, kr, seq, bt, sm, PS)
    o, ref = dec.decode_mla(*args).double(), dec.decode_mla_ref(*args).double()
    err = (o - ref).abs()
    if not bool((err <= 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()).all()):
        raise AssertionError(f"K7: max-abs {float(err.max()):.3g} beyond its bar")
    out["K7 decode_mla"] = _graph_ms(torch, lambda: dec.decode_mla(*args), 50)
    n = int(seq.max())
    kk = torch.cat([ckv[bt.long()].reshape(b, mp * PS, LKV),
                    kr[bt.long()].reshape(b, mp * PS, LROPE)], -1)[:, None, :n].contiguous()
    vv = kk[..., :LKV].contiguous()
    mask = (torch.arange(n, device="cuda")[None, :] < seq[:, None])[:, None, None, :]
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qq = q[:, None]

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                                    scale=sm)
    out["SDPA K7"] = _graph_ms(torch, sdpa, 50)


def _controls(torch, mm, quant, qn, cs, out):
    """A, K1, K8 and K11, timed beside K2 and K7 as controls."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    total = 0.0
    for k, n in ((H, Q + 2 * KV), (Q, H), (H, 2 * F), (F, H)):
        w = torch.randint(-127, 128, (2, k, n), generator=gen, dtype=torch.int8, device="cuda")
        ws = torch.rand((2, n), generator=gen, device="cuda") * 1e-3
        xq, xs = quant.per_token_quant_int8(torch.randn((8, k), generator=gen, device="cuda"))
        if not torch.equal(mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws),
                           mm.quant_matmul_int8_ref(xq, w[1], xs, ws[1])):
            raise AssertionError("A differs from its plain version")
        total += _graph_ms(torch, lambda: mm.quant_matmul_int8_stacked(xq, w, 1, xs, ws), 20)
        del w
    out["A (4 GEMMs, M 8)"] = total
    total = 0.0
    for k, n, layers, bn in ((Q, H, 2, 512), (F, H, 2, 512), (H, V, 1, 768)):
        w = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8,
                          device="cuda")
        ws = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3
        wt = mm.pretile_weight_bank(w, bn)
        del w
        xq, xs = quant.per_token_quant_int8(torch.randn((128, k), generator=gen, device="cuda"))
        li = layers - 1
        if not torch.equal(mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws),
                           mm.quant_matmul_int8_stacked_tiled_ref(xq, wt, li, xs, ws)):
            raise AssertionError("K1 differs from its plain version")
        total += _graph_ms(torch, lambda: mm.quant_matmul_int8_stacked_tiled(xq, wt, li, xs, ws),
                           20)
        del wt
    out["K1 (3 GEMMs, M 128)"] = total
    _k8_control(torch, mm, quant, qn, cs, gen, out)
    _k11_control(torch, cs, out)


def _k8_control(torch, mm, quant, qn, cs, gen, out):
    """K8 at the Qwen bench path's expert w13 (phase 1's shape), held exact."""
    qcfg = cs.qwen_bench_config(qn)
    e, topk, tile = qcfg.num_experts, qcfg.top_k, qn.MOE_TILE
    ids = torch.topk(torch.rand((128, e), generator=gen, device="cuda"), topk, dim=-1).indices
    ok, src, eid = qn.align_routes(ids, e, tile)
    kk, n = qcfg.hidden_size, 2 * qcfg.moe_intermediate_size
    bank = torch.randint(-127, 128, (e, n // 1024, kk, 1024), generator=gen, dtype=torch.int8,
                         device="cuda")
    ws = torch.rand((e, n), generator=gen, device="cuda") * 1e-3
    xq, xs = quant.per_token_quant_int8(torch.randn((128, kk), generator=gen, device="cuda"))
    tok = src // topk
    xg = torch.where(ok[:, None], xq[tok], 0).to(torch.int8)
    xsg = torch.where(ok[:, None], xs[tok], 0.0)
    args = (xg, bank, xsg, ws, eid, tile)
    if not torch.equal(mm.grouped_matmul_int8(*args), mm.grouped_matmul_int8_tiles_ref(*args)):
        raise AssertionError("K8 differs from its plain version")
    out["K8 (Qwen expert w13)"] = _graph_ms(torch, lambda: mm.grouped_matmul_int8(*args), 20)
    del bank


def _k11_control(torch, cs, out):
    """K11 at the MoE layer's bench shape, its recv held exact."""
    from sgl_kernel_npu_tpu_torch import parallel
    from sgl_kernel_npu_tpu_torch.parallel.strategies import (fused_moe_pallas, low_latency,
                                                              pallas_ll)
    data = cs.moe_bench_data(torch)
    kargs = cs._k11_args(torch, low_latency, pallas_ll, data[0], data[1], data[3:], cs.MOE_EL,
                         cs.MOE_T)
    g = parallel.EPGroup(None)
    recv = fused_moe_pallas.fused_moe_layer(*kargs, group=g, maxt=cs.MOE_T)[0]
    if not torch.equal(recv, fused_moe_pallas.fused_moe_layer_ref(*kargs, group=g,
                                                                  maxt=cs.MOE_T)[0]):
        raise AssertionError("K11's recv differs from its plain version")
    out["K11 fused_moe"] = _graph_ms(
        torch, lambda: fused_moe_pallas.fused_moe_layer(*kargs, group=g, maxt=cs.MOE_T), 10)


def _worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.models import qwen_next
    from sgl_kernel_npu_tpu_torch.ops import matmul, quant, rmsq_gemm
    from sgl_kernel_npu_tpu_torch.ops.attention import decode

    spec = importlib.util.spec_from_file_location("chip_smoke_of_root",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build([_build.KERNELS[k] for k in ("rmsq_gemm", "decode_mla", "w8a8_gemm",
                                              "fused_moe")])
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    out = {}
    _k2(torch, matmul, rmsq_gemm, out)
    torch.cuda.empty_cache()
    _k7(torch, decode, out)
    torch.cuda.empty_cache()
    _controls(torch, matmul, quant, qwen_next, cs, out)
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 1
    import torch
    if not torch.cuda.is_available():
        print("compare_rmsq_mla_kernels: no CUDA card", file=sys.stderr)
        return 2
    roots = {"a": os.path.abspath(sys.argv[1]), "b": os.path.abspath(sys.argv[2])}
    runs = {"a": [], "b": []}
    for side in ("a", "b", "b", "a") * rounds:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              roots[side]], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(f"{side} ({roots[side]}): {line}")
        runs[side].append(json.loads(line))
    print(f"{'shape':34s} {'a ms':>9s} {'b ms':>9s} {'b / a':>7s}")
    for key in runs["a"][0]:
        a = statistics.median(r[key] for r in runs["a"])
        b = statistics.median(r[key] for r in runs["b"])
        print(f"{key:34s} {a:9.4f} {b:9.4f} {b / a:7.3f}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
