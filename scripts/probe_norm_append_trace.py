#!/usr/bin/env python3
"""Trace the blocks of K20 (add_rmsnorm_quant), K6 and D (append_mla; D in
append_tm before it shared K6's loop) and K13 (swiglu_quant) on one card:
for each block its SM (%smid), its start and end (%globaltimer), and how
thread 0's time splits between phases (clock64 stamps, summed by phase and
scaled to ns by the block's own globaltimer span over its cycles; a block
that returns early, as a dropped row's does, leaves no record).

  python3 scripts/probe_norm_append_trace.py [--variants NAME,...] [--parent ROOT]

Kernels and shapes (chip_smoke.py's phase 1):
  * K20 at hidden 4096: bf16 at N 128 (a decode batch) and 8192 (a
    prefill), f32 at N 128; held to the plain version as chip_smoke.py holds
    it (h exact, int8 within K20_FLIP_SHARE);
  * K6 at the bench MLA path's shape (27 layers x 128 rows of 576 into 385
    pages of 128, one row dropped), int8 and bf16 rows, and at the MLA
    engine's batch of 8; exact;
  * D at check_append's two shapes (the decode step's 8 rows, a prefill
    chunk's 8 x 512); exact;
  * K13 at check_swiglu_quant's bench shape (2,048 x 4096 bf16, total
    1,024); within MOE_FLIP_SHARE and one scale ulp.
The sources of this checkout (and, with --parent, of ROOT: the kernels
before a redesign) are copied under build/norm_append_trace/, stamped there
(never in csrc/), and built twice, stamped and plain, by nvcc with
-Xptxas -v (registers and spills printed); each of --variants (VARIANTS
below) is built the same way from a copy of this checkout's sources with its
edits (only the sources it edits). A build's stamps follow its source: STAMPS holds a table for the
designs of this checkout and for the ones they replaced.

Prints, per case and build: the plain build's ms per call (CUDA graph of 50
calls, median of 5) and the stamped one's; blocks, waves, each wave's span,
a block's time (median, min, max), the most blocks an SM held at once, and
the phases' median ns a block; then the card's launch floor (an empty
kernel by the same graph replay) and its name and power limit. Writes every
block's record to chiprun_out/norm_append_trace.json. Needs one CUDA card
and nvcc; about a minute. A launch of more than 8,192 traced blocks keeps
only its summary there.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import probe_decode_trace as pdt  # noqa: E402  (its stamps' device code and summaries)

SOURCES = ("add_rmsnorm_quant", "append_mla", "append_tm", "swiglu_quant")
# source -> [(marker of the design, phase names, (anchor, count, before, after), ...)]
STAMPS = {
    "add_rmsnorm_quant": [
        # this checkout's: a block a row, every warp its own rstd
        ("row_rstd(", ("load", "reduce", "rstd", "apply"), (
            ("  const size_t row = (size_t)blockIdx.x * d;\n", 1, "", "  skt_tr_begin();\n"),
            ("  ss = warp_sum(ss);\n", 1, "  skt_tr(1);\n", ""),
            ("  const float rs = row_rstd(part, nt >> 5, lane, d, eps);\n", 1, "  skt_tr(2);\n",
             "  skt_tr(3);\n"),
            ("      *reinterpret_cast<int2*>(q + row + ch * 8) = out;\n    }\n  }\n", 1, "",
             "  skt_tr_end();\n"),
        )),
        # the design it replaced: a 256-thread block a row, thread 0's rstd
        ("rstd_s", ("load", "reduce", "rstd", "apply"), (
            ("  double ss = 0.0;\n", 1, "", "  skt_tr_begin();\n"),
            ("  ss = warp_sum(ss);\n", 1, "  skt_tr(1);\n", ""),
            ("  if (tid == 0) {\n    double t = 0.0;", 1, "  skt_tr(2);\n", ""),
            ("  const float rs = rstd_s;\n", 1, "  skt_tr(3);\n", ""),
            ("*reinterpret_cast<const int2*>(out);\n    }\n  }\n", 1, "", "  skt_tr_end();\n"),
        )),
    ],
    "append_mla": [
        # this checkout's: K6's and D's copy loop, a block a sequence over a
        # group of layers
        # (D's form, a block a (row, layer): the lookup in "issue", the copy
        # in "store")
        ("copy_rows<", ("issue", "page", "store"), (
            ("  const int b = blockIdx.x, g = blockIdx.y;\n", 1, "", "  skt_tr_begin();\n"),
            ("    if (page >= P || page < 0) return;\n", 1, "", "    skt_tr(2);\n"),
            ("    return;\n  }\n  const int page = __ldg(pages + b)", 1, "    skt_tr_end();\n",
             ""),
            ("      if (page < 0 || page >= P) return;\n", 1,
             "      skt_tr(1);\n", "      skt_tr(2);\n"),
            ("= v[p][u];\n      }\n    }\n  }\n", 1, "", "  skt_tr_end();\n"),
        )),
        # K6's design before D shared it
        ("ld16(", ("issue", "page", "store"), (
            ("  const int b = blockIdx.x, g = blockIdx.y;\n", 1, "", "  skt_tr_begin();\n"),
            ("    if (page < 0 || page >= P) return;\n", 1, "    skt_tr(1);\n",
             "    skt_tr(2);\n"),
            ("= v[u];\n      }\n    }\n  }\n", 1, "", "  skt_tr_end();\n"),
        )),
        # the design it replaced: a block a (row, layer)
        ("blockIdx.x, l = blockIdx.y", ("page", "copy"), (
            ("  const int b = blockIdx.x, l = blockIdx.y;\n", 1, "", "  skt_tr_begin();\n"),
            ("  if (page < 0 || page >= P) return;\n", 1, "", "  skt_tr(1);\n"),
            ("*reinterpret_cast<const int4*>(rows + src + c);\n", 1, "", "  skt_tr_end();\n"),
        )),
    ],
    "append_tm": [
        # D before it moved onto K6's loop: a block a (row, layer)
        ("append_tm_kernel(const int8_t*", ("page", "copy"), (
            ("  const int b = blockIdx.x, l = blockIdx.y;\n", 1, "", "  skt_tr_begin();\n"),
            ("  if (page < 0 || page >= P) return;\n", 1, "", "  skt_tr(1);\n"),
            ("*reinterpret_cast<const int4*>(vq + src + i);\n  }\n", 1, "",
             "  skt_tr_end();\n"),
        )),
    ],
    "swiglu_quant": [
        # this checkout's: chunks of 8 columns on the fast paths, kept in
        # registers across the row's absmax
        ("swiglu_fast", ("total", "load+swiglu", "reduce", "quant"), (
            ("  __shared__ float red[THREADS / 32];\n", 1, "", "  skt_tr_begin();\n"),
            ("  const bool active = r < S && r < total;\n", 1, "", "  skt_tr(1);\n"),
            ("  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(", 1,
             "  skt_tr(2);\n", ""),
            ("  if (r >= S) return;\n", 1, "  skt_tr(3);\n", ""),
            ("  if (t == 0) scale[r] = sc;\n", 1, "", "  skt_tr_end();\n"),
        )),
        # the design it replaced: a 256-thread block a row, read twice
        ("for (int j = tid; j < n; j += THREADS) amax", ("pass1", "reduce", "pass2"), (
            ("  __shared__ float red[THREADS / 32];\n", 1, "", "  skt_tr_begin();\n"),
            ("  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(", 1,
             "  skt_tr(1);\n", ""),
            ("  const float sc = __fmul_rn(amax, INV127);\n", 1, "  skt_tr(2);\n", ""),
            ("  if (tid == 0) scale[r] = sc;\n", 1, "", "  skt_tr_end();\n"),
        )),
    ],
}
# variant -> (old, new) edits, each made in every copied source that holds
# `old` (and in at least one)
G_RULE = "const int G = B >= sms ? 1 : (sms + B - 1) / B < L ? (sms + B - 1) / B : L;"
VARIANTS = {
    # K20: the prefill form at every N, or the decode form at every N
    "late": (("  if (N <= sms) {", "  if (N <= 0) {"),),
    "early": (("  if (N <= sms) {", "  if (N > 0) {"),),
    # K20: decode rows with two chunks a thread (256 threads at d 4096)
    "cpt2": (("const int cpt = chunks <= DECODE_THREADS ? 1 : 2;", "const int cpt = 2;"),),
    # K6: one block a sequence over every layer (128 blocks at B 128), or
    # four layer groups (512)
    "g1": ((G_RULE, "const int G = 1;"),),
    "g4": ((G_RULE, "const int G = L < 4 ? L : 4;"),),
    # K6: blocks of 128 threads; 2 or 8 vectors in flight a thread
    "t128": (("constexpr int THREADS = 256;\n", "constexpr int THREADS = 128;\n"),),
    "vpt2": (("constexpr int VPT = 4; ", "constexpr int VPT = 2; "),),
    "vpt8": (("constexpr int VPT = 4; ", "constexpr int VPT = 8; "),),
}
# K20's decode form with a part cut out, to time that part (wrong outputs,
# not checked): squares summed in f32 a chunk (one float64 conversion a
# chunk, not 8), no vector loads (constants), no output arithmetic
VARIANTS["nof64"] = (("      for (int j = 0; j < 8; ++j) ss += (double)hf[j] * (double)hf[j];",
                      "      float f = 0.f;\n      for (int j = 0; j < 8; ++j) f += hf[j] * hf[j];\n"
                      "      ss += (double)f;"),)
VARIANTS["novec"] = (("        load8(w + ch * 8, wv[c]);\n        load8(b + ch * 8, bv[c]);\n"
                      "        load8(qs + ch * 8, sv[c]);\n        load8(qo + ch * 8, ov[c]);\n",
                      "        for (int j = 0; j < 8; ++j) wv[c][j] = bv[c][j] = sv[c][j] = ov[c][j] = 1.f;\n"),)
VARIANTS["noquant"] = (("        out = quant8(hf, rs, wv[c], bv[c], sv[c], ov[c]);",
                        "        out = make_int2(__float_as_int(hf[0] * rs), 0);"),)
# K13 with a part cut out (wrong outputs, not checked): rows past the total
# leave q unwritten, x is not loaded (each value from its column), the
# SwiGLU is a product, the quantisation a copy
VARIANTS["k13nozero"] = (("    for (int c = t; c < nc; c += tpr) zero_chunk<VEC>(qrow, n, c);\n",
                          ""),)
VARIANTS["k13nox"] = (("    load8(row + j, g);\n    load8(row + n + j, u);\n",
                       "    for (int i = 0; i < CW; ++i) g[i] = u[i] = (float)(j + i) * 1e-3f;\n"),)
VARIANTS["k13noswiglu"] = (("out[i] = swiglu_fast<false>(g[i], u[i], limit, slow);",
                            "out[i] = g[i] * u[i];"),)
VARIANTS["k13noquant"] = (("for (int i = 0; i < CW; ++i) f[i] = quant_fast(v[i], rcp, near);",
                           "for (int i = 0; i < CW; ++i) f[i] = v[i];"),)
K13_CUTS = ("k13nozero", "k13nox", "k13noswiglu", "k13noquant")
UNCHECKED = ("nof64", "novec", "noquant") + K13_CUTS
# the cases a variant runs, where not all of its source's (K20's unchecked
# variants change only the decode form)
ONLY = {v: ("K20 N 128",) for v in UNCHECKED}
ONLY.update({v: ("K13 bf16",) for v in K13_CUTS})


def _design(src, source):
    for marker, phases, stamps in STAMPS[source]:
        if marker in src:
            return phases, stamps
    raise SystemExit(f"probe_norm_append_trace: {source}.cu holds no design STAMPS knows")


def _copies(roots, variants):
    """{(flavour, source): directory}: stamped and plain copies of each
    root's two sources (with the csrc/ headers) under build/norm_append_trace/,
    and of this checkout's with each variant's edits."""
    out = {}
    builds = [(tag, root, "") for tag, root in roots] + [("tree", HERE, v) for v in variants]
    for tag, root, variant in builds:
        csrc = os.path.join(root, "sgl_kernel_npu_tpu_torch", "csrc")
        for kind in ("plain", "stamped"):
            flavour = f"{tag} {variant} {kind}".replace("  ", " ")
            d = os.path.join(HERE, "build", "norm_append_trace", flavour.replace(" ", "_"))
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            for name in os.listdir(csrc):
                if name.endswith(".cuh") or name[:-3] in SOURCES:
                    shutil.copy(os.path.join(csrc, name), d)
            edited = set()
            for old, new in VARIANTS[variant] if variant else ():
                hits = 0
                for source in SOURCES:
                    path = os.path.join(d, f"{source}.cu")
                    if not os.path.exists(path):
                        continue
                    with open(path) as f:
                        text = f.read()
                    if old in text:
                        hits += 1
                        edited.add(source)
                        with open(path, "w") as f:
                            f.write(text.replace(old, new))
                if not hits:
                    raise SystemExit(f"probe_norm_append_trace: variant {variant}: no source "
                                     f"holds '{old}'")
            for source in SOURCES:
                path = os.path.join(d, f"{source}.cu")
                if (variant and source not in edited) or not os.path.exists(path):
                    continue                # as the tree's own build, or none here
                with open(path) as f:
                    src = f.read()
                phases, stamps = _design(src, source)
                if kind == "stamped":
                    src = src.replace("namespace {", pdt.PRELUDE + "\nnamespace {", 1)
                    src = pdt._stamp(src, stamps, f"{source}.cu") + pdt.EXPORT
                    with open(path, "w") as f:
                        f.write(src)
                out[(flavour, source)] = (d, phases, "int list_type" in src)
    return out


def _k13_call(torch, x, gl, total):
    """call(lib, groups_abi) of K13's launcher on x [S, 2N] bf16, without
    the limit: the group list (this checkout's C interface) or the total
    (the one before). Returns (q, scale)."""
    s, n = x.shape[0], x.shape[1] // 2
    q = torch.empty((s, n), dtype=torch.int8, device="cuda")
    sc = torch.empty((s,), dtype=torch.float32, device="cuda")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(lib, groups_abi):
        fn = lib.skt_swiglu_quant
        fn.restype = i
        stream = torch.cuda.current_stream().cuda_stream
        if groups_abi:
            fn.argtypes = [vp, vp, i, i, vp, vp, i, i, i, i, f, vp]
            code = fn(x.data_ptr(), gl.data_ptr(), gl.numel(), 1, q.data_ptr(), sc.data_ptr(),
                      s, n, 0, 0, 3.0, stream)
        else:
            fn.argtypes = [vp, vp, vp, vp, i, i, i, i, f, vp]
            code = fn(x.data_ptr(), total.data_ptr(), q.data_ptr(), sc.data_ptr(), s, n, 0, 0,
                      3.0, stream)
        if code:
            raise SystemExit(f"probe_norm_append_trace: K13 launch failed ({code})")
        return q, sc
    return call


def _cases(torch, cs):
    """{name: (sources, call, check)}: the case runs the first of `sources`
    that a build has, loaded as this checkout's _build loads that kernel's
    source; call(lib, groups_abi) calls it; check(out) raises unless out
    meets the plain version's bar."""
    from sgl_kernel_npu_tpu_torch.models import llama
    from sgl_kernel_npu_tpu_torch.ops import activation, norm
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_mla_v2 as dv2
    from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8 as dv8
    cases = {}
    for n, dtype in ((128, torch.bfloat16), (8192, torch.bfloat16), (128, torch.float32)):
        args = cs._norm_inputs(torch, n, 200 + n, dtype) + ()
        args = args[:4] + (1e-6,) + args[4:]
        want = norm.add_rmsnorm_bias_ref(*args)
        name = f"K20 N {n} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
        cases[name] = (("add_rmsnorm_quant",), lambda _l, _a, a=args: norm.add_rmsnorm_bias(*a),
                       lambda got, want=want, name=name: cs._norm_check(torch, name, got, want))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(600)
    for label, b, dtype in (("int8 phase 1", 128, torch.int8), ("bf16 phase 1", 128,
                                                                torch.bfloat16),
                            ("int8 engine B 8", 8, torch.int8)):
        new, cache, pg, off = cs._append_mla_inputs(torch, gen, 27, b, dtype)
        want = dv2.append_mla_ref(new, cache.clone(), pg, off)

        def check(got, want=want, label=label):
            if not torch.equal(got, want):
                raise AssertionError(f"K6 {label}: differs from its plain version")
        cases[f"K6 {label}"] = (("append_mla",),
                                lambda _l, _a, a=(new, cache, pg, off): dv2.append_mla(*a), check)
    cfg = llama.LlamaConfig(int8_kv=True)
    for label in ("decode", "prefill"):
        if label == "decode":
            pages, (kq, vq, pg, off) = 512, cs.append_tm_decode_inputs(torch, gen, cfg)
        else:
            pages, (kq, vq, pg, off) = 64, cs.append_tm_prefill_inputs(torch, gen, cfg)
        shape = (cfg.num_layers, pages, cfg.page_size * cfg.num_kv_heads, cfg.head_dim)
        kc, vc = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                                device="cuda") for _ in range(2))
        want = dv8.append_tm_int8_ref(kq, vq, kc.clone(), vc.clone(), pg, off)

        def check(got, want=want, label=label):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"D {label}: differs from its plain version")
        cases[f"D {label}"] = (("append_tm", "append_mla"),
                               lambda _l, _a, a=(kq, vq, kc, vc, pg, off): dv8.append_tm_int8(*a),
                               check)
    gen.manual_seed(13)
    x, gl = cs.k13_inputs(torch, gen, 2048, cs.MOE_F, torch.bfloat16, (600, 0, 424))
    rq, rsc = activation.swiglu_quant_ref(x, gl, 1)

    def k13_check(got):
        d = (got[0].int() - rq.int()).abs()
        if int(d.max()) > 1 or float((d > 0).double().mean()) > cs.MOE_FLIP_SHARE:
            raise AssertionError("K13: int8 beyond the flip bar")
        if not torch.equal(got[1], rsc):
            raise AssertionError("K13: scales differ")
    cases["K13 bf16"] = (("swiglu_quant",),
                         _k13_call(torch, x, gl, gl.sum().to(torch.int32).reshape(1)), k13_check)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose kernels are traced beside this one's")
    ap.add_argument("--variants", default="",
                    help="comma-separated names of VARIANTS to build besides the sources")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("probe_norm_append_trace: no CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import compare_builds as cmpb
    from sgl_kernel_npu_tpu_torch import _build

    roots = ([("parent", os.path.abspath(args.parent))] if args.parent else []) + [("tree", HERE)]
    variants = [v for v in args.variants.split(",") if v]
    floor_build = cs.start_launch_floor_build(_build)
    copies = _copies(roots, variants)
    libs = pdt._build_all({k: v[0] for k, v in copies.items()}, _build.nvcc_path(),
                          _build.NVCC_FLAGS)
    cs._warm_up_card(torch)
    cases = _cases(torch, cs)
    buf = torch.zeros(1 << 18, pdt.NREC, dtype=torch.int64, device="cuda")
    flavours = list(dict.fromkeys(f for f, _ in libs))
    report = {}
    for case, (sources, call, check) in cases.items():
        target = sources[-1]                # the source this checkout's _build loads
        for flavour in flavours:
            variant = flavour.split()[1] if len(flavour.split()) == 3 else ""
            source = next((s for s in sources if (flavour, s) in libs), None)
            if source is None or not case.startswith(ONLY.get(variant, "")):
                continue
            lib = libs[(flavour, source)]
            _build._libs[target] = lib

            def fn(lib=lib, abi=copies[(flavour, source)][2]):
                return call(lib, abi)
            out = fn()
            torch.cuda.synchronize()
            if variant not in UNCHECKED:
                check(out)
            ms = cmpb._graph_ms(torch, fn, 50)
            line = f"{case:18s} {flavour:18s} {ms:.4f} ms a call"
            if flavour.endswith("stamped"):
                lib.skt_trace_set.argtypes = [ctypes.c_void_p]
                buf.zero_()
                torch.cuda.synchronize()
                if lib.skt_trace_set(buf.data_ptr()) != 0:
                    raise SystemExit("probe_norm_append_trace: skt_trace_set failed")
                fn()
                torch.cuda.synchronize()
                lib.skt_trace_set(None)
                recs = [r for r in buf.cpu().tolist() if r[2] != 0]
                sm = pdt._summary(torch, recs, copies[(flavour, source)][1])
                # a launch of many blocks keeps its summary alone
                report[f"{case} {flavour}"] = dict(summary=sm,
                                                   records=recs if len(recs) <= 8192 else [])
                med, lo, hi = sm["block_us"]
                line += (f"; {sm['blocks']} blocks on {sm['sms']} SMs (at most {sm['per_sm_max']}"
                         f" at once on one), {sm['waves']} wave(s), span {sm['span_us']:.2f} us "
                         f"[{sm['wave_txt']}]; a block {med:.2f} us (min {lo:.2f}, max "
                         f"{hi:.2f}); phases (median us a block): "
                         + ", ".join(f"{k} {v:.2f}" for k, v in sm["phases_us"].items())
                         + f"; SM clock {sm['ghz']:.3f} GHz")
            print(line, flush=True)
        _build._libs.pop(target, None)
    cs.launch_floor(torch, floor_build)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "norm_append_trace.json"), "w") as f:
        json.dump(report, f)
    print(cs._gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
