#!/usr/bin/env python3
"""Trace the blocks of the paged GQA decodes on one card: for each block its
SM (%smid), its start and end (%globaltimer), and how its time splits between
phases (clock64 stamps of thread 0, summed by phase and scaled to ns by the
block's own globaltimer span over its cycles).

  python3 scripts/probe_decode_trace.py [--variants NAME,...] [ROOT]

Kernels and shapes:
  * K23 int8 (decode_v5_int8_defer, csrc/decode_v3.cu on the tensor-core loop
    of csrc/decode_tm_core.cuh) and K24 (decode_v7_int8, csrc/decode_v7.cu)
    at chip_smoke.py's phase 13 state (64 sequences of 256..383 cached
    tokens, Llama-3-8B's heads, 128-token pages, seed 350; K24's sidecar as
    chip_smoke.py's _v7_state makes it);
  * K10 (decode_hm) at compare_builds.py's "K10 qwen bench" shape (128
    sequences of 250..289 tokens, 16 query and 2 kv heads, pages of 128).
Each kernel source of ROOT (default: this checkout) is copied under
build/decode_trace/, stamped there (never in csrc/), and built twice,
stamped and plain, by nvcc with -Xptxas -v (registers and spills printed);
each of --variants (VARIANTS below: a ring depth or blocks an SM) is built
the same way from a copy with its edits.

The phases of the tensor-core loop: pro (q, the first loads, q fragments),
wait (cp.async wait and the barrier of a round), issue (the next round's
copies), scores (a scores round: K . q and the step maximum), softmax (the
rescale and p of a p . v round, into the transposes), pv (the p . v MMAs),
drain (the last waits), reduce (the warps' sums), merge (the split merge),
epi (the current token and the output). The phases of decode_hm.cuh's loop:
pro, scores, softmax, pv, tail (the sidecar, the current token, the output).

Prints, per kernel and build: blocks, waves (a wave: the blocks that start
before the first block of the launch ends, then the rest, and so on), each
wave's span, a block's time (median, min, max), the largest number of blocks
an SM held at once, the phases' median ns a block, the plain build's ms per
call (CUDA graph of 50 calls, median of 5) and the stamped one's, and the
card's name and power limit. Writes every block's record to
chiprun_out/decode_trace.json. Needs one CUDA card and nvcc; about two
minutes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NREC = 16
CORE_PHASES = ("pro", "wait", "issue", "scores", "softmax", "pv", "drain", "reduce", "merge",
               "epi", "side")
HM_PHASES = ("pro", "scores", "softmax", "pv", "tail")

# The trace's device state: a record of NREC u64 a block (smid, globaltimer at
# start and end, clock64 at start and end, then the phases' cycles), written
# by thread 0 where the pointer is set.
PRELUDE = r"""
__device__ unsigned long long* skt_trace_buf = nullptr;
__shared__ long long skt_tr_acc[12];
__shared__ long long skt_tr_prev, skt_tr_gt0, skt_tr_c0;
__shared__ int skt_tr_cur;
__device__ __forceinline__ unsigned long long skt_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void skt_tr_begin() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 12; ++i) skt_tr_acc[i] = 0;
    skt_tr_gt0 = (long long)skt_gt();
    skt_tr_c0 = clock64();
    skt_tr_prev = skt_tr_c0;
    skt_tr_cur = 0;
  }
}
__device__ __forceinline__ void skt_tr(int next) {
  if (threadIdx.x == 0) {
    const long long n = clock64();
    skt_tr_acc[skt_tr_cur] += n - skt_tr_prev;
    skt_tr_prev = n;
    skt_tr_cur = next;
  }
}
__device__ __forceinline__ void skt_tr_end() {
  skt_tr(11);
  if (threadIdx.x == 0 && skt_trace_buf != nullptr) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    unsigned long long* r = skt_trace_buf + blk * 16;
    r[0] = smid;
    r[1] = (unsigned long long)skt_tr_gt0;
    r[2] = skt_gt();
    r[3] = (unsigned long long)skt_tr_c0;
    r[4] = (unsigned long long)clock64();
    for (int i = 0; i < 11; ++i) r[5 + i] = (unsigned long long)skt_tr_acc[i];
  }
}
"""
EXPORT = r"""
extern "C" int skt_trace_set(void* p) {
  return (int)cudaMemcpyToSymbol(skt_trace_buf, &p, sizeof(p));
}
"""

# (anchor, count, text before it, text after it) in csrc/decode_tm_core.cuh
# (count 0: where the source has it; STAGES reads NST where the ring's depth
# is a parameter)
CORE_STAMPS = (
    ("  const size_t cur = ((size_t)b * a.hkv + h) * D;\n", 1, "  skt_tr_begin();\n", ""),
    ("      cp_wait<STAGES - 2>();\n", 1, "      skt_tr(1);\n", ""),
    ("      // last time round is free\n      __syncthreads();\n", 1, "",
     "      skt_tr(2);\n"),
    ("      const Stage<T>& s = stages[i % STAGES];\n", 1, "",
     "      skt_tr(kind == 0 ? 3 : 4);\n"),
    ("          const int tr = 16 * warp + half * TILE;", 1, "          skt_tr(4);\n", ""),
    ("          uint32_t pb[PARTS][2];\n", 1, "          skt_tr(5);\n", ""),
    ("  cp_commit();\n  cp_wait<0>();\n  __syncthreads();\n", 1, "  skt_tr(6);\n",
     "  skt_tr(7);\n"),
    ("  if (S > 1) {\n    float* part", 1, "  skt_tr(8);\n", ""),
    ("    if (!last) return;\n", 1, "    if (!last) skt_tr_end();\n", ""),
    ("  if (MODE == TWO_TIER) {\n    // the sidecar", 0, "  skt_tr(10);\n", ""),
    ("  if (MODE == IN_CACHE) {\n", 1, "  skt_tr(9);\n", ""),
    ("  if (S > 1 && tid == 0) a.arrivals[row] = 0;     // ready for the next call\n", 1,
     "", "  skt_tr_end();\n"),
)
# the same in csrc/decode_hm.cuh (the loop that K10 ran before it moved onto
# the tensor-core loop)
HM_STAMPS = (
    ("  __syncthreads();                                    // the last step's readers are "
     "done\n", 1, "  skt_tr(1);\n", ""),
    ("  __syncthreads();\n  for (int g = warp; g < G; g += WARPS) {\n    float mt = NEG;\n", 1,
     "  skt_tr(2);\n", ""),
    ("  __syncthreads();\n  float o[G][2];\n", 1, "  skt_tr(3);\n", ""),
    ("  const int h = blockIdx.x, b = blockIdx.y;\n", 1, "", "  skt_tr_begin();\n"),
    ("  if (MODE == TWO_TIER) {\n    const int nside", 1, "  skt_tr(4);\n", ""),
    ("          __floats2bfloat162_rn(a0 / l, a1 / l);\n    }\n  }\n", 1, "",
     "  skt_tr_end();\n"),
)


def _stamp(src, stamps, name):
    for anchor, count, before, after in stamps:
        if "STAGES" in anchor and anchor not in src:
            anchor = anchor.replace("STAGES", "NST")
        if count == 0:
            if anchor not in src:
                continue
            count = 1
        if src.count(anchor) != count:
            raise SystemExit(f"probe_decode_trace: {name} no longer holds "
                             f"'{anchor.strip()[:60]}' {count} time(s)")
        src = src.replace(anchor, before + anchor + after)
    return src


def _header_of(src):
    """The csrc header a kernel source's loop lives in."""
    return "decode_hm.cuh" if '#include "decode_hm.cuh"' in src else "decode_tm_core.cuh"


SOURCES = ("decode_v3", "decode_hm", "decode_v7")
ROW_OF = """  auto row_of = [&](int t) -> size_t {
    const int pg = pow2 ? t >> shift : t / a.ps, slot = t - pg * a.ps;
    return Layout::row(layer + __ldg(btb + pg), slot, h, a.ps, a.hkv, a.P);
  };"""
ROW_OF_HOISTED = """  const int pgh = pow2 ? t0 >> shift : t0 / a.ps;
  const size_t pageh = layer + __ldg(btb + pgh);
  auto row_of = [&](int t) -> size_t {
    return Layout::row(pageh, t - pgh * a.ps, h, a.ps, a.hkv, a.P);
  };"""
# variant -> (old, new) edits, each made in every copied source and header
# that holds `old` (and in at least one)
VARIANTS = {
    # the loop before its ring depth was a parameter: 2 stages, 4 blocks an SM
    "s2b4": (("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
             ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 4)")),
    # a kernel on a 2-stage ring at 4 blocks an SM (K24) on a 3-stage one at
    # 3 (K10's), or at 5 blocks an SM
    "s3b3": (("constexpr int NST = 2;", "constexpr int NST = 3;"),
             ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 3)")),
    "b5": (("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 5)"),),
    # K10 on K24's ring: 2 stages, 4 blocks an SM (S 2 at the bench shape)
    "s2b4k10": (("constexpr int NST = 3;", "constexpr int NST = 2;"),
                ("__launch_bounds__(THREADS, 3) decode_hm_kernel",
                 "__launch_bounds__(THREADS, 4) decode_hm_kernel")),
    # every kernel's rounds read the block table once (right where no round
    # crosses a page, as at the probe's shapes; K10 and K24 do so already,
    # right at every shape: PAGE_ONCE)
    "hoist": ((ROW_OF, ROW_OF_HOISTED),),
    # no copies at all: the loop's compute and barriers alone (wrong outputs,
    # not checked)
    "nocp": (("cp_async16(&s.r[r][c], (r < krows ? kc : vc) + row * (D * sizeof(T)) + c, ok);",
              "(void)row;"),),
}
UNCHECKED = ("nocp",)


def _copies(root, variants):
    """{(build, source): directory}: stamped and plain copies of ROOT's
    csrc/ under build/decode_trace/, as they are and with each variant's
    edits."""
    csrc = os.path.join(root, "sgl_kernel_npu_tpu_torch", "csrc")
    out = {}
    for variant in [""] + list(variants):
        for kind in ("plain", "stamped"):
            flavour = f"{kind} {variant}".strip()
            d = os.path.join(HERE, "build", "decode_trace", flavour.replace(" ", "_"))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            for old, new in VARIANTS[variant] if variant else ():
                hits = 0
                for name in os.listdir(d):
                    path = os.path.join(d, name)
                    with open(path) as f:
                        text = f.read()
                    if old in text:
                        hits += 1
                        with open(path, "w") as f:
                            f.write(text.replace(old, new))
                if not hits:
                    raise SystemExit(f"probe_decode_trace: variant {variant}: no source holds "
                                     f"'{old}'")
            for source in SOURCES:
                path = os.path.join(d, f"{source}.cu")
                with open(path) as f:
                    src = f.read()
                hdr = _header_of(src)
                if kind == "stamped":
                    src = src + EXPORT
                    hpath = os.path.join(d, hdr)
                    with open(hpath) as f:
                        h = f.read()
                    if "skt_trace_buf" not in h:
                        h = h.replace("namespace {", PRELUDE + "\nnamespace {", 1) if \
                            hdr == "decode_tm_core.cuh" else h.replace(
                                "namespace skt_hm {", PRELUDE + "\nnamespace skt_hm {", 1)
                        h = _stamp(h, CORE_STAMPS if hdr == "decode_tm_core.cuh" else HM_STAMPS,
                                   hdr)
                        with open(hpath, "w") as f:
                            f.write(h)
                    with open(path, "w") as f:
                        f.write(src)
                out[(flavour, source)] = d
    return out


def _build_all(copies, nvcc, flags):
    procs = {}
    for (flavour, source), d in copies.items():
        so = os.path.join(d, f"{source}.so")
        procs[(flavour, source)] = (subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-o", so, os.path.join(d, f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe_decode_trace: nvcc {key} failed:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                       if "Used " in ln})
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0")
                         and " 0 bytes spill stores, 0 bytes spill loads" not in ln})
        print(f"  ptxas {key[0]} {key[1]}: {', '.join(regs)}"
              + (f"; spills: {spills}" if spills else "; no spill"), flush=True)
        lib = ctypes.CDLL(so)
        err = getattr(lib, f"skt_{key[1]}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        libs[key] = lib
    return libs


def _waves(recs):
    """Waves of a launch's blocks: the blocks that start before the first
    of the remaining blocks ends, then again with the rest."""
    left = sorted(recs, key=lambda r: r[1])
    waves = []
    while left:
        first_end = min(r[2] for r in left)
        wave = [r for r in left if r[1] < first_end]
        waves.append(wave)
        left = [r for r in left if r[1] >= first_end]
    return waves


def _summary(torch, recs, phases):
    t0 = min(r[1] for r in recs)
    span = (max(r[2] for r in recs) - t0) / 1e3
    dur = [(r[2] - r[1]) / 1e3 for r in recs]
    waves = _waves(recs)
    per_sm = {}
    for r in recs:
        per_sm.setdefault(r[0], []).append((r[1], r[2]))
    most = 0
    for ivs in per_sm.values():
        for s, _ in ivs:
            most = max(most, sum(1 for a, b in ivs if a <= s < b))
    ph = {}
    for i, name in enumerate(phases):
        vals = []
        for r in recs:
            cyc = max(r[4] - r[3], 1)
            vals.append(r[5 + i] * (r[2] - r[1]) / cyc / 1e3)
        ph[name] = statistics.median(vals)
    wave_txt = "; ".join(
        f"wave {i + 1}: {len(w)} blocks, {(min(r[1] for r in w) - t0) / 1e3:.2f}.."
        f"{(max(r[2] for r in w) - t0) / 1e3:.2f} us" for i, w in enumerate(waves))
    return dict(blocks=len(recs), span_us=span, waves=len(waves), wave_txt=wave_txt,
                block_us=(statistics.median(dur), min(dur), max(dur)), per_sm_max=most,
                sms=len(per_sm), phases_us=ph,
                ghz=statistics.median((r[4] - r[3]) / max(r[2] - r[1], 1) for r in recs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--variants", default="",
                    help="comma-separated names of VARIANTS to build besides the sources")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(HERE, "scripts")]
    import torch
    if not torch.cuda.is_available():
        print("probe_decode_trace: no CUDA card", file=sys.stderr)
        return 2
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import compare_builds as cmpb
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.attic.ops_attention import decode_v5, decode_v7
    from sgl_kernel_npu_tpu_torch.models import llama
    from sgl_kernel_npu_tpu_torch.ops.attention import decode

    variants = [v for v in args.variants.split(",") if v]
    libs = _build_all(_copies(root, variants), _build.nvcc_path(), _build.NVCC_FLAGS)
    st = cs._attic_state(torch, llama.LlamaConfig(int8_kv=True), 350)
    k, v, ks, vs = cs._hm_pages(torch, st["gen"], st["pages"], st["hkv"], st["ps"], st["d"],
                                True)
    a23 = (st["q"], st["kn"], st["vn"], k, v, ks, vs, st["cached"], st["bt"], st["sm"],
           st["ps"])
    ref23 = decode_v5.decode_gqa_v5_defer_ref(st["q"], st["kn"], st["vn"], k, v, st["cached"],
                                              st["bt"], st["sm"], k_scales=ks, v_scales=vs)
    s7 = cs._v7_state(torch, st)
    a24 = (st["q"], None, st["kn"], st["vn"], s7["k"], s7["v"], s7["ks"], s7["vs"], s7["kside"],
           s7["vside"], s7["rows"], st["cached"], st["bt"], st["sm"], st["ps"])
    ref24 = decode_v7.decode_gqa_v7_int8_ref(*a24)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    b, hq, hkv, d, ps, mp = 128, 16, 2, 128, 128, 3
    pages = b * mp + 1
    kc, vc = (torch.randn((hkv, pages, ps, d), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    seq = torch.randint(250, 290, (b,), generator=gen, device="cuda", dtype=torch.int32)
    bt = (torch.randperm(pages - 1, generator=gen, device="cuda")[: b * mp]
          .reshape(b, mp).to(torch.int32) + 1)
    q = (1.5 * torch.randn((b, hq, d), generator=gen, device="cuda")).to(torch.bfloat16)
    a10 = (q, kc, vc, seq, bt, d ** -0.5, ps)
    ref10 = decode.decode_gqa_hm_ref(*a10)
    cases = {"K23 int8 phase 13": ("decode_v3", lambda: decode_v5.decode_gqa_v5_int8_defer(*a23),
                                   ref23, cs.HM_SHARE),
             "K24 phase 13": ("decode_v7", lambda: decode_v7.decode_gqa_v7_int8(*a24), ref24,
                              cs.K14_SHARE),
             "K10 qwen bench": ("decode_hm", lambda: decode.decode_gqa_hm(*a10), ref10,
                                cs.K10_SHARE)}
    cs._warm_up_card(torch)
    buf = torch.zeros(1 << 16, NREC, dtype=torch.int64, device="cuda")
    flavours = list(dict.fromkeys(f for f, _ in libs))
    report = {}
    for case, (source, fn, ref, share) in cases.items():
        for flavour in flavours:
            if (flavour, source) not in libs:
                continue
            _build._libs.pop(source, None)
            _build._libs[source] = libs[(flavour, source)]
            out = fn()
            torch.cuda.synchronize()
            if not any(flavour.endswith(" " + u) for u in UNCHECKED):
                cs._bf16_check(f"{case} {flavour}", out, ref, share)
            ms = cmpb._graph_ms(torch, fn, 50)
            line = f"{case:20s} {flavour:13s} {ms:.4f} ms a call"
            if flavour.startswith("stamped"):
                lib = libs[(flavour, source)]
                lib.skt_trace_set.argtypes = [ctypes.c_void_p]
                buf.zero_()
                torch.cuda.synchronize()
                if lib.skt_trace_set(buf.data_ptr()) != 0:
                    raise SystemExit("probe_decode_trace: skt_trace_set failed")
                fn()
                torch.cuda.synchronize()
                lib.skt_trace_set(None)
                rows = buf.cpu().tolist()
                recs = [r for r in rows if r[2] != 0]
                phases = CORE_PHASES if _header_of(open(os.path.join(
                    HERE, "build", "decode_trace", flavour.replace(" ", "_"),
                    f"{source}.cu")).read()) == "decode_tm_core.cuh" else HM_PHASES
                sm = _summary(torch, recs, phases)
                report[f"{case} {flavour}"] = dict(summary=sm, records=recs)
                med, lo, hi = sm["block_us"]
                line += (f"; {sm['blocks']} blocks on {sm['sms']} SMs (at most {sm['per_sm_max']}"
                         f" at once on one), {sm['waves']} wave(s), span {sm['span_us']:.2f} us "
                         f"[{sm['wave_txt']}]; a block {med:.2f} us (min {lo:.2f}, max "
                         f"{hi:.2f}); phases (median us a block): "
                         + ", ".join(f"{k} {v:.2f}" for k, v in sm["phases_us"].items())
                         + f"; SM clock {sm['ghz']:.3f} GHz")
            print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "decode_trace.json"), "w") as f:
        json.dump(report, f)
    print(cs._gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
