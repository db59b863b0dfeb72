"""The port's CUDA sources set up every kernel per device.

A kernel's dynamic shared-memory limit (cudaFuncSetAttribute) and the
occupancy queries (cudaOccupancy*) belong to the device that is current
when they run. Behind a function-scope `static` flag they run once per
process, and a second card then launches with the first card's set-up, or
is refused. The sources keep a record per (kernel, device) instead
(csrc/device_once.cuh). This test reads the sources, so it runs without
nvcc or a card: it fails where a function that sets a kernel up, directly or
through the helpers, also declares a function-scope `static`.
"""

import glob
import os
import re

import pytest

from sgl_kernel_npu_tpu_torch import _build

SOURCES = sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))
                 + glob.glob(os.path.join(_build.CSRC, "*.cuh")))
# calls whose result belongs to one device
SETUP = re.compile(r"\bcudaFuncSetAttribute\b|\bcudaOccupancy\w*|\bensure_smem\b"
                   r"|\bresident_blocks\b")
# a function-scope static variable (compile-time constants excepted)
STATIC = re.compile(r"\bstatic\b(?!\s+constexpr\b)")
COMMENT_OR_STRING = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'',
                               re.S)
# what may follow a function's closing parenthesis before its body
QUALIFIERS = re.compile(r"\)\s*(?:const|noexcept|override|mutable|->\s*[\w:<>, ]+|\s)*$")


def function_bodies(text):
    """(name, body) of every outermost function body in C++ source text:
    comments and literals blanked, a body being a brace block opened right
    after a parameter list (and qualifiers) outside any other function."""
    text = COMMENT_OR_STRING.sub(lambda m: " " * len(m.group(0)), text)
    out, depth, start = [], 0, None
    for i, ch in enumerate(text):
        if ch == "{":
            if start is None and QUALIFIERS.search(text[max(0, i - 200):i]):
                start, depth = i, 0
            if start is not None:
                depth += 1
        elif ch == "}" and start is not None:
            depth -= 1
            if depth == 0:
                head = text[max(0, start - 200):start]
                name = re.findall(r"(\w+)\s*\(", head)
                out.append((name[0] if name else "?", text[start:i + 1]))
                start = None
    return out


def setup_behind_static(text):
    """The functions of `text` that set a kernel up and declare a
    function-scope static."""
    return [name for name, body in function_bodies(text)
            if SETUP.search(body) and STATIC.search(body)]


@pytest.mark.parametrize("path", SOURCES, ids=[os.path.basename(p) for p in SOURCES])
def test_setup_is_per_device(path):
    with open(path) as f:
        text = f.read()
    assert setup_behind_static(text) == [], (
        f"{os.path.basename(path)}: a kernel's set-up sits behind a function-scope static; "
        "use skt::ensure_smem / skt::resident_blocks (csrc/device_once.cuh)")


def test_sources_found():
    names = {os.path.basename(p) for p in SOURCES}
    assert "device_once.cuh" in names
    assert {f"{s}.cu" for s in _build.SOURCES} <= names


# the guards the sources had, each as the scan must flag it, and the helpers'
# use, which it must pass
FLAGGED = {
    "bool flag": """
template <int PS, typename T>
cudaError_t launch(const Args& a, int S, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);  // { in a comment }
    if (e != cudaSuccess) return e;
    set = true;
  }
  kern<<<grid, 256, smem, st>>>(a);
  return cudaGetLastError();
}""",
    "high-water": """
extern "C" int skt_decode(const void* q, int ps, void* stream) {
  const size_t smem = (size_t)G * ps * sizeof(float);
  static size_t allowed = 0;
  if (smem > allowed) {
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return 1;
    allowed = smem;
  }
  return 0;
}""",
    "occupancy": """
int run(void* stream) {
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 256, 0);
    resident = per_sm * 132;
  }
  return resident;
}""",
    "helper behind a flag": """
cudaError_t launch() {
  static bool ready = false;
  if (!ready) { if (skt::ensure_smem(kern, 100000)) return cudaErrorUnknown; ready = true; }
  return cudaSuccess;
}""",
}
PASSED = {
    "per device": """
cudaError_t launch(const Args& a, cudaStream_t st) {
  static constexpr int SMEM = 100000;
  const cudaError_t e = skt::ensure_smem(kern, (size_t)SMEM);
  if (e != cudaSuccess) return e;
  const char* s = "static bool set";
  kern<<<1, 128, SMEM, st>>>(a);
  return cudaGetLastError();
}""",
    "static elsewhere": """
EncodeTiled encode_fn() {
  static std::atomic<EncodeTiled> fn{nullptr};
  return fn.load();
}
cudaError_t launch() { return skt::ensure_smem(kern, 65536); }""",
}


@pytest.mark.parametrize("name", sorted(FLAGGED))
def test_scan_flags_a_process_wide_guard(name):
    assert len(setup_behind_static(FLAGGED[name])) == 1


@pytest.mark.parametrize("name", sorted(PASSED))
def test_scan_passes_per_device_setup(name):
    assert setup_behind_static(PASSED[name]) == []


def test_kernels_build_for_sm_90a():
    """Every source is compiled for sm_90a, Hopper's target with wgmma and
    setmaxnreg (plain sm_90 refuses them)."""
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


# --------------------------------------------------------------------------
# The kernels that split a row over blocks (K19, C, K10's (both forms),
# K14's, K16's, K23's and K24's pages, K7's context, K2's, K1's, A's and K8's K; K3 runs
# C's loop unsplit, its source scanned all the same) merge the splits'
# partials through a workspace,
# deterministically:
# no float atomics (their order changes from run to run, and a second call
# must be bit-identical), only integer arrival counters, each reset to 0 by
# the kernel that used it (the last block to arrive), never zeroed by the
# host before a call. A source is scanned with the csrc/ headers it includes
# (A, K1, K2 and K8 merge in csrc/w8a8_wgmma.cuh, C, K3, K10, K14, K16, K23
# and K24 in csrc/decode_tm_core.cuh). K5 splits a sequence over the CTAs of a thread
# block cluster and merges through distributed shared memory: no atomics at
# all.

SPLIT_SOURCES = ("topk_sparse.cu", "decode_tm.cu", "decode_tm2.cu", "decode_v6.cu",
                 "decode_v3.cu", "decode_hm.cu", "decode_hm_f32.cu", "decode_v7.cu",
                 "decode_mla.cu", "rmsq_gemm.cu",
                 "w8a8_gemm_tiled.cu", "w8a8_gemm.cu")
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
# an atomic call and the last name of the expression it targets
ATOMIC = re.compile(r"\b(atomic\w+)\s*\(\s*&?\s*((?:\w+\s*(?:\.|->)\s*)*\w+)")
INT_DECL = r"\b(?:int|unsigned|unsigned\s+int|int32_t|uint32_t)\s*\*\s*(?:__restrict__\s*)?{}\b"
# PTX reductions and atomics on floating-point data, in asm strings
PTX_FLOAT = re.compile(r"\b(?:red|atom)(?:\.\w+)*\.(?:f16|bf16|f32|f64|f16x2|bf16x2)\b")
MEMSET = re.compile(r"\bcudaMemset\w*\s*\(")
COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def merge_faults(text):
    """What breaks the split kernels' deterministic merge in C++ source text:
    an atomic that is not an integer add (or whose target is not declared an
    integer pointer), a floating-point PTX reduction, a host memset, or an
    arrival counter the source never resets to 0."""
    code = COMMENT.sub(" ", text)
    bare = COMMENT_OR_STRING.sub(lambda m: " " * len(m.group(0)), text)
    faults = []
    counters = set()
    for fn, target in ATOMIC.findall(bare):
        name = re.split(r"\.|->", target)[-1].strip()
        if fn not in ("atomicAdd", "atomicInc") or not re.search(INT_DECL.format(name), bare):
            faults.append(f"{fn} on {name}")
        else:
            counters.add(name)
    faults += [f"PTX {m}" for m in PTX_FLOAT.findall(code)]
    faults += ["host memset" for _ in MEMSET.findall(bare)]
    for name in sorted(counters):
        reset = re.compile(r"(?:\w+\s*(?:\.|->)\s*)?" + name + r"\s*\[[^\]]+\]\s*=\s*0\s*;")
        if not reset.search(bare):
            faults.append(f"{name} never reset to 0")
    return faults


def with_headers(name, seen=None):
    """The text of csrc/<name> followed by that of every csrc/ header it
    includes, directly or through another, each once."""
    seen = set() if seen is None else seen
    seen.add(name)
    with open(os.path.join(_build.CSRC, name)) as f:
        text = f.read()
    for inc in INCLUDE.findall(text):
        if inc not in seen and os.path.exists(os.path.join(_build.CSRC, inc)):
            text += "\n" + with_headers(inc, seen)
    return text


@pytest.mark.parametrize("name", SPLIT_SOURCES)
def test_split_merge_is_deterministic(name):
    text = with_headers(name)
    assert ATOMIC.search(COMMENT_OR_STRING.sub(" ", text)), f"{name}: no arrival counter"
    assert merge_faults(text) == [], f"{name}: {merge_faults(text)}"


MERGE_FLAGGED = {
    "float atomicAdd": """
__global__ void k(float* __restrict__ acc, const float* x) {
  atomicAdd(acc + threadIdx.x, x[threadIdx.x]);
}""",
    "float max through an int view": """
__global__ void k(float* m, float v) {
  atomicMax(reinterpret_cast<int*>(m), __float_as_int(v));
}""",
    "PTX float reduction": """
__device__ void add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(p), "f"(v));
}""",
    "counter never reset": """
__global__ void k(float* ws, int* __restrict__ arrivals, int S) {
  ws[blockIdx.x] = 1.f;
  __threadfence();
  if (atomicAdd(arrivals + blockIdx.y, 1) == S - 1) ws[0] = 0.f;
}""",
    "host memset per call": """
__global__ void k(int* __restrict__ arrivals, int S) {
  if (atomicAdd(arrivals + blockIdx.y, 1) == S - 1) arrivals[blockIdx.y] = 0;
}
extern "C" int launch(int* arrivals, int n, cudaStream_t st) {
  cudaMemsetAsync(arrivals, 0, n * sizeof(int), st);
  k<<<1, 1, 0, st>>>(arrivals, n);
  return 0;
}""",
}
MERGE_PASSED = {
    "arrival counter": """
struct Args { float* ws; int* arrivals; };
__global__ void k(const Args a, int S) {
  __shared__ int last;
  __threadfence();  // atomicAdd(&acc, x) in a comment
  if (threadIdx.x == 0) last = atomicAdd(a.arrivals + blockIdx.y, 1) == S - 1;
  __syncthreads();
  if (last && threadIdx.x == 0) a.arrivals[blockIdx.y] = 0;
}""",
}


def test_cluster_merge_has_no_atomics():
    """K5's CTAs meet through cluster barriers and distributed shared
    memory: its source (with its headers) holds no atomic, no PTX
    reduction, no host memset, and reads its peers only after a barrier."""
    text = with_headers("decode_mla_c.cu")
    bare = COMMENT_OR_STRING.sub(" ", text)
    assert not ATOMIC.search(bare)
    assert merge_faults(text) == []
    with open(os.path.join(_build.CSRC, "decode_mla_c.cu")) as f:
        own = COMMENT_OR_STRING.sub(" ", f.read())
    merge = own[own.index("void merge_out("):own.index("void __launch_bounds__")]
    kernel = own[own.index("decode_mla_c_kernel(const Args a)"):own.index("cudaError_t launch(")]
    assert "map_shared_rank" in merge
    first_sync = kernel.index("cl.sync()")
    for peer_read in ("map_shared_rank", "merge_out<"):
        assert first_sync < kernel.index(peer_read)


@pytest.mark.parametrize("name", sorted(MERGE_FLAGGED))
def test_merge_scan_flags_a_nondeterministic_merge(name):
    assert merge_faults(MERGE_FLAGGED[name]) != []


@pytest.mark.parametrize("name", sorted(MERGE_PASSED))
def test_merge_scan_passes_arrival_counters(name):
    assert merge_faults(MERGE_PASSED[name]) == []


def test_scan_reads_included_headers():
    """K1's source holds no merge of its own: the scan must reach the one
    in the header it includes, and that header must be the shared stage."""
    with open(os.path.join(_build.CSRC, "w8a8_gemm_tiled.cu")) as f:
        own = f.read()
    assert not ATOMIC.search(COMMENT_OR_STRING.sub(" ", own))
    assert "w8a8_wgmma.cuh" in INCLUDE.findall(own)
    assert ATOMIC.search(COMMENT_OR_STRING.sub(" ", with_headers("w8a8_gemm_tiled.cu")))


def test_arrival_counters_are_zeroed_once():
    """The counters are made zero once and then handed out as they are: the
    kernels reset what they use, so no call zeroes them again."""
    import torch
    dev = torch.device("cpu")
    first = _build.arrival_counters("test_counters", dev, 8)
    first[3] = 5
    again = _build.arrival_counters("test_counters", dev, 8)
    assert again is first and int(again[3]) == 5
    assert int(_build.arrival_counters("test_counters", dev, 4096)[3]) == 0
    assert int(first[3]) == 5                  # a larger set does not free the old one


@pytest.mark.parametrize("kernel,source,header", [
    ("w8a8_gemm", "w8a8_gemm_tiled", "w8a8_wgmma.cuh"),         # A
    ("w8a8_gemm_tiled", "w8a8_gemm_tiled", "w8a8_wgmma.cuh"),   # K1
    ("w8a8_gemm_grouped", "w8a8_gemm", "w8a8_wgmma.cuh"),       # K8
    ("decode_tm", "decode_tm", "decode_tm_core.cuh"),           # C
    ("decode_tm2", "decode_tm2", "decode_tm_core.cuh"),         # K3
    ("decode_v6_defer", "decode_v6", "decode_tm_core.cuh"),     # K14, bf16 pages
    ("decode_v6_int8_defer", "decode_v6", "decode_tm_core.cuh"),   # K14, int8 pages
    ("decode_hm", "decode_hm", "decode_tm_core.cuh"),           # K10
    ("decode_hm256", "decode_hm", "decode_tm_core.cuh"),        # K10 at head dim 256
    ("decode_v7_int8", "decode_v7", "decode_tm_core.cuh"),      # K24
] + [(name, "decode_v3", "decode_tm_core.cuh")               # K16's and K23's contracts
     for name in ("decode_v3", "decode_v3_int8", "decode_v3_defer", "decode_v3_int8_defer",
                  "decode_int8kv", "decode_v5_defer", "decode_v5_int8_defer",
                  "decode_v4b_int8", "decode_fused_v4_int8", "decode_fused_v4")])
def test_kernels_share_their_stage(kernel, source, header):
    """A and K8 run K1's int8 stage, K3, K10, K14, K16, K23 and K24 run C's
    loop: each
    kernel's source exports its launcher, includes the shared header, and
    holds no merge of its own (the scan above reaches the header's)."""
    assert _build.KERNELS[kernel] == source
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        own = f.read()
    assert header in INCLUDE.findall(own)
    assert re.search(r'extern "C" int skt_' + kernel + r"\(", own)
    assert not ATOMIC.search(COMMENT_OR_STRING.sub(" ", own))


def test_decode_hm_holds_k10_only():
    """csrc/decode_hm.cu exports K10's launchers (and their split counts)
    alone, at head dims 128 and 256, on the tensor-core loop with p kept in
    f32 (P_F32) over kv-head-major bf16 pages, and decode_v3.cu instantiates
    the loop with P_F32 in every mode it serves."""
    with open(os.path.join(_build.CSRC, "decode_hm.cu")) as f:
        own = f.read()
    assert re.findall(r'extern "C" int (skt_\w+)\(', own) == [
        "skt_decode_hm_splits", "skt_decode_hm", "skt_decode_hm256_splits", "skt_decode_hm256"]
    assert [k for k, v in _build.KERNELS.items() if v == "decode_hm"] == ["decode_hm",
                                                                          "decode_hm256"]
    code = COMMENT_OR_STRING.sub(" ", own)
    assert re.search(r"decode_body<KvHeadMajor, true, __nv_bfloat16, false, P_F32, IN_CACHE, "
                     r"NST, true>", code)
    assert re.search(r"decode_body<KvHeadMajor, true, __nv_bfloat16, false, P_F32, IN_CACHE, "
                     r"NST, true, D2>", code)
    with open(os.path.join(_build.CSRC, "decode_v3.cu")) as f:
        v3 = COMMENT_OR_STRING.sub(" ", f.read())
    assert re.search(r"decode_body<Layout, true, T, false, P_F32, MODE>", v3)
    for mode in ("IN_CACHE", "DEFER", "FUSED"):
        assert re.search(r"run<\w+, \w+, " + mode + r">", v3), mode


def test_no_source_includes_the_cuda_core_decode():
    """The CUDA-core decode loop (decode_hm.cuh) is gone: K10 (decode_hm.cu)
    and K24 (decode_v7.cu) instantiate the tensor-core loop, K24 in its
    TWO_TIER mode with K14's rounding (P_BF16), each on a ring depth of its
    own (NST) and reading the block table once a round (PAGE_ONCE), and no
    source includes the old header."""
    assert not os.path.exists(os.path.join(_build.CSRC, "decode_hm.cuh"))
    for path in SOURCES:
        with open(path) as f:
            assert "decode_hm.cuh" not in INCLUDE.findall(f.read()), os.path.basename(path)
    for source in ("decode_hm", "decode_v7"):
        with open(os.path.join(_build.CSRC, source + ".cu")) as f:
            own = f.read()
        assert INCLUDE.findall(own) == ["decode_tm_core.cuh"], source
        assert re.search(r"constexpr int NST = \d;", COMMENT_OR_STRING.sub(" ", own)), source
    with open(os.path.join(_build.CSRC, "decode_v7.cu")) as f:
        v7 = f.read()
    assert re.search(r"decode_body<HeadMajor, true, int8_t, false, P_BF16, TWO_TIER, NST, true>",
                     COMMENT_OR_STRING.sub(" ", v7))
    assert re.findall(r'extern "C" int (skt_\w+)\(', v7) == ["skt_decode_v7_int8_splits",
                                                              "skt_decode_v7_int8"]


def test_appends_share_one_copy_loop():
    """D and K6 run one copy loop: csrc/append_mla.cu exports both launchers
    and instantiates the loop once for each, fixed at compile time: one
    (rows, cache) pair with the lookup beside the loads for K6, two pairs
    with the lookup first for D; append_tm.cu is gone."""
    assert not os.path.exists(os.path.join(_build.CSRC, "append_tm.cu"))
    assert [k for k, v in _build.KERNELS.items() if v == "append_mla"] == ["append_tm",
                                                                            "append_mla"]
    with open(os.path.join(_build.CSRC, "append_mla.cu")) as f:
        text = f.read()
    assert re.findall(r'extern "C" int (skt_\w+)\(', text) == ["skt_append_mla", "skt_append_tm"]
    own = COMMENT_OR_STRING.sub(" ", text)
    assert re.findall(r"copy_rows<(\d), (true|false)>\(", own) == [("1", "false"),
                                                                    ("2", "true")]


def test_grouped_gemm_source_holds_k8_only():
    """csrc/w8a8_gemm.cu keeps K8 (on the int8 stage of w8a8_wgmma.cuh) and
    no other launcher."""
    with open(os.path.join(_build.CSRC, "w8a8_gemm.cu")) as f:
        own = f.read()
    assert re.findall(r'extern "C" int (skt_\w+)\(', own) == ["skt_w8a8_gemm_grouped"]
    assert [k for k, v in _build.KERNELS.items() if v == "w8a8_gemm"] == ["w8a8_gemm_grouped"]


def test_no_source_includes_the_retired_loop():
    """The register-prefetched mma.sync loop (w8a8_core.cuh) is gone: K8 and
    K11 run the int8 stage of w8a8_wgmma.cuh, and no source includes the
    old header."""
    assert not os.path.exists(os.path.join(_build.CSRC, "w8a8_core.cuh"))
    for path in SOURCES:
        with open(path) as f:
            assert "w8a8_core.cuh" not in INCLUDE.findall(f.read()), os.path.basename(path)
    for source in ("w8a8_gemm", "fused_moe"):
        with open(os.path.join(_build.CSRC, source + ".cu")) as f:
            assert "w8a8_wgmma.cuh" in INCLUDE.findall(f.read())


def test_k8_atomics_are_arrival_counters_only():
    """K8 (with the headers it includes) takes no atomic but the integer
    tickets of its arrival counters: none on a float, none on its output,
    and no host memset."""
    bare = COMMENT_OR_STRING.sub(" ", with_headers("w8a8_gemm.cu"))
    targets = {re.split(r"\.|->", t)[-1].strip() for _, t in ATOMIC.findall(bare)}
    assert targets == {"arrivals"}
    assert not PTX_FLOAT.search(COMMENT.sub(" ", with_headers("w8a8_gemm.cu")))
    assert not MEMSET.search(bare)


def _k11_source():
    """K11's source (comments and literals blanked but for the asm strings'
    text, which the fence scan reads) and its kernel's body."""
    with open(os.path.join(_build.CSRC, "fused_moe.cu")) as f:
        own = COMMENT.sub(" ", f.read())
    return own, own[own.index("fused_moe_kernel("):own.index("encode_rows_map(")]


def test_k11_runs_the_stage():
    """K11's GEMM items run the stage's device functions (TMA weight ring,
    the consumers' transpose and int8 wgmma loop, the staged epilogue) on
    128-row tiles, in persistent blocks sized by the co-resident count at
    the block's threads and shared memory."""
    own, kernel = _k11_source()
    for fn in ("produce_weights(", "consume_tile(", "store_tile<"):
        assert fn in kernel, fn
    assert re.search(r"constexpr int TM = W_BM;", own)
    assert re.search(r"resident_blocks\(fused_moe_kernel, THREADS, W_SMEM,", own)


def test_k11_fences_the_proxies_before_tma_reads_of_its_own_rows():
    """recv (phase S) and act (requant) are written inside the launch by
    generic stores on other SMs, and K11 reads them by TMA (the async proxy):
    after the acquire and before the first TMA load of those rows the reader
    fences the proxies, and the writers fence theirs before they signal."""
    own, kernel = _k11_source()
    assert "tma_load_3d(" in kernel
    acquire = kernel.index("spin_until(")
    fence = kernel.index("fence.proxy.async.global", acquire)
    assert fence < kernel.index("tma_load_3d(", acquire)
    signal = own[own.index("void signal("):own.index("float sigmoid_mul(")]
    assert signal.index("fence.proxy.async.global") < signal.index("atomicAdd(")


def test_k11_tiles_match_its_mirror():
    """fused_moe_pallas.k11_items mirrors K11's tiles: the stage's 128 x 256
    tile, requant items of 16 rows, chunks of 8."""
    from sgl_kernel_npu_tpu_torch.parallel.strategies import fused_moe_pallas as tfmp
    with open(os.path.join(_build.CSRC, "w8a8_wgmma.cuh")) as f:
        stage = f.read()
    own, _ = _k11_source()
    assert re.search(r"constexpr int W_BM = (\d+);", stage).group(1) == str(tfmp.TILE_M)
    assert re.search(r"constexpr int BN = (\d+);", stage).group(1) == str(tfmp.TILE_N)
    assert re.search(r"constexpr int RQ = (\d+);", own).group(1) == str(tfmp.RQ_ROWS)
    assert re.search(r"constexpr int CHUNK = (\d+);", own).group(1) == "8"
