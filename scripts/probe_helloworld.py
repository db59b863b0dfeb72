#!/usr/bin/env python3
"""Pick the shape of the bf16 add (K22): time variants of its loop beside
the port's kernel and torch.add, on one card.

  python3 scripts/probe_helloworld.py

Builds one source of variants under build/hello_probe/ (nvcc, as _build.py
builds the kernels): the loop over 16-byte vectors either grid-stride over
one wave of resident blocks or one-shot (one block per THREADS * U vectors,
as PyTorch's elementwise kernels run), with U vectors of each operand a
thread loads before its first add (T apart, or two by two adjacent), and
each load and store with or without a cache hint (ld.global.nc,
ld.global.nc.L1::no_allocate, ld.global.cs, the 256-byte L2 prefetch
size; st.global.cs); and blocks that bring 16, 32 or 64 KB of each operand
into shared memory by bulk copies (TMA) and write the sum back by one bulk
store (its wait traps after 2^26 polls rather than hang). Checks each
against x + y bit for bit and times each at
chip_smoke.py's shape ([4096, 7168] bf16) by replaying a CUDA graph of the
calls (median of 5), torch.add and the port's kernel first and last.
Prints one JSON line of ms per variant, then the card's name and power
limit. Needs one CUDA card and nvcc; under a minute.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SHAPE = (4096, 7168)
# name -> (threads, U, one-shot, load hint, store hint, pairs); load hints:
# 0 none, 1 nc, 2 nc.L1::no_allocate, 3 cs, 4 nc.L2::256B, 5 L2::256B; store
# hints: 0 none, 1 cs; pairs: a thread's vectors two by two adjacent (32
# bytes), so that a warp's load covers 1 KB
VARIANTS = {
    "stride U1 nc": (256, 1, 0, 1, 0, 0),
    "stride U4": (256, 4, 0, 0, 0, 0),
    "stride U4 noalloc cs": (256, 4, 0, 2, 1, 0),
    "oneshot U1": (256, 1, 1, 0, 0, 0),
    "oneshot U2": (256, 2, 1, 0, 0, 0),
    "oneshot U4": (256, 4, 1, 0, 0, 0),
    "oneshot U4 t128": (128, 4, 1, 0, 0, 0),
    "oneshot U2 t512": (512, 2, 1, 0, 0, 0),
    "oneshot U8": (256, 8, 1, 0, 0, 0),
    "oneshot U4 nc": (256, 4, 1, 1, 0, 0),
    "oneshot U4 noalloc cs": (256, 4, 1, 2, 1, 0),
    "oneshot U4 cs cs": (256, 4, 1, 3, 1, 0),
    "oneshot U4 nc.L2::256B": (256, 4, 1, 4, 0, 0),
    "oneshot U4 L2::256B": (256, 4, 1, 5, 0, 0),
    "oneshot U4 pairs": (256, 4, 1, 0, 0, 1),
    "oneshot U4 pairs nc.L2::256B": (256, 4, 1, 4, 0, 1),
    "oneshot U8 pairs nc.L2::256B": (256, 8, 1, 4, 0, 1),
    "oneshot U4 pairs nc.L2::256B cs": (256, 4, 1, 4, 1, 1),
    "bulk 16 KB": ("bulk", 16384),
    "bulk 32 KB": ("bulk", 32768),
    "bulk 64 KB": ("bulk", 65536),
}

SOURCE = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

template <int LD>
__device__ __forceinline__ uint4 load(const uint4* p) {
  if constexpr (LD == 0) return *p;
  if constexpr (LD == 1) return __ldg(p);
  if constexpr (LD == 3) return __ldcs(p);
  uint4 v;
  if constexpr (LD == 2)
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  if constexpr (LD == 4)
    asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  if constexpr (LD == 5)
    asm volatile("ld.global.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
template <int ST>
__device__ __forceinline__ void store(uint4* p, uint4 v) {
  if constexpr (ST == 0) *p = v; else __stcs(p, v);
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  const __nv_bfloat162 s = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
  return *reinterpret_cast<const uint32_t*>(&s);
}
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z), add2(a.w, b.w));
}

// vector u of this thread in a one-shot block: T apart, or two by two
// adjacent (pairs)
template <int T, int PAIRS>
__device__ __forceinline__ long long at(long long block0, int u) {
  if (PAIRS) return block0 + (u / 2) * 2 * T + 2 * threadIdx.x + u % 2;
  return block0 + u * T + threadIdx.x;
}

template <int T, int U, int ONESHOT, int LD, int ST, int PAIRS>
__global__ void __launch_bounds__(T) add_var(const uint4* __restrict__ x,
                                             const uint4* __restrict__ y,
                                             uint4* __restrict__ o, long long nv) {
  if (ONESHOT) {
    const long long b0 = (long long)blockIdx.x * T * U;
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at<T, PAIRS>(b0, u) < nv) a[u] = load<LD>(x + at<T, PAIRS>(b0, u));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at<T, PAIRS>(b0, u) < nv) b[u] = load<LD>(y + at<T, PAIRS>(b0, u));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at<T, PAIRS>(b0, u) < nv) store<ST>(o + at<T, PAIRS>(b0, u), add8(a[u], b[u]));
    return;
  }
  const long long stride = (long long)gridDim.x * T;
  long long i = (long long)blockIdx.x * T + threadIdx.x;
  for (; i + (U - 1) * stride < nv; i += U * stride) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = load<LD>(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) b[u] = load<LD>(y + i + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) store<ST>(o + i + u * stride, add8(a[u], b[u]));
  }
  for (; i < nv; i += stride) store<ST>(o + i, add8(load<LD>(x + i), load<LD>(y + i)));
}

template <int T, int U, int ONESHOT, int LD, int ST, int PAIRS>
int launch(const void* x, const void* y, void* o, long long nv, cudaStream_t st) {
  auto k = add_var<T, U, ONESHOT, LD, ST, PAIRS>;
  long long blocks;
  if (ONESHOT) {
    blocks = (nv + (long long)T * U - 1) / ((long long)T * U);
  } else {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, T, 0);
    blocks = (long long)per * sms;
  }
  k<<<(unsigned)blocks, T, 0, st>>>(static_cast<const uint4*>(x), static_cast<const uint4*>(y),
                                   static_cast<uint4*>(o), nv);
  return (int)cudaGetLastError();
}

// bulk copies: a block brings CH bytes of x and of y into shared memory by
// two bulk copies on one mbarrier, adds in place, and writes the sum back by
// one bulk store (n a multiple of CH / 2 here)
template <int CH>
__global__ void __launch_bounds__(256) add_bulk(const uint4* __restrict__ x,
                                                const uint4* __restrict__ y,
                                                uint4* __restrict__ o) {
  extern __shared__ __align__(128) uint4 sm[];
  __shared__ __align__(8) uint64_t bar;
  const size_t off = (size_t)blockIdx.x * (CH / 16);
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(2 * CH)
                 : "memory");
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
                 "%2, [%3];\n" ::"r"(s0), "l"(x + off), "r"(CH), "r"(b) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
                 "%2, [%3];\n" ::"r"(s0 + CH), "l"(y + off), "r"(CH), "r"(b) : "memory");
  }
  __syncthreads();
  uint32_t done = 0, spins = 0;
  while (!done) {
    if (++spins == (1u << 26)) __trap();
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(b) : "memory");
  }
  for (int i = threadIdx.x; i < CH / 16; i += 256) sm[i] = add8(sm[i], sm[CH / 16 + i]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(o + off), "r"(static_cast<uint32_t>(__cvta_generic_to_shared(sm))),
                 "r"(CH) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int CH>
int launch_bulk(const void* x, const void* y, void* o, long long nv, cudaStream_t st) {
  if ((nv * 16) % CH) return (int)cudaErrorInvalidValue;
  auto k = add_bulk<CH>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * CH);
  k<<<(unsigned)(nv * 16 / CH), 256, 2 * CH, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y), static_cast<uint4*>(o));
  return (int)cudaGetLastError();
}

extern "C" int run(int v, const void* x, const void* y, void* o, long long nv, void* s) {
  cudaStream_t st = static_cast<cudaStream_t>(s);
  switch (v) {
VARIANT_CASES
  }
  return (int)cudaErrorInvalidValue;
}
"""


def main() -> int:
    import torch
    from sgl_kernel_npu_tpu_torch import _build
    from sgl_kernel_npu_tpu_torch.ops import helloworld as hw
    import compare_rmsq_mla_kernels as cmp

    if not torch.cuda.is_available():
        print("probe_helloworld: no CUDA card", file=sys.stderr)
        return 2
    cases = "\n".join(
        f"    case {i}: return launch_bulk<{v[1]}>(x, y, o, nv, st);" if v[0] == "bulk" else
        "    case {}: return launch<{}, {}, {}, {}, {}, {}>(x, y, o, nv, st);".format(i, *v)
        for i, v in enumerate(VARIANTS.values()))
    out_dir = os.path.join(ROOT, "build", "hello_probe")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "variants.cu")
    with open(path, "w") as f:
        f.write(SOURCE.replace("VARIANT_CASES", cases))
    so = os.path.join(out_dir, "variants.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stdout + res.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.run.restype = ctypes.c_int
    lib.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    want = x + y
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:          # clocks up before timing
        a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()
    calls = {"torch.add": lambda: torch.add(x, y), "K22": lambda: hw.helloworld(x, y)}
    for i, name in enumerate(VARIANTS):
        def call(i=i):
            out = torch.empty_like(x)
            code = lib.run(i, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel() // 8,
                           torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"probe_helloworld: variant {i}: CUDA error {code}")
            return out
        calls[name] = call
    row = {}
    for name in [*calls, "K22", "torch.add"]:
        if not torch.equal(calls[name](), want):
            raise AssertionError(f"probe_helloworld: {name} differs from x + y")
        key = name if name not in row else name + " (again)"
        row[key] = cmp._graph_ms(torch, calls[name], 50)
    print(json.dumps(row), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(gpu.stdout.strip().splitlines()[0] if gpu.stdout.strip() else "nvidia-smi: no answer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
