// Launch set-up that CUDA keeps per device, recorded per (kernel, device).
//
// A kernel's dynamic shared-memory limit (cudaFuncSetAttribute), the number
// of its blocks that fit on the card at once (the occupancy query) and the
// card's SM count belong to the device that is current when they are set or
// asked. A
// process-wide "done" flag would let a kernel launch on a second card with
// the first card's set-up, and be refused there. These helpers keep one
// record per (kernel, device) instead: the first launch on each card sets
// that card up. The records have internal linkage: each library that
// includes this header keeps its own.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace skt {
namespace {

namespace detail {
using Key = std::pair<const void*, int>;        // (kernel, device)
std::mutex mu;
std::map<Key, size_t> smem_allowed;             // dynamic shared-memory limit set so far
std::map<Key, int> resident;                    // co-resident blocks on the whole card
std::map<int, int> sms;                         // SMs of a device

cudaError_t key_of(const void* kern, Key& key) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  key = Key(kern, dev);
  return e;
}
}  // namespace detail

// Raise `kern`'s dynamic shared-memory limit on the current device to
// `bytes` where it is below: a high-water mark per device (48 KB needs none).
template <typename Kernel>
cudaError_t ensure_smem(Kernel* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  detail::Key key;
  cudaError_t e = detail::key_of(reinterpret_cast<const void*>(kern), key);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(detail::mu);
  size_t& allowed = detail::smem_allowed[key];
  if (bytes <= allowed) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// The number of blocks of `kern` (`threads` threads, `smem` bytes of
// dynamic shared memory) that the current device holds at once: blocks per
// SM times its SMs, asked once per device.
template <typename Kernel>
cudaError_t resident_blocks(Kernel* kern, int threads, size_t smem, int& blocks) {
  detail::Key key;
  cudaError_t e = detail::key_of(reinterpret_cast<const void*>(kern), key);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(detail::mu);
  int& have = detail::resident[key];
  if (have == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, key.second)) !=
        cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    have = per_sm * sms;
  }
  blocks = have;
  return cudaSuccess;
}

// The current device's SM count, asked once per device.
cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(detail::mu);
  int& have = detail::sms[dev];
  if (have == 0 &&
      (e = cudaDeviceGetAttribute(&have, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  sms = have;
  return cudaSuccess;
}

}  // namespace
}  // namespace skt
