// The bulk-copy tile ring of the persistent row kernels (fft_last.cu,
// planar_rfft.cu): 1-D bulk copies (TMA, cp.async.bulk) between global
// memory and a slot in shared memory, an mbarrier a slot, and the launch of
// a persistent grid (the mbarriers and the launch also serve fft_axis.cu).
//
// A tile is one contiguous run of values in each of one or two planes.
// Bulk copies need 16-byte aligned addresses and sizes: where a run does
// not start on the 16-byte grid (a view that starts inside a larger
// buffer) or does not end on it (a ragged last tile), its unaligned head
// and tail (< 16 bytes each) are read and written by the threads with
// ordinary loads and stores, and the rest goes by bulk copy.  A plane's run
// of len values of kB bytes lands at slot index mis + e (e = 0..len-1),
// where mis is the run's offset past a 16-byte boundary, so the bulk part
// is 16-byte aligned on both sides.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace bulkring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

// An mbarrier whose phase completes after `count` arrivals (and its bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// The one arrival of a phase, with the bytes its copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// Generic-proxy shared memory accesses before it, async-proxy (bulk copy)
// ones after it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One plane's run of a tile, in values of kBytes bytes: the run starts
// `mis` values past a 16-byte boundary; values [head, head + bulk) go by
// bulk copy, to or from slot index mis + e (16-byte aligned), the rest by
// ordinary loads and stores.
struct Run {
  int mis, head, bulk;
};

template <int kBytes>
__device__ __forceinline__ Run run_of(const void* base, long long v0,
                                      int len) {
  constexpr int kUnit = 16 / kBytes;
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) +
                      static_cast<uintptr_t>(v0) * kBytes;
  Run r;
  r.mis = static_cast<int>(a & 15) / kBytes;
  r.head = min((kUnit - r.mis) % kUnit, len);
  r.bulk = (len - r.head) / kUnit * kUnit;
  return r;
}

__device__ __forceinline__ bool in_bulk(const Run& r, int e) {
  return e >= r.head && e < r.head + r.bulk;
}

// Floats a plane of a slot: a run of L 4-byte values, up to 3 more in
// front (mis), rounded up to 16 bytes.  A run of L 8-byte values (at most
// one more in front) fits in 2 * slot_plane(L) floats.
__host__ __device__ inline int slot_plane(int L) { return (L + 7) & ~3; }

// Thread 0: copy values [v0, v0 + len) of x0 (and, if kTwo, of x1) into
// `slot` (x1's run at slot + PL floats), values of kB bytes, arriving on
// `bar` with the bytes to expect.
template <int kB, bool kTwo>
__device__ void load_tile(const float* x0, const float* x1, long long v0,
                          int len, float* slot, int PL, uint64_t* bar) {
  const Run r0 = run_of<kB>(x0, v0, len);
  const Run r1 = kTwo ? run_of<kB>(x1, v0, len) : Run{0, 0, 0};
  fence_async_shared();
  mbar_expect_tx(bar, (r0.bulk + r1.bulk) * kB);
  if (r0.bulk)
    bulk_g2s(slot + (r0.mis + r0.head) * (kB / 4),
             x0 + (v0 + r0.head) * (kB / 4), r0.bulk * kB, bar);
  if (r1.bulk)
    bulk_g2s(slot + PL + (r1.mis + r1.head) * (kB / 4),
             x1 + (v0 + r1.head) * (kB / 4), r1.bulk * kB, bar);
}

// Thread 0: store the staged values [v0, v0 + len) of y0 (and, if kTwo,
// y1, staged at slot + PL floats) from `slot` (their bulk part; the threads
// wrote the rest) as one bulk group.
template <int kB, bool kTwo>
__device__ void store_tile(float* y0, float* y1, long long v0, int len,
                           const float* slot, int PL) {
  const Run r0 = run_of<kB>(y0, v0, len);
  if (r0.bulk)
    bulk_s2g(y0 + (v0 + r0.head) * (kB / 4),
             slot + (r0.mis + r0.head) * (kB / 4), r0.bulk * kB);
  if (kTwo) {
    const Run r1 = run_of<kB>(y1, v0, len);
    if (r1.bulk)
      bulk_s2g(y1 + (v0 + r1.head) * (kB / 4),
               slot + PL + (r1.mis + r1.head) * (kB / 4), r1.bulk * kB);
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Launches a persistent kernel: as many blocks as are resident at once (the
// occupancy of `threads` threads and `smem` bytes a block, times the
// multiprocessors), at most one a tile; each walks the tiles blockIdx.x,
// + gridDim.x, ...  0 or the CUDA error.
template <typename... P, typename... A>
int launch_persistent(void (*kernel)(P...), long long tiles, int threads,
                      size_t smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid =
      std::min(tiles, static_cast<long long>(per_sm) * sms);
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bulkring
