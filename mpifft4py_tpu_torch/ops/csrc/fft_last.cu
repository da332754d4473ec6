// c2c FFT along the last (contiguous) axis of a planar (re, im) float32
// pair viewed as (rows, n).
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_last_planar_c2c (_cfft_last_planar_kernel over _dense_cs), which
// multiplies each row by a dense (n x n) DFT matrix on the MXU (three real
// matmuls, 6 n^2 flops a row).  fft_axis.cu serves every other axis; its
// tiles take T neighbouring columns across all n rows, which on the last
// axis would read one element per row.  So this kernel takes whole rows.
//
// The template parameter kC64 picks the global layout, as in fft_axis.cu:
// true reads and writes interleaved complex64 rows, for the dense tier's
// mpifft4py_tpu/ops/pallas_fft.py: _fft_last_pallas (_cfft_last_kernel),
// row 20, fft_axis's post == 1 branch, which multiplies each row by a
// dense n x n DFT matrix pair.
//
// It moves 16 bytes a point through HBM (5 n log2 n flops a transform, 2.5
// flops a byte at n = 256), so HBM should bound it.  On an H100 a kernel
// of one tile a block (4-byte loads, then the stages, then 4-byte stores)
// took twice the time of its own copy-only variant: the stages' index
// arithmetic and the synchronous stores, not the loads, set its pace
// (tools/ab_fft_last.py).  The design keeps the copies off the threads:
//
// - a tile is RB whole rows (RB * n <= kTile values), one contiguous run of
//   each plane (planar) or of the interleaved array (kC64); RB is chosen so
//   that RB * n values are a multiple of 16 bytes, so every tile of an
//   aligned input starts 16-byte aligned;
// - a persistent grid (the instance's resident blocks a multiprocessor x
//   the multiprocessors, at most one block a tile) walks the tiles
//   blockIdx.x, + gridDim.x, ...;
// - two slots in shared memory, an mbarrier each (bulk_ring.cuh, shared
//   with planar_rfft.cu's r2c): one thread copies tile it + 1 in with 1-D
//   bulk copies (TMA, cp.async.bulk ... mbarrier::complete_tx::bytes, one a
//   plane) while the block transforms tile it;
// - a shared -> shared pass moves the row-major slot into the transposed
//   work tile (index-major, column = row, pitch RB + 1 so the strided
//   accesses spread over the banks), block_fft_fast (fft_block.cuh: the
//   Stockham plan of block_fft with its index divisions done by one
//   multiply-high) transforms its RB columns, and its last stage (or,
//   after a pair-sum stage, a pass over the tile) stages the spectrum
//   row-major in the slot the tile came in, 1/n folded into the inverse
//   and an optional scale (1/padsize^3 of the 3/2 rule) into both;
// - one thread stores the slot with bulk copies (cp.async.bulk.global.
//   shared::cta.bulk_group), which run while the block goes on; before the
//   slot is loaded again it waits until they have read it (wait_group.read);
// - bulk copies need 16-byte aligned addresses and sizes: where a plane's
//   base is not 16-byte aligned (a view that starts inside a larger
//   buffer), each tile's unaligned head and tail (< 16 bytes each) and the
//   ragged last tile's odd end are read and written with ordinary loads
//   and stores, and the rest goes by bulk copy as before;
// - prime factors p >= 11 run as the pair-sum stage (fft_block.cuh
//   stage_pairsum, ~1/4 of the direct stage's arithmetic).
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_ring.cuh"
#include "fft_block.cuh"

using fftblock::Plan;

namespace {

using namespace bulkring;

// Tile it of a block lands in slot it % 2.  In iteration it the block
// waits for tile it and moves it into the work tile; then thread 0 waits
// until the bulk store of tile it - 1 has read slot (it + 1) % 2 and loads
// tile it + 1 into it, while the block transforms tile it, stages the
// spectrum row-major in slot it % 2 (now free) and thread 0 stores it.
template <bool kC64, bool kMixed>
__global__ void
__launch_bounds__(fftblock::kTile / fftblock::kRowEPT<kMixed>, 2)
fft_last_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n,
                long long rows, int RB, float sign, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kC64 ? 8 : 4;
  const int L = n * RB;
  const int PL = slot_plane(L);
  const int pitch = RB + 1;
  float2* s = reinterpret_cast<float2*>(smem + 4 * PL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + n * pitch);
  const long long total = rows * n;
  const long long tiles = (rows + RB - 1) / RB;
  const fftblock::FastDiv fn(n), fcol(RB);
  const auto len_of = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(L), total - t * L));
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_tile<kB, !kC64>(xr, xi, blockIdx.x * static_cast<long long>(L),
                         len_of(blockIdx.x), smem, PL, &bar[0]);
  }
  __syncthreads();

  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    float* slot = smem + b * 2 * PL;
    const long long v0 = tile * L;
    const int len = len_of(tile);
    mbar_wait(&bar[b], (it >> 1) & 1);

    // the landing slot (row-major) -> the work tile (index-major); rows
    // past the end are zeros
    const Run r0 = run_of<kB>(xr, v0, len);
    const Run r1 = kC64 ? r0 : run_of<kB>(xi, v0, len);
    for (int e = threadIdx.x; e < L; e += blockDim.x) {
      const int rho = fn.div(e);
      const int t = e - rho * n;
      float2 v = make_float2(0.f, 0.f);
      if (e < len) {
        if (kC64) {
          v = in_bulk(r0, e)
                  ? reinterpret_cast<const float2*>(slot)[r0.mis + e]
                  : __ldg(reinterpret_cast<const float2*>(xr) + v0 + e);
        } else {
          v.x = in_bulk(r0, e) ? slot[r0.mis + e] : __ldg(xr + v0 + e);
          v.y = in_bulk(r1, e) ? slot[PL + r1.mis + e]
                               : __ldg(xi + v0 + e);
        }
      }
      s[t * pitch + rho] = v;
    }
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < tiles) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load_tile<kB, !kC64>(xr, xi, next * L, len_of(next),
                           smem + (b ^ 1) * 2 * PL, PL, &bar[b ^ 1]);
    }

    // row rho, index k of the spectrum, scaled: staged row-major in the
    // slot for the bulk store, or stored where it cannot go by bulk copy
    const Run o0 = run_of<kB>(yr, v0, len);
    const Run o1 = kC64 ? o0 : run_of<kB>(yi, v0, len);
    const int nrows = len / n;
    const auto put = [&](int rho, int k, float2 v) {
      if (rho >= nrows) return;
      const int e = rho * n + k;
      v = make_float2(v.x * scale, v.y * scale);
      if (kC64) {
        if (in_bulk(o0, e))
          reinterpret_cast<float2*>(slot)[o0.mis + e] = v;
        else
          reinterpret_cast<float2*>(yr)[v0 + e] = v;
      } else {
        if (in_bulk(o0, e))
          slot[o0.mis + e] = v.x;
        else
          yr[v0 + e] = v.x;
        if (in_bulk(o1, e))
          slot[PL + o1.mis + e] = v.y;
        else
          yi[v0 + e] = v.y;
      }
    };
    if (!fftblock::block_fft_fast<kMixed, fftblock::kRowEPT<kMixed>>(
            s, n, fcol, pitch, plan, tw, sign, put)) {
      for (int e = threadIdx.x; e < len; e += blockDim.x) {
        const int rho = fn.div(e);
        const int k = e - rho * n;
        put(rho, k, s[k * pitch + rho]);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) store_tile<kB, !kC64>(yr, yi, v0, len, slot, PL);
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Rows a tile: the most with n * RB <= kTile and RB * n values a multiple
// of 16 bytes (kUnit values); n <= 1024 leaves RB >= 4.
int tile_rows(int n, int unit) {
  int RB = fftblock::kTile / n;
  while (RB > 1 && (static_cast<long long>(RB) * n) % unit) --RB;
  return RB;
}

// One launch; for kC64, xr and yr are the interleaved arrays and xi, yi
// are unused.  A base misaligned for its value type (not 4-byte aligned
// planar, not 8-byte aligned complex64) is refused.
template <bool kC64, bool kMixed>
int launch_instance(const float* xr, const float* xi, float* yr, float* yi,
                    const float2* tw, const Plan& plan, long long rows,
                    int n, float sign, float scale, cudaStream_t stream) {
  constexpr int kB = kC64 ? 8 : 4;
  const int RB = tile_rows(n, 16 / kB);
  constexpr int kE = fftblock::kRowEPT<kMixed>;
  const int threads = (n * RB + kE * 32 - 1) / (kE * 32) * 32;
  const size_t smem = sizeof(float) * 4 * slot_plane(n * RB) +
                      sizeof(float2) * n * (RB + 1) + sizeof(uint64_t) * 2;
  const long long tiles = (rows + RB - 1) / RB;
  return launch_persistent(fft_last_kernel<kC64, kMixed>, tiles, threads,
                           smem, stream, xr, xi, yr, yi, tw, plan, n, rows,
                           RB, sign, scale);
}

template <bool kC64>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const void* tw, long long rows, int n, int inverse, float scale,
           void* stream) {
  const Plan plan = fftblock::make_plan(n);
  if (plan.nst == 0 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = kC64 ? 8 : 4;
  if ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
       reinterpret_cast<uintptr_t>(yr) | reinterpret_cast<uintptr_t>(yi)) %
      align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float sign = inverse ? 1.f : -1.f;
  const float sc = inverse ? scale / static_cast<float>(n) : scale;
  const auto* t = static_cast<const float2*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  return fftblock::mixed_plan(plan)
             ? launch_instance<kC64, true>(xr, xi, yr, yi, t, plan, rows, n,
                                           sign, sc, st)
             : launch_instance<kC64, false>(xr, xi, yr, yi, t, plan, rows,
                                            n, sign, sc, st);
}

}  // namespace

// xr, xi -> yr, yi, each (rows, n) float32, any 2 <= n <= 1024.  tw: n
// float2, tw[m] = exp(sign * 2*pi*i * m / n), sign = +1 if inverse (which
// also scales by 1/n); every output is multiplied by scale as well.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fft_last_launch(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long rows,
                               int n, int inverse, float scale,
                               void* stream) {
  return launch<false>(xr, xi, yr, yi, tw, rows, n, inverse, scale, stream);
}

// Row 20: x -> y, each interleaved complex64 (rows, n); tw as above.
extern "C" int fft_last_c64_launch(const void* x, void* y, const void* tw,
                                   long long rows, int n, int inverse,
                                   void* stream) {
  return launch<true>(static_cast<const float*>(x), nullptr,
                      static_cast<float*>(y), nullptr, tw, rows, n, inverse,
                      1.f, stream);
}
