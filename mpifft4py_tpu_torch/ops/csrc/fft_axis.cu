// c2c FFT along the middle axis of a planar (re, im) float32 pair viewed as
// (pre, n, post).
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_axis_planar (_factored_fft_kernel), which runs the DFT as factored
// MXU matmuls.  The template parameter kC64 picks the global layout: false,
// the planar pair above (row 1); true, interleaved complex64 (x and y each
// one array of float2), for the dense tier's mpifft4py_tpu/ops/pallas_fft.py:
// fft_axis (_fft_axis_pallas, _cfft_kernel), row 19, which runs the c2c DFT
// along a non-last axis of (pre, n, post) as one dense n x n matmul pair.
// Only the bytes a value and the planes differ.
//
// An FFT of n <= 1024 points does 5 n log2 n flops on 16 bytes a point
// moved through HBM, ~3 flops a byte at n = 256: HBM bytes bound it (row
// 1's 134 MB: 0.040 ms at 3.35 TB/s).  On an H100 the PR 1 kernel (one
// synchronous tile a block, 4-byte loads, block_fft's run-time divisions)
// took 0.146 ms at row 1, and its own copy-only variant 0.069 ms: the
// stages, not the loads, set the pace (tools/ab_fft_last.py --kernel
// fft_axis).  One 1-D bulk copy (TMA) a row segment was no way to feed a
// column tile: its copy-only variant took 0.282 ms, the copy engine
// taking each 64-byte segment as an operation of its own.  The design,
// fft_last.cu's on a tile of columns, with cp.async for the copies (row
// 1: 0.097 ms, copy-only 0.062; row 19 0.110, copy-only 0.076):
//
// - a tile is T neighbouring `post` columns across all n rows of one `pre`
//   index: n row segments, `post` values apart; T is a power of two,
//   n * T <= kAxisTile values, but segments of at least one 32-byte
//   sector (64 bytes where the rows start off the 16-byte grid), fewer
//   columns where `post` is small (at most `post` rounded up to a power
//   of two) and, down to that width, where the tiles would not fill the
//   card; a last ragged tile (post = 129: 8 tiles of 16, then 1)
//   transforms only its own columns;
// - a persistent grid (the instance's resident blocks a multiprocessor x
//   the multiprocessors, at most one block a tile) walks the tiles
//   blockIdx.x, + gridDim.x, ..., in (pre, column) order;
// - two slots in shared memory, an mbarrier each: tile it + 1 is copied
//   into one while the block transforms tile it (load_cols below): every
//   thread copies its 16-byte chunks of the n row segments with cp.async
//   (global -> shared, no registers) where all of them start on the
//   16-byte grid, else its values, neighbouring threads on neighbouring
//   values (row 19's 1032-byte rows, views that start inside a buffer),
//   and arrives on the slot's mbarrier when they have landed;
// - the slot's row-major planes are interleaved into the work tile (the
//   same row-major order, pitch T, columns fastest), block_fft_fast
//   (fft_block.cuh: index division by multiply-high, batched loads, a
//   pair-sum stage for each prime >= 11) transforms its columns, and its
//   last stage (stage_fast_cols: columns fastest, no bank conflicts; after
//   a pair-sum stage, a pass over the tile) stages the spectrum in the slot
//   the tile came in, 1/n folded into the inverse;
// - the threads store the slot, 16 bytes a store where the tile's
//   segments are on the grid (store_cols).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bulk_ring.cuh"
#include "fft_block.cuh"

using fftblock::Plan;

namespace {

using namespace bulkring;

// Every thread: copies its share of the column tile (bulk_ring.cuh) of x0
// (and, if kTwo, x1, landing PL floats further) into `slot` and arrives on
// `bar` once it has landed.  The caller has ordered the slot's earlier
// reads (a barrier).
template <int kB, bool kTwo>
__device__ void load_cols(const float* x0, const float* x1, long long g0,
                          long long pitch, int n, int w, int lgT, float* slot,
                          int PL, uint64_t* bar) {
  constexpr int kF = kB / 4;
  const auto plane = [&](const float* x, float* dst) {
    if (whole_chunks<kB>(x, g0, pitch, w))
      for_copies<kB, true>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        cp_async<16>(dst + e * kF, x + g);
      });
    else
      for_copies<kB, false>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        cp_async<kB>(dst + e * kF, x + g);
      });
  };
  plane(x0, slot);
  if (kTwo) plane(x1, slot + PL);
  cp_async_arrive(bar);
}

// Every thread: stores its share of the tile staged in `slot` (as
// load_cols lands it) to y0 (and y1), in 16-byte chunks where the tile
// goes whole.  The staged values are visible to it (a barrier).
template <int kB, bool kTwo>
__device__ void store_cols(float* y0, float* y1, long long g0,
                           long long pitch, int n, int w, int lgT,
                           const float* slot, int PL) {
  constexpr int kF = kB / 4;
  using V = typename std::conditional<kB == 8, float2, float>::type;
  const auto plane = [&](float* y, const float* src) {
    if (whole_chunks<kB>(y, g0, pitch, w))
      for_copies<kB, true>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        *reinterpret_cast<float4*>(y + g) =
            *reinterpret_cast<const float4*>(src + e * kF);
      });
    else
      for_copies<kB, false>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        *reinterpret_cast<V*>(y + g) =
            *reinterpret_cast<const V*>(src + e * kF);
      });
  };
  plane(y0, slot);
  if (kTwo) plane(y1, slot + PL);
}

// Values a tile: the default budget, and the most (a tile of a 1024-point
// plan keeps a 32-byte segment a plane: T = 8 planar).
constexpr int kAxisTile = 4096;
constexpr int kAxisMaxTile = 8192;

// Tile it of a block lands in slot it % 2.  In iteration it the block
// waits for tile it and interleaves it into the work tile; then it starts
// the copy of tile it + 1 into slot (it + 1) % 2 (stored from in
// iteration it - 1), transforms tile it, stages the spectrum in slot
// it % 2 (now free) and stores it.
template <bool kC64, bool kMixed>
__global__ void
__launch_bounds__(kAxisMaxTile / fftblock::kRowEPT<kMixed>, 1)
fft_axis_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n,
                long long post, int lgT, long long tpp, long long tiles,
                float sign, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kC64 ? 8 : 4;
  const int T = 1 << lgT;
  const int PL = n * T;  // floats a plane of a slot (planar)
  const int SL = 2 * PL;  // floats a slot
  float2* s = reinterpret_cast<float2*>(smem + 2 * SL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + n * T);
  // tile -> its first value (p, 0, q0) and its width
  const auto origin = [&](long long t, long long& g0, int& w) {
    const long long p = t / tpp;
    const long long q0 = (t - p * tpp) << lgT;
    g0 = p * n * post + q0;
    w = static_cast<int>(min(static_cast<long long>(T), post - q0));
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], blockDim.x);
    mbar_init(&bar[1], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  {
    long long g0;
    int w;
    origin(blockIdx.x, g0, w);
    load_cols<kB, !kC64>(xr, xi, g0, post, n, w, lgT, smem, PL, &bar[0]);
  }

  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    float* slot = smem + b * SL;
    long long g0;
    int w;
    origin(tile, g0, w);
    mbar_wait(&bar[b], (it >> 1) & 1);

    // the slot -> the work tile (the same order; planar: the planes
    // interleaved), 16 bytes a load
    const float4* in = reinterpret_cast<const float4*>(slot);
    float4* work = reinterpret_cast<float4*>(s);
    if (kC64) {
      for (int e = threadIdx.x; e < SL / 4; e += blockDim.x) work[e] = in[e];
    } else {
      for (int e = threadIdx.x; e < PL / 4; e += blockDim.x) {
        const float4 re = in[e], im = in[PL / 4 + e];
        work[2 * e] = make_float4(re.x, im.x, re.y, im.y);
        work[2 * e + 1] = make_float4(re.z, im.z, re.w, im.w);
      }
    }
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      long long h0;
      int hw;
      origin(next, h0, hw);
      load_cols<kB, !kC64>(xr, xi, h0, post, n, hw, lgT,
                           smem + (b ^ 1) * SL, PL, &bar[b ^ 1]);
    }

    // column c, index k of the spectrum, scaled, staged in the slot
    const auto put = [&](int c, int k, float2 v) {
      const int e = (k << lgT) + c;
      if (kC64) {
        reinterpret_cast<float2*>(slot)[e] =
            make_float2(v.x * scale, v.y * scale);
      } else {
        slot[e] = v.x * scale;
        slot[PL + e] = v.y * scale;
      }
    };
    const fftblock::FastDiv fcol(w);
    if (!fftblock::block_fft_fast<kMixed, fftblock::kRowEPT<kMixed>, true>(
            s, n, fcol, T, plan, tw, sign, put)) {
      for (int e = threadIdx.x; e < PL; e += blockDim.x)
        if ((e & (T - 1)) < w) put(e & (T - 1), e >> lgT, s[e]);
    }
    __syncthreads();
    store_cols<kB, !kC64>(yr, yi, g0, post, n, w, lgT, slot, PL);
  }
}

// Bytes a row segment at least where the rows start off the 16-byte grid
// (their pitch is not a multiple of 16 bytes): a segment then straddles
// one more 32-byte sector, so wider ones waste less.  One sector
// elsewhere.
constexpr int kWide = 64;

// log2 of the columns a tile: the most with n * T <= kAxisTile, widened
// (n * T <= kAxisMaxTile) to segments of a sector or kWide bytes, at most
// `post` rounded up to a power of two (but a 16-byte unit); then halved,
// down to that segment width, while the tiles would not give every
// multiprocessor two.
int tile_cols(int n, long long pre, long long post, int kB, int sms) {
  const int unit = 16 / kB;
  const int seg = (post * kB) % 16 ? kWide : 32;
  int T = unit;
  while (2 * T * n <= kAxisTile) T *= 2;
  while (T * kB < seg && 2 * T * n <= kAxisMaxTile) T *= 2;
  while (T > unit && T / 2 >= post) T /= 2;
  while (T * kB > seg && pre * ((post + T - 1) / T) < 2LL * sms) T /= 2;
  int lg = 0;
  while ((1 << lg) < T) ++lg;
  return lg;
}

template <bool kC64, bool kMixed>
int launch_instance(const float* xr, const float* xi, float* yr, float* yi,
                    const float2* tw, const Plan& plan, long long pre, int n,
                    long long post, float sign, float scale,
                    cudaStream_t stream) {
  constexpr int kB = kC64 ? 8 : 4;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int lgT = tile_cols(n, pre, post, kB, sms);
  const int T = 1 << lgT;
  constexpr int kE = fftblock::kRowEPT<kMixed>;
  const int threads = (n * T + kE * 32 - 1) / (kE * 32) * 32;
  const size_t smem = sizeof(float) * 4 * n * T + sizeof(float2) * n * T +
                      sizeof(uint64_t) * 2;
  const long long tpp = (post + T - 1) / T;
  return launch_persistent(fft_axis_kernel<kC64, kMixed>, pre * tpp,
                           threads, smem, stream, xr, xi, yr, yi, tw, plan,
                           n, post, lgT, tpp, pre * tpp, sign, scale);
}

// One launch; for kC64, xr and yr are the interleaved arrays and xi, yi
// are unused.  A base misaligned for its value type (not 4-byte aligned
// planar, not 8-byte aligned complex64) is refused.
template <bool kC64>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const void* tw, long long pre, int n, long long post, int inverse,
           void* stream) {
  const Plan plan = fftblock::make_plan(n);
  if (plan.nst == 0 || pre < 1 || post < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = kC64 ? 8 : 4;
  if ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
       reinterpret_cast<uintptr_t>(yr) | reinterpret_cast<uintptr_t>(yi)) %
      align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float sign = inverse ? 1.f : -1.f;
  const float sc = inverse ? 1.f / static_cast<float>(n) : 1.f;
  const auto* t = static_cast<const float2*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  return fftblock::mixed_plan(plan)
             ? launch_instance<kC64, true>(xr, xi, yr, yi, t, plan, pre, n,
                                           post, sign, sc, st)
             : launch_instance<kC64, false>(xr, xi, yr, yi, t, plan, pre, n,
                                            post, sign, sc, st);
}

}  // namespace

// tw: n float2, tw[m] = exp(sign * 2*pi*i * m / n), sign = +1 if inverse.
// Any 2 <= n <= 1024.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fft_axis_launch(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long pre,
                               int n, long long post, int inverse,
                               void* stream) {
  return launch<false>(xr, xi, yr, yi, tw, pre, n, post, inverse, stream);
}

// Row 19: x -> y, each interleaved complex64 (pre, n, post); tw as above.
extern "C" int fft_axis_c64_launch(const void* x, void* y, const void* tw,
                                   long long pre, int n, long long post,
                                   int inverse, void* stream) {
  return launch<true>(static_cast<const float*>(x), nullptr,
                      static_cast<float*>(y), nullptr, tw, pre, n, post,
                      inverse, stream);
}
