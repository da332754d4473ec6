// Curl and x-axis inverse FFT of a packed spectral 3-stack, in one pass.
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// curl_irfft3d_packed (_curl_ifft_x_kernel), which forms the vorticity
// spectrum i K x U in VMEM and runs the x inverse as factored MXU matmuls,
// so the curl never lands in device memory.  Planar form of the curl:
//   re(iK x U)_c = -(K_{c+1} Ui_{c+2} - K_{c+2} Ui_{c+1}),
//   im(iK x U)_c =   K_{c+1} Ur_{c+2} - K_{c+2} Ur_{c+1}.
// With BS (biot_savart, the vorticity form's velocity from its state) the
// curl takes the factor 1/|k|^2 (k^2 = 0 taken as 1) as it is formed
// (pallas_fft3d.py:1270-1274); the state's own inverse does not.
//
// The state pair is (3, n, Q) with Q = N1 * h flattened (k1, k2) columns;
// the wavenumbers arrive as the 1-D vectors k0 (n), k1 (N1), k2 (h).  The
// outputs go to one (3 or 6, n, Q) pair, curl first, so the y and z
// inverses that follow run once over all six components.  With the state
// a column reads three complex values and writes six: 12 bytes a
// transformed point where fft_axis.cu moves 16, so, as there, the stages
// and not HBM set the pace.  The first port of this kernel (one
// synchronous tile a block, 4-byte loads with a division and a modulo a
// value, block_fft's run-time divisions, the curl reading each state value
// twice from global memory and the state's pass a third time) took 8.87 ms
// at (3, 512, 512, 256) with the state, 16% of its 1.44 ms bound, and its
// copy-only variant 4.08 ms.  The design is fft_axis.cu's, on a tile of
// three components:
//
// - a tile is T neighbouring columns of the three components across all n
//   rows: six planes (re, then im, of each component) of n row segments Q
//   values apart; T, a power of two, from n alone (curl_cols): the most
//   with n T <= kCurlTile, at most 16 (T = 8 at n = 512: a 32-byte sector a
//   segment; 16 at 256; 4 at 1024), so the six planes take 96 KB; a last
//   ragged tile transforms only its own columns;
// - a persistent grid (bulk_ring.cuh's launch_persistent; one block a
//   multiprocessor at n >= 256) walks the tiles blockIdx.x, + gridDim.x,
//   ...;
// - every thread copies its share of the tile into the slot by cp.async
//   (bulk_ring.cuh: 16-byte chunks where a plane's tile lies on the 16-byte
//   grid, else value by value, neighbouring threads on neighbouring values)
//   and arrives on the slot's mbarrier;
// - the tile's output components, the curl's three and with the state the
//   state's three, go kCurlGroup = 2 at a time through the work tile (n x
//   2T complex values, the component fastest): each curl component formed
//   from the slot's values and the 1-D k vectors (a thread keeps its
//   column's k1 and k2 across the tile), each state component copied from
//   the slot, so global memory is read once; block_fft_fast (its last stage
//   column-fastest) transforms the group and writes each value, 1/n folded
//   in, straight to global memory: neighbouring threads write neighbouring
//   columns, whole 32-byte sectors of a row a warp store at n = 512;
// - once the last group has read the slot, the copy of tile it + 1 into it
//   runs under that group's transform (~14 us a group at n = 512, where a
//   tile's copy takes ~4 us at the card's rate a multiprocessor).
//
// Shared memory sets the rest: two slots, or a staging tile for 16-byte
// stores, would pass 227 KB at n = 512.  On an H100 80GB HBM3 (700 W),
// (3, 512, 512, 256) with the state (tools/ab_fft_last.py --kernel
// curl_ifft_x; the first port's kernel 8.87 ms in the same calls): T = 4, all
// three components a transform, 384 threads, two blocks a multiprocessor,
// 25.0 ms (16-byte segments: copy-only 14.2 ms); T = 8, three components,
// 768 threads at 80 registers (2.8 KB spilled) 9.6-10.5 ms; two components
// 5.21 ms (copy-only 2.90); two with 8 values a thread (1024 threads, 64
// registers) 5.39; one (256 threads) 5.81; three with 12 values a thread
// 11.3.  At (3, 256, 256, 128) 0.535 ms against the first port's 0.961.
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_ring.cuh"
#include "fft_block.cuh"

using fftblock::Plan;

namespace {

using namespace bulkring;

// Values of a component's tile (n T) at most: the slot's six planes then
// take 96 KB.
constexpr int kCurlTile = 4096;
constexpr int kCurlMaxCols = 16;
// Components a transform: the work tile holds kCurlGroup n x T tiles, and
// the block kRowEPT values a thread of them (512 threads, 128 registers,
// in the plain instance; 1024, 64 registers, in the mixed one).
constexpr int kCurlGroup = 2;
template <bool kMixed>
constexpr int kCurlThreads =
    kCurlGroup * kCurlTile / fftblock::kRowEPT<kMixed>;

// Component `job` of the outputs at slot index e (row e >> lgT): the
// curl's c = job (i K x U, / |K|^2 with BS; components taken cyclically)
// for job < 3, the state's c = job - 3 after.
template <bool BS>
__device__ __forceinline__ float2 job_value(const float* slot, int PL, int e,
                                            int job, float kx, float ky,
                                            float kz) {
  if (job >= 3) {
    const int c = job - 3;
    return make_float2(slot[c * PL + e], slot[(3 + c) * PL + e]);
  }
  const int c = job, c1 = c == 2 ? 0 : c + 1, c2 = c == 0 ? 2 : c - 1;
  // K_{c+1} and K_{c+2}
  const float Ka = c == 0 ? ky : (c == 1 ? kz : kx);
  const float Kb = c == 0 ? kz : (c == 1 ? kx : ky);
  float2 v = make_float2(-(Ka * slot[(3 + c2) * PL + e] -
                           Kb * slot[(3 + c1) * PL + e]),
                         Ka * slot[c2 * PL + e] - Kb * slot[c1 * PL + e]);
  if (BS) {
    const float ksq = kx * kx + ky * ky + kz * kz;
    const float kinv = 1.f / (ksq == 0.f ? 1.f : ksq);
    v = make_float2(v.x * kinv, v.y * kinv);
  }
  return v;
}

// In iteration it the block waits for tile it in the slot, then runs the
// tile's 3 (6 with the state) output components in groups of kCurlGroup:
// it fills the work tile from the slot, transforms it and stores it.  The
// copy of tile it + 1 into the slot starts once the last group has read
// it.
template <bool BS, bool kMixed>
__global__ void __launch_bounds__(kCurlThreads<kMixed>, 1)
curl_ifft_x_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                   const float* __restrict__ k0, const float* __restrict__ k1,
                   const float* __restrict__ k2, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw,
                   Plan plan, int n, int h, int Q, int lgT, int passes) {
  extern __shared__ __align__(16) float smem[];
  const int T = 1 << lgT;
  const int PL = n * T;  // floats a plane of the slot
  // the slot: re, then im, of each component; then the work tile
  float2* W = reinterpret_cast<float2*>(smem + 6 * PL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(W + kCurlGroup * PL);
  const long long plane = static_cast<long long>(n) * Q;
  const int tiles = static_cast<int>((static_cast<long long>(Q) + T - 1) >>
                                     lgT);
  const int jobs = 3 * passes;
  const float scale = 1.f / static_cast<float>(n);
  // the thread's column in the passes over the slot (blockDim.x % T == 0)
  const int j = threadIdx.x & (T - 1);

  // tile t's six planes into the slot
  const auto load = [&](int t) {
    const int q0 = t << lgT;
    const int w = min(T, Q - q0);
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const float* x = p < 3 ? ur : ui;
      const long long g0 = (p % 3) * plane + q0;
      float* dst = smem + p * PL;
      if (whole_chunks<4>(x, g0, Q, w))
        for_copies<4, true>(g0, Q, n, w, lgT, [&](int e, long long g) {
          cp_async<16>(dst + e, x + g);
        });
      else
        for_copies<4, false>(g0, Q, n, w, lgT, [&](int e, long long g) {
          cp_async<4>(dst + e, x + g);
        });
    }
    cp_async_arrive(bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  load(blockIdx.x);

  for (int it = 0, tile = blockIdx.x; tile < tiles;
       ++it, tile += gridDim.x) {
    const int q0 = tile << lgT;
    const int w = min(T, Q - q0);
    const int next = tile + gridDim.x;
    float ky = 0.f, kz = 0.f;
    if (j < w) {
      const int q = q0 + j;
      const int qy = q / h;
      ky = __ldg(&k1[qy]);
      kz = __ldg(&k2[q - qy * h]);
    }
    mbar_wait(bar, it & 1);

    for (int j0 = 0; j0 < jobs; j0 += kCurlGroup) {
      const int gc = min(kCurlGroup, jobs - j0);
      // the work tile: n x gc T, row r's column gc j + g the value of
      // output component j0 + g at the slot's (r, j)
      if (j < w) {
        for (int e = threadIdx.x; e < PL; e += blockDim.x) {
          const int r = e >> lgT;
          const float kx = __ldg(&k0[r]);
          float2* out = W + r * gc * T + gc * j;
#pragma unroll
          for (int g = 0; g < kCurlGroup; ++g)
            if (g < gc)
              out[g] = job_value<BS>(smem, PL, e, j0 + g, kx, ky, kz);
        }
      }
      __syncthreads();
      if (j0 + gc == jobs && next < tiles) load(next);

      // column c = gc j' + g, index k of the spectrum: output component
      // j0 + g, scaled, to global memory
      const fftblock::FastDiv fg(gc);
      const auto put = [&](int c, int k, float2 v) {
        const int jj = fg.div(c);
        const long long o = (j0 + c - jj * gc) * plane +
                            static_cast<long long>(k) * Q + q0 + jj;
        yr[o] = v.x * scale;
        yi[o] = v.y * scale;
      };
      const fftblock::FastDiv fcol(gc * w);
      if (!fftblock::block_fft_fast<kMixed, fftblock::kRowEPT<kMixed>, true>(
              W, n, fcol, gc * T, plan, tw, 1.f, put)) {
        for (int e = threadIdx.x; e < n * gc * w; e += blockDim.x) {
          const int k = fcol.div(e);
          const int c = e - k * gc * w;
          put(c, k, W[k * gc * T + c]);
        }
      }
      __syncthreads();  // the work tile's last reads
    }
  }
}

// log2 of the columns a tile: the most with n T <= kCurlTile, at most
// kCurlMaxCols.
int curl_cols(int n) {
  int lg = 0;
  while ((2 << lg) <= kCurlMaxCols && n * (2 << lg) <= kCurlTile) ++lg;
  return lg;
}

template <bool BS, bool kMixed>
int launch(const float* ur, const float* ui, const float* k0,
           const float* k1, const float* k2, float* yr, float* yi,
           const void* tw, const Plan& plan, int n, int h, int Q,
           int passes, cudaStream_t stream) {
  const int lgT = curl_cols(n);
  const int T = 1 << lgT;
  constexpr int kE = fftblock::kRowEPT<kMixed>;
  const int threads = (kCurlGroup * n * T + kE * 32 - 1) / (kE * 32) * 32;
  const size_t smem =
      sizeof(float) * (6 + 2 * kCurlGroup) * n * T + sizeof(uint64_t);
  return launch_persistent(curl_ifft_x_kernel<BS, kMixed>,
                           (static_cast<long long>(Q) + T - 1) / T, threads,
                           smem, stream, ur, ui, k0, k1, k2, yr, yi,
                           static_cast<const float2*>(tw), plan, n, h, Q, lgT,
                           passes);
}

template <bool BS>
int launch_plan(const float* ur, const float* ui, const float* k0,
                const float* k1, const float* k2, float* yr, float* yi,
                const void* tw, const Plan& plan, int n, int h, int Q,
                int passes, cudaStream_t stream) {
  return fftblock::mixed_plan(plan)
             ? launch<BS, true>(ur, ui, k0, k1, k2, yr, yi, tw, plan, n, h,
                                Q, passes, stream)
             : launch<BS, false>(ur, ui, k0, k1, k2, yr, yi, tw, plan, n, h,
                                 Q, passes, stream);
}

}  // namespace

// ur, ui: (3, n, n1 * h) state pair; k0 (n), k1 (n1), k2 (h) float32;
// yr, yi: (3 or 6, n, n1 * h), the curl's x inverse first (divided by
// |k|^2 with biot_savart), then (with_state) the state's.  tw: n float2 of
// exp(+2 pi i m / n).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int curl_ifft_x_launch(const float* ur, const float* ui,
                                  const float* k0, const float* k1,
                                  const float* k2, float* yr, float* yi,
                                  const void* tw, int n, int n1, int h,
                                  int with_state, int biot_savart,
                                  void* stream) {
  const Plan plan = fftblock::make_plan(n);
  const long long Q = static_cast<long long>(n1) * h;
  if (plan.nst == 0 || n1 < 1 || h < 1 || Q > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = with_state ? 2 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = static_cast<int>(Q);
  return biot_savart
             ? launch_plan<true>(ur, ui, k0, k1, k2, yr, yi, tw, plan, n, h,
                                 q, passes, st)
             : launch_plan<false>(ur, ui, k0, k1, k2, yr, yi, tw, plan, n, h,
                                  q, passes, st);
}
