// Planar r2c / c2r along the last (contiguous) axis, with the 3/2-rule
// truncation and zero-pad folded in, and the packed r2c (rows 4 and 17).
//
// Replaces the Pallas kernels mpifft4py_tpu/ops/pallas_fft3d.py:
// rfft_last_planar (_rfft_kernel over _rdft_cs) and irfft_last_planar
// (_irfft_kernel over _irdft_cs), which contract each row with dense
// (n x nfp) DFT matrices on the MXU, nfp = nf rounded up to 128 lanes.
// Here a spectrum has exactly nf columns (no lane padding), and the
// transform is the packed r2c's half-length algorithm: one h-point FFT of
// z_t = x[2t] + i*x[2t+1] per row (h = n/2) and the untangle of
// packed_z.cuh.  Only the ends differ:
//
// - the r2c stores columns 0..nf-1: column 0 is (X[0], 0) and column h
//   (only when nf = h + 1) is (X[h], 0), both from the packed plane-0
//   rider; with `dbl` column nf-1 is doubled (the Nyquist of the 3/2-rule
//   z truncation); `scale` (1/padsize^3 there) is applied at the store;
//   a spectral row is `ld` >= nf columns apart, and columns nf..ld-1 are
//   stored as zeros (the pencil's alignment lanes up to Nfp, written
//   straight into a peer-visible buffer);
// - the c2r builds the packed row from nf_in columns of rows `ld` apart:
//   columns >= nf_in are zero (the pad), an interior column nf_in-1 is
//   halved (the pad's halved Nyquist: with the c2r's weight 2 its net
//   weight is 1), and column h rides plane 0 only when nf_in = h + 1;
//   scale/n at the store.
//
// The template parameter kC64 of the c2r (and the output mode Out of the
// r2c) picks the spectrum's global layout: false, the planar pair; true,
// interleaved complex64, for the dense tier's
// mpifft4py_tpu/ops/pallas_fft.py: rfft_last (_rfft_kernel), row 21, numpy
// rfft into nf = n/2 + 1 columns (here with scale 1), and irfft_last
// (_irfft_kernel), row 22, numpy irfft from nf_in = n/2 + 1 columns.  Those
// contract each row with dense (n x nfp) cos/sin matrices, so they take odd
// n too; the half-length trick needs even n, so odd n takes the full-length
// kernels at the end of this file: one n-point c2c of (x, 0) per row,
// whose first n/2 + 1 columns are the r2c; and the c2c of the Hermitian
// extension (X[n-k] = conj X[k], the imaginary parts of X[0] and, at even
// n, X[n/2] dropped, as numpy's c2r does) whose real part is the c2r.
// (The reference's irfft_last weights its last column as a Nyquist column
// at every n, so at odd n it differs from numpy's irfft; these kernels
// compute numpy's irfft.)
//
// The r2c also computes the packed r2c, rows 4 and 17
// (mpifft4py_tpu/ops/pallas_fft3d.py rfft_last_packed, _rfft_kernel over
// _packed_rdft_cs, and mpifft4py_tpu/ops/pallas_zdif.py rfft_last_zdif,
// _zdif_fwd_kernel): the output modes Out::kPacked and Out::kPackedDif
// store h = n/2 columns, nf = ld = h, with column 0 holding the rider
// X[0] + i*X[h]; kPackedDif puts column k at lane packedz::zdif_lane(k, n)
// (the DIF order of the packed 2D layout, n = r*128, r in {4, 6, 8}).  A
// row is staged whole in the slot before its bulk store, so the
// permutation costs no scattered global stores.
//
// Like the c2r of packed_rfft.cu it is bound by HBM bytes: 4 bytes a real
// sample and 8 a spectral column (about 2.5 n log2 n flops a row is far
// below the 67 TFLOP/s of FP32).  The c2r and the odd-n kernels take one
// tile of RB rows a block (RB * m <= kTile), load, transform and store it
// in turn, and mask the last block of a ragged stack.  The r2c
// (planar_rfft_kernel, rows 8, 21, 4 and 17) is fft_last.cu's persistent
// design (bulk_ring.cuh) with two row lengths, n floats in and ld values
// out:
//
// - a tile is RB whole rows: one run of RB * n input floats and one run of
//   RB * ld output values a plane (planar and packed: two planes of floats;
//   kC64: one of float2); RB is the most rows with h * RB <= kTile whose
//   input and output runs are multiples of 16 bytes (so every tile of an
//   aligned tensor goes wholly by bulk copy) and whose two slots and work
//   tile fit in a block's shared memory; a slot holds the larger of the two
//   runs;
// - a persistent grid walks the tiles; one thread brings tile it + 1 into
//   the other slot with a bulk copy (an mbarrier a slot) while the block
//   works on tile it;
// - a landing pass forms z_t = x[2t] + i*x[2t+1] in the transposed work
//   tile; block_fft_fast (fft_block.cuh: Stockham stages with index
//   division by multiply-high, a pair-sum stage for each prime >= 11, up
//   to h = 1021) transforms its RB columns, the last stage in place;
// - the untangle is paired: one thread takes the columns k and h - k of a
//   row from one load each of Z[k] and Z[h-k] and one twiddle
//   (untangle_pair), folds in the scale, the doubled column nf - 1 and the
//   zero columns nf..ld-1, and stages the row-major spectrum in the slot
//   the tile came in;
// - one thread stores the slot with bulk copies, one a plane; values off
//   the 16-byte grid (a view that starts inside a buffer, a ragged last
//   tile's end) go by ordinary loads and stores.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bulk_ring.cuh"
#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

using namespace bulkring;

// The r2c's output: the planar pair, interleaved complex64, the packed
// planar pair (h columns, the rider in column 0), the same in DIF lane order
enum class Out { kPlanar, kC64, kPacked, kPackedDif };

template <bool kC64>
__device__ __forceinline__ float2 get(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      long long g) {
  return kC64 ? reinterpret_cast<const float2*>(xr)[g]
              : make_float2(xr[g], xi[g]);
}

// Columns k and h - k (1 <= k < h - k) of a row from its spectral pair
// Z = Z[k], Zf = Z[h-k] and w = tw_n[k] = exp(-2 pi i k/n): packed_z.cuh's
// untangle for both, with exp(-2 pi i (h-k)/n) = -conj(w):
//   X[k] = (Er + A, Ei + B),  X[h-k] = (Er - A, B - Ei),
// Er, Ei, Or, Oi as there and A + iB = w (Or + i Oi).
__device__ __forceinline__ void untangle_pair(float2 Z, float2 Zf, float2 w,
                                              float2& Xk, float2& Xf) {
  const float Er = 0.5f * (Z.x + Zf.x);
  const float Ei = 0.5f * (Z.y - Zf.y);
  const float Or = 0.5f * (Z.y + Zf.y);
  const float Oi = 0.5f * (Zf.x - Z.x);
  const float A = w.x * Or - w.y * Oi;
  const float B = w.x * Oi + w.y * Or;
  Xk = make_float2(Er + A, Ei + B);
  Xf = make_float2(Er - A, B - Ei);
}

// Tile it of a block lands in slot it % 2 (SL floats a slot).  In iteration
// it the block waits for tile it and moves it into the work tile; then
// thread 0 waits until the bulk store of tile it - 1 has read slot
// (it + 1) % 2 and loads tile it + 1 into it, while the block transforms
// tile it, stages its spectrum row-major in slot it % 2 (now free) and
// thread 0 stores it.  Out::kC64: yr is the interleaved output, yi
// unused.  The packed modes differ only in column 0 (and kPackedDif in
// where each column goes), guarded by if constexpr.
template <Out kOut, bool kMixed>
__global__ void
__launch_bounds__(fftblock::kTile / fftblock::kRowEPT<kMixed>, 2)
planar_rfft_kernel(const float* __restrict__ x, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw_h,
                   const float2* __restrict__ tw_n, Plan plan, int n,
                   long long rows, int RB, int nf, int ld, int dbl,
                   float scale, int SL) {
  constexpr bool kC64 = kOut == Out::kC64;
  constexpr bool kPacked = kOut == Out::kPacked || kOut == Out::kPackedDif;
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kC64 ? 8 : 4;
  const int h = n / 2;
  const int PL = slot_plane(ld * RB);  // the im plane's offset in a slot
  const int pitch = RB + 1;
  float2* s = reinterpret_cast<float2*>(smem + 2 * SL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + h * pitch);
  const long long tiles = (rows + RB - 1) / RB;
  // items a row of the untangle: the pairs (k, h - k) for k = 0..h/2 with
  // a column below nf (k = 0: X[0] and X[h])
  const int kmax = min(h / 2 + 1, nf);
  const int pad = ld - nf;
  const fftblock::FastDiv fh(h), fcol(RB), fk(kmax), fpad(max(pad, 1));
  const float last = dbl ? 2.f * scale : scale;
  const auto rows_of = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(RB), rows - t * RB));
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_tile<4, false>(x, nullptr,
                        blockIdx.x * static_cast<long long>(RB) * n,
                        rows_of(blockIdx.x) * n, smem, 0, &bar[0]);
  }
  __syncthreads();

  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    float* slot = smem + b * SL;
    const int nrows = rows_of(tile);
    const long long v0 = tile * RB * n;
    const int len = nrows * n;
    mbar_wait(&bar[b], (it >> 1) & 1);

    // the landing slot (row-major floats) -> the work tile: z_t of row rho
    // at s[t * pitch + rho]; rows past the end are zeros
    const Run r = run_of<4>(x, v0, len);
    for (int e = threadIdx.x; e < h * RB; e += blockDim.x) {
      const int rho = fh.div(e);
      const int t = e - rho * h;
      const int f = 2 * e;
      float2 v = make_float2(0.f, 0.f);
      if (f < len) {
        if (!(r.mis & 1) && in_bulk(r, f) && in_bulk(r, f + 1)) {
          v = *reinterpret_cast<const float2*>(slot + r.mis + f);
        } else {
          v.x = in_bulk(r, f) ? slot[r.mis + f] : __ldg(x + v0 + f);
          v.y = in_bulk(r, f + 1) ? slot[r.mis + f + 1]
                                  : __ldg(x + v0 + f + 1);
        }
      }
      s[t * pitch + rho] = v;
    }
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < tiles) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      load_tile<4, false>(x, nullptr, next * RB * n, rows_of(next) * n,
                          smem + (b ^ 1) * SL, 0, &bar[b ^ 1]);
    }

    // Z = the h-point spectrum of each column, left in the work tile (the
    // last register stage writes in place: its outputs are its inputs'
    // slots)
    const auto keep = [&](int c, int k, float2 v) { s[k * pitch + c] = v; };
    fftblock::block_fft_fast<kMixed, fftblock::kRowEPT<kMixed>>(
        s, h, fcol, pitch, plan, tw_h, -1.f, keep);
    __syncthreads();

    // row rho, column c of the spectrum: staged row-major in the slot for
    // the bulk store, or stored where it cannot go by bulk copy
    const long long w0 = tile * RB * ld;
    const int lout = nrows * ld;
    const Run o0 = run_of<kB>(yr, w0, lout);
    const Run o1 = kC64 ? o0 : run_of<kB>(yi, w0, lout);
    const auto put = [&](int rho, int c, float re, float im) {
      if constexpr (kOut == Out::kPackedDif) c = packedz::zdif_lane(c, n);
      const int e = rho * ld + c;
      if (kC64) {
        if (in_bulk(o0, e))
          reinterpret_cast<float2*>(slot)[o0.mis + e] = make_float2(re, im);
        else
          reinterpret_cast<float2*>(yr)[w0 + e] = make_float2(re, im);
      } else {
        if (in_bulk(o0, e))
          slot[o0.mis + e] = re;
        else
          yr[w0 + e] = re;
        if (in_bulk(o1, e))
          slot[PL + o1.mis + e] = im;
        else
          yi[w0 + e] = im;
      }
    };
    for (int e = threadIdx.x; e < nrows * kmax; e += blockDim.x) {
      const int rho = fk.div(e);
      const int k = e - rho * kmax;
      const float2 Z = s[k * pitch + rho];
      if (k == 0) {  // X[0] = Z.x + Z.y, X[h] = Z.x - Z.y (nf >= 2)
        if constexpr (kPacked) {
          put(rho, 0, (Z.x + Z.y) * scale, (Z.x - Z.y) * scale);
        } else {
          put(rho, 0, (Z.x + Z.y) * scale, 0.f);
          if (nf == h + 1) put(rho, h, (Z.x - Z.y) * scale, 0.f);
        }
        continue;
      }
      const float2 Zf = s[(h - k) * pitch + rho];
      float2 Xk, Xf;
      untangle_pair(Z, Zf, __ldg(&tw_n[k]), Xk, Xf);
      const float wk = k == nf - 1 ? last : scale;
      put(rho, k, Xk.x * wk, Xk.y * wk);
      if (h - k != k && h - k < nf) {
        const float wf = h - k == nf - 1 ? last : scale;
        put(rho, h - k, Xf.x * wf, Xf.y * wf);
      }
    }
    for (int e = threadIdx.x; e < nrows * pad; e += blockDim.x) {
      const int rho = fpad.div(e);
      put(rho, nf + e - rho * pad, 0.f, 0.f);
    }
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0)
      store_tile<kB, !kC64>(yr, yi, w0, lout, slot, PL);
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Column k (0 <= k < h) of the packed form of a planar row at g with
// nf_in columns: P_0 = X[0] + i*X[h] (X[h] = 0 unless nf_in = h + 1),
// P_k = X[k] below nf_in, the interior column nf_in-1 halved.
template <bool kC64>
__device__ __forceinline__ float2 packed_in(const float* __restrict__ xr,
                                            const float* __restrict__ xi,
                                            long long g, int k, int h,
                                            int nf_in) {
  if (k == 0)
    return make_float2(get<kC64>(xr, xi, g).x,
                       nf_in == h + 1 ? get<kC64>(xr, xi, g + h).x : 0.f);
  if (k >= nf_in) return make_float2(0.f, 0.f);
  const float w = k == nf_in - 1 ? 0.5f : 1.f;
  const float2 X = get<kC64>(xr, xi, g + k);
  return make_float2(w * X.x, w * X.y);
}

template <bool kC64, bool kMixed>
__global__ void __launch_bounds__(1024)
planar_irfft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ y, const float2* __restrict__ tw_h,
                    const float2* __restrict__ tw_n, Plan plan, int n,
                    long long rows, int RB, int nf_in, int ld,
                    float scale) {
  extern __shared__ float2 s[];
  const int h = n / 2;
  const int pitch = RB + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  const int elems = h * RB;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int k = e % h;
    float2 Z = make_float2(0.f, 0.f);
    if (row0 + rho < rows) {
      const long long g = (row0 + rho) * ld;
      const float2 X = packed_in<kC64>(xr, xi, g, k, h, nf_in);
      if (k == 0) {
        // E0 = X[0] + X[h], O0 = X[0] - X[h]
        Z = make_float2(X.x + X.y, X.x - X.y);
      } else {
        const float2 Xf = packed_in<kC64>(xr, xi, g, h - k, h, nf_in);
        const float Er = X.x + Xf.x;  // 2 E = X + conj X[h-k]
        const float Ei = X.y - Xf.y;
        const float Dr = X.x - Xf.x;  // 2 e^{-2 pi i k/n} O = X - conj X[h-k]
        const float Di = X.y + Xf.y;
        const float2 w = tw_n[k];     // exp(+2 pi i k / n)
        const float Or = w.x * Dr - w.y * Di;
        const float Oi = w.x * Di + w.y * Dr;
        Z = make_float2(Er - Oi, Ei + Or);  // 2 (E + i O)
      }
    }
    s[k * pitch + rho] = Z;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, h, RB, pitch, plan, tw_h, 1.f);
  const float sc = scale / static_cast<float>(n);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int t = e % h;
    if (row0 + rho >= rows) continue;
    const float2 z = s[t * pitch + rho];
    reinterpret_cast<float2*>(y + (row0 + rho) * n)[t] =
        make_float2(z.x * sc, z.y * sc);
  }
}

// The full-length r2c of rows of any length 2 <= n <= 1024 (used at odd
// n): RB rows a block, the tile transposed as in fft_last.cu; the first
// n/2 + 1 columns go out as complex64.
template <bool kMixed>
__global__ void __launch_bounds__(1024)
rfft_full_kernel(const float* __restrict__ x, float2* __restrict__ y,
                 const float2* __restrict__ tw, Plan plan, int n,
                 long long rows, int RB) {
  extern __shared__ float2 s[];
  const int pitch = RB + 1;
  const int nf = n / 2 + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  for (int e = threadIdx.x; e < n * RB; e += blockDim.x) {
    const int rho = e / n;
    const int t = e % n;
    const float v = row0 + rho < rows ? x[(row0 + rho) * n + t] : 0.f;
    s[t * pitch + rho] = make_float2(v, 0.f);
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n, RB, pitch, plan, tw, -1.f);
  for (int e = threadIdx.x; e < nf * RB; e += blockDim.x) {
    const int rho = e / nf;
    const int k = e % nf;
    if (row0 + rho < rows) y[(row0 + rho) * nf + k] = s[k * pitch + rho];
  }
}

// Its inverse: the Hermitian extension of n/2 + 1 complex64 columns, one
// n-point c2c, the real part scaled by 1/n.
template <bool kMixed>
__global__ void __launch_bounds__(1024)
irfft_full_kernel(const float2* __restrict__ x, float* __restrict__ y,
                  const float2* __restrict__ tw, Plan plan, int n,
                  long long rows, int RB) {
  extern __shared__ float2 s[];
  const int pitch = RB + 1;
  const int nf = n / 2 + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  for (int e = threadIdx.x; e < n * RB; e += blockDim.x) {
    const int rho = e / n;
    const int k = e % n;
    float2 X = make_float2(0.f, 0.f);
    if (row0 + rho < rows) {
      const long long g = (row0 + rho) * nf;
      if (k < nf) {
        X = x[g + k];
        if (k == 0 || 2 * k == n) X.y = 0.f;
      } else {
        const float2 Xc = x[g + n - k];
        X = make_float2(Xc.x, -Xc.y);
      }
    }
    s[k * pitch + rho] = X;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n, RB, pitch, plan, tw, 1.f);
  const float inv_n = 1.f / static_cast<float>(n);
  for (int e = threadIdx.x; e < n * RB; e += blockDim.x) {
    const int rho = e / n;
    const int t = e % n;
    if (row0 + rho < rows)
      y[(row0 + rho) * n + t] = s[t * pitch + rho].x * inv_n;
  }
}

// The r2c's tile: RB rows, SL floats a slot, smem bytes a block.
struct RfftTile {
  int RB, SL;
  size_t smem;
};

// The most rows with h * RB <= kTile whose input run (RB * n floats) and
// output run (RB * ld values of kB bytes) are multiples of 16 bytes and
// whose two slots and work tile fit in max_smem bytes; failing alignment,
// the most rows that fit; RB = 0 if none does.  A slot holds the input
// run or the output runs, each with up to 16 bytes in front.
RfftTile rfft_tile(int n, int ld, int kB, int max_smem) {
  const int h = n / 2;
  RfftTile best{0, 0, 0};
  for (int RB = fftblock::kTile / h; RB >= 1; --RB) {
    const long long out = static_cast<long long>(RB) * ld;
    if (8 * out > max_smem) continue;
    const int SL = std::max(slot_plane(RB * n),
                            2 * slot_plane(static_cast<int>(out)));
    const size_t smem = sizeof(float) * 2 * SL +
                        sizeof(float2) * h * (RB + 1) + sizeof(uint64_t) * 2;
    if (smem > static_cast<size_t>(max_smem)) continue;
    const RfftTile g{RB, SL, smem};
    if ((RB * n * 4) % 16 == 0 && (out * kB) % 16 == 0) return g;
    if (!best.RB) best = g;
  }
  return best;
}

template <Out kOut, bool kMixed>
int launch_rfft_instance(const float* x, float* yr, float* yi,
                         const float2* tw_h, const float2* tw_n,
                         const Plan& plan, long long rows, int n, int nf,
                         int ld, int dbl, float scale, cudaStream_t stream) {
  constexpr int kE = fftblock::kRowEPT<kMixed>;
  int dev = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const RfftTile g = rfft_tile(n, ld, kOut == Out::kC64 ? 8 : 4, max_smem);
  if (!g.RB) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n / 2 * g.RB + kE * 32 - 1) / (kE * 32) * 32;
  const long long tiles = (rows + g.RB - 1) / g.RB;
  return launch_persistent(planar_rfft_kernel<kOut, kMixed>, tiles, threads,
                           g.smem, stream, x, yr, yi, tw_h, tw_n, plan, n,
                           rows, g.RB, nf, ld, dbl, scale, g.SL);
}

// A base misaligned for its value type (x, planar or packed yr/yi not
// 4-byte aligned; kC64 y not 8-byte aligned) is refused.
template <Out kOut>
int launch_rfft(const float* x, float* yr, float* yi, const void* tw_h,
                const void* tw_n, long long rows, int n, int nf, int ld,
                int dbl, float scale, void* stream) {
  if (n % 2 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = fftblock::make_plan(n / 2);
  if (plan.nst == 0 || nf < 2 || nf > n / 2 + 1 || ld < nf)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(yi)) %
          4 ||
      reinterpret_cast<uintptr_t>(yr) % (kOut == Out::kC64 ? 8 : 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* th = static_cast<const float2*>(tw_h);
  const auto* tn = static_cast<const float2*>(tw_n);
  auto st = static_cast<cudaStream_t>(stream);
  return fftblock::mixed_plan(plan)
             ? launch_rfft_instance<kOut, true>(x, yr, yi, th, tn, plan,
                                                rows, n, nf, ld, dbl, scale,
                                                st)
             : launch_rfft_instance<kOut, false>(x, yr, yi, th, tn, plan,
                                                 rows, n, nf, ld, dbl, scale,
                                                 st);
}

template <bool kC64>
int launch_irfft(const float* xr, const float* xi, float* y,
                 const void* tw_h, const void* tw_n, long long rows, int n,
                 int nf_in, int ld, float scale, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  if (nf_in < 2 || nf_in > n / 2 + 1 || ld < nf_in)
    return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? planar_irfft_kernel<kC64, true>
                                   : planar_irfft_kernel<kC64, false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), xr, xi,
      y, static_cast<const float2*>(tw_h), static_cast<const float2*>(tw_n),
      g.plan, n, rows, g.RB, nf_in, ld, scale);
}

}  // namespace

// Forward: x (rows, n) real -> (yr, yi) (rows, ld), 2 <= nf <= n/2 + 1,
// nf <= ld, even n <= 2048: columns nf..ld-1 are zeros; dbl doubles column
// nf-1; every column is multiplied by scale.  tw_h: n/2 float2 of
// exp(-2 pi i m/(n/2)); tw_n: n/2 float2 of exp(-2 pi i k/n).
extern "C" int planar_rfft_launch(const float* x, float* yr, float* yi,
                                  const void* tw_h, const void* tw_n,
                                  long long rows, int n, int nf, int ld,
                                  int dbl, float scale, void* stream) {
  return launch_rfft<Out::kPlanar>(x, yr, yi, tw_h, tw_n, rows, n, nf, ld,
                                   dbl, scale, stream);
}

// Inverse: the first nf_in columns of (xr, xi) (rows, ld) -> y (rows, n)
// real, 2 <= nf_in <= n/2 + 1, nf_in <= ld, scaled by scale/n.  tw_h and
// tw_n as above with the opposite sign, exp(+...).
extern "C" int planar_irfft_launch(const float* xr, const float* xi, float* y,
                                   const void* tw_h, const void* tw_n,
                                   long long rows, int n, int nf_in, int ld,
                                   float scale, void* stream) {
  return launch_irfft<false>(xr, xi, y, tw_h, tw_n, rows, n, nf_in, ld,
                             scale, stream);
}

// Row 21 at even n <= 2048: x (rows, n) real -> y (rows, n/2 + 1)
// complex64, numpy's rfft; tw_h, tw_n as for planar_rfft_launch.
extern "C" int rfft_c64_launch(const float* x, void* y, const void* tw_h,
                               const void* tw_n, long long rows, int n,
                               void* stream) {
  return launch_rfft<Out::kC64>(x, static_cast<float*>(y), nullptr, tw_h,
                                tw_n, rows, n, n / 2 + 1, n / 2 + 1, 0, 1.f,
                                stream);
}

// Row 4: x (rows, n) real -> (yr, yi) (rows, n/2), the packed layout
// (column 0 holds X[0] + i*X[n/2]), even n <= 2048; tw_h, tw_n as for
// planar_rfft_launch.
extern "C" int packed_rfft_launch(const float* x, float* yr, float* yi,
                                  const void* tw_h, const void* tw_n,
                                  long long rows, int n, void* stream) {
  return launch_rfft<Out::kPacked>(x, yr, yi, tw_h, tw_n, rows, n, n / 2,
                                   n / 2, 0, 1.f, stream);
}

// Row 17: the same in DIF lane order (column k at lane zdif_lane(k, n));
// n must be r*128 with r in {4, 6, 8}.
extern "C" int packed_rfft_zdif_launch(const float* x, float* yr, float* yi,
                                       const void* tw_h, const void* tw_n,
                                       long long rows, int n, void* stream) {
  if (!packedz::zdif_ok(n)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rfft<Out::kPackedDif>(x, yr, yi, tw_h, tw_n, rows, n, n / 2,
                                      n / 2, 0, 1.f, stream);
}

// Row 22 at even n <= 2048: x (rows, n/2 + 1) complex64 -> y (rows, n)
// real, numpy's irfft; tw_h, tw_n as for planar_irfft_launch.
extern "C" int irfft_c64_launch(const void* x, float* y, const void* tw_h,
                                const void* tw_n, long long rows, int n,
                                void* stream) {
  return launch_irfft<true>(static_cast<const float*>(x), nullptr, y, tw_h,
                            tw_n, rows, n, n / 2 + 1, n / 2 + 1, 1.f,
                            stream);
}

// Rows 21-22 full-length, any 2 <= n <= 1024 (the wrappers take them at
// odd n): tw is n float2 of exp(-2 pi i m/n) (forward) or exp(+2 pi i m/n)
// (inverse).
extern "C" int rfft_full_c64_launch(const float* x, void* y, const void* tw,
                                    long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = fftblock::row_geometry(n, rows, &g);
  if (bad) return bad;
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? rfft_full_kernel<true>
                                   : rfft_full_kernel<false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), x,
      static_cast<float2*>(y), static_cast<const float2*>(tw), g.plan, n,
      rows, g.RB);
}

extern "C" int irfft_full_c64_launch(const void* x, float* y, const void* tw,
                                     long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = fftblock::row_geometry(n, rows, &g);
  if (bad) return bad;
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? irfft_full_kernel<true>
                                   : irfft_full_kernel<false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream),
      static_cast<const float2*>(x), y, static_cast<const float2*>(tw),
      g.plan, n, rows, g.RB);
}
