// Planar r2c / c2r along the last (contiguous) axis, with the 3/2-rule
// truncation and zero-pad folded in.
//
// Replaces the Pallas kernels mpifft4py_tpu/ops/pallas_fft3d.py:
// rfft_last_planar (_rfft_kernel over _rdft_cs) and irfft_last_planar
// (_irfft_kernel over _irdft_cs), which contract each row with dense
// (n x nfp) DFT matrices on the MXU, nfp = nf rounded up to 128 lanes.
// Here a spectrum has exactly nf columns (no lane padding), and the
// transform is packed_rfft.cu's half-length algorithm: one h-point FFT of
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
// The template parameter kC64 picks the spectrum's global layout: false,
// the planar pair; true, interleaved complex64, for the dense tier's
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
// Like packed_rfft.cu it is bound by HBM bytes: 4 bytes a real sample and
// 8 a spectral column (about 2.5 n log2 n flops a row is far below the
// 67 TFLOP/s of FP32).  The 3/2-rule rows (n = 384, h = 192 = 3 * 64) run
// the radix-3 stage of fft_block.cuh; RB = 21 rows a block, and the last
// block of a stack whose row count is not a multiple of 21 is masked.
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

template <bool kC64>
__device__ __forceinline__ float2 get(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      long long g) {
  return kC64 ? reinterpret_cast<const float2*>(xr)[g]
              : make_float2(xr[g], xi[g]);
}

template <bool kC64>
__device__ __forceinline__ void put(float* __restrict__ yr,
                                    float* __restrict__ yi, long long g,
                                    float re, float im) {
  if (kC64) {
    reinterpret_cast<float2*>(yr)[g] = make_float2(re, im);
  } else {
    yr[g] = re;
    yi[g] = im;
  }
}

template <bool kC64, bool kMixed>
__global__ void __launch_bounds__(1024)
planar_rfft_kernel(const float* __restrict__ x, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw_h,
                   const float2* __restrict__ tw_n, Plan plan, int n,
                   long long rows, int RB, int nf, int ld, int dbl,
                   float scale) {
  extern __shared__ float2 s[];
  const int h = n / 2;
  const int pitch = RB + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  const int elems = h * RB;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int t = e % h;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + rho < rows)
      v = reinterpret_cast<const float2*>(x + (row0 + rho) * n)[t];
    s[t * pitch + rho] = v;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, h, RB, pitch, plan, tw_h, -1.f);
  // columns 0..kmax-1 come from the untangle; column h from plane 0
  const int kmax = nf < h ? nf : h;
  const float last = dbl ? 2.f * scale : scale;
  for (int e = threadIdx.x; e < kmax * RB; e += blockDim.x) {
    const int rho = e / kmax;
    const int k = e % kmax;
    if (row0 + rho >= rows) continue;
    const float2 X = packedz::untangle(s, pitch, rho, k, h, tw_n);
    const long long g = (row0 + rho) * ld;
    const float w = k == nf - 1 ? last : scale;
    if (k == 0) {  // X = (X[0], X[h])
      put<kC64>(yr, yi, g, X.x * w, 0.f);
      if (nf == h + 1) put<kC64>(yr, yi, g + h, X.y * scale, 0.f);
    } else {
      put<kC64>(yr, yi, g + k, X.x * w, X.y * w);
    }
  }
  const int pad = ld - nf;
  for (int e = threadIdx.x; e < pad * RB; e += blockDim.x) {
    const int rho = e / pad;
    if (row0 + rho < rows)
      put<kC64>(yr, yi, (row0 + rho) * ld + nf + e % pad, 0.f, 0.f);
  }
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

template <bool kC64>
int launch_rfft(const float* x, float* yr, float* yi, const void* tw_h,
                const void* tw_n, long long rows, int n, int nf, int ld,
                int dbl, float scale, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  if (nf < 2 || nf > n / 2 + 1 || ld < nf)
    return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? planar_rfft_kernel<kC64, true>
                                   : planar_rfft_kernel<kC64, false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), x, yr,
      yi, static_cast<const float2*>(tw_h), static_cast<const float2*>(tw_n),
      g.plan, n, rows, g.RB, nf, ld, dbl, scale);
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
  return launch_rfft<false>(x, yr, yi, tw_h, tw_n, rows, n, nf, ld, dbl,
                            scale, stream);
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
  return launch_rfft<true>(x, static_cast<float*>(y), nullptr, tw_h, tw_n,
                           rows, n, n / 2 + 1, n / 2 + 1, 0, 1.f, stream);
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
