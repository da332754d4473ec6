// Packed-Hermitian r2c / c2r along the last (contiguous) axis.
//
// Replaces the Pallas kernels mpifft4py_tpu/ops/pallas_fft3d.py:
// rfft_last_packed (_rfft_kernel over _packed_rdft_cs) and
// irfft_last_packed (_ipacked_kernel), which contract each row with dense
// (n x n/2) DFT matrices on the MXU.  The layout is theirs: the spectrum
// of a real row of length n sits in h = n/2 complex columns, column 0
// holding X[0] + i*X[n/2].
//
// The algorithm is the half-length one of the reference's
// _rfft_last_packed_fact (pallas_fft3d.py:656-669): z_t = x[2t] + i*x[2t+1],
// Z = FFT_h(z), then the untangle of packed_z.cuh.  The inverse is its
// mirror image, with 1/n folded into the store.
//
// On the H100 the row transform is HBM-bound like fft_axis (about
// 2.5 n log2 n flops on 12 bytes per real sample).  Rows are contiguous, so
// a block takes RB rows (h * RB = 4096 complex values), reads each row with
// coalesced 8-byte loads of (x[2t], x[2t+1]), keeps the tile transposed in
// shared memory (index-major, with an odd pitch of RB + 1 so the strided
// accesses spread over the banks), runs the Stockham FFT of
// fft_block.cuh over its RB columns, and untangles on the way out.
//
// The template parameter kDif picks the lane order of the spectrum.  false:
// natural (column k holds X[k]).  true: the DIF order of the reference's
// mpifft4py_tpu/ops/pallas_zdif.py rfft_last_zdif (_zdif_fwd_kernel) and
// irfft_last_zdif (_zdif_bwd_kernel), rows 17-18, which the packed 2D
// layout keeps at n = r*128, r in {4, 6, 8}.  The TPU splits the transform
// in frequency to cut its dense matmuls; here the half-length FFT already
// does O(n log n) work, so only the order of the stores (forward) and the
// loads (inverse) changes, through the closed forms zdif_k / zdif_lane of
// packed_z.cuh.  The forward walks output lanes (coalesced stores) and
// untangles k = zdif_k(lane) from shared memory; the inverse reads X[k] and
// X[h-k] from lanes zdif_lane(k), zdif_lane(h-k) (h-k is never 0, so the
// rider lane is read only for k = 0).  Bound: HBM bytes, as the natural
// kernels; a 2D field is small (1024 rows at 1024^2: 128 blocks of 8 rows)
// and its steps are bound by launches, not by this kernel.
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

template <bool kDif, bool kMixed>
__global__ void __launch_bounds__(1024)
packed_rfft_kernel(const float* __restrict__ x, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw_h,
                   const float2* __restrict__ tw_n, Plan plan, int n,
                   long long rows, int RB) {
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
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int lane = e % h;
    if (row0 + rho >= rows) continue;
    const int k = kDif ? packedz::zdif_k(lane, n) : lane;
    const float2 X = packedz::untangle(s, pitch, rho, k, h, tw_n);
    const long long g = (row0 + rho) * h + lane;
    yr[g] = X.x;
    yi[g] = X.y;
  }
}

template <bool kDif, bool kMixed>
__global__ void __launch_bounds__(1024)
packed_irfft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ y, const float2* __restrict__ tw_h,
                    const float2* __restrict__ tw_n, Plan plan, int n,
                    long long rows, int RB) {
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
      const long long g = (row0 + rho) * h;
      const int lk = kDif ? packedz::zdif_lane(k, n) : k;
      const float Xr = xr[g + lk];
      const float Xi = xi[g + lk];
      if (k == 0) {
        // X[0] = Xr, X[n/2] = Xi: E0 = X0 + Xny, O0 = X0 - Xny
        Z = make_float2(Xr + Xi, Xr - Xi);
      } else {
        const int lf = kDif ? packedz::zdif_lane(h - k, n) : h - k;
        const float Xfr = xr[g + lf];
        const float Xfi = xi[g + lf];
        const float Er = Xr + Xfr;  // 2 E = X + conj X[h-k]
        const float Ei = Xi - Xfi;
        const float Dr = Xr - Xfr;  // 2 e^{-2 pi i k/n} O = X - conj X[h-k]
        const float Di = Xi + Xfi;
        const float2 w = tw_n[k];   // exp(+2 pi i k / n)
        const float Or = w.x * Dr - w.y * Di;
        const float Oi = w.x * Di + w.y * Dr;
        Z = make_float2(Er - Oi, Ei + Or);  // 2 (E + i O)
      }
    }
    s[k * pitch + rho] = Z;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, h, RB, pitch, plan, tw_h, 1.f);
  const float inv_n = 1.f / static_cast<float>(n);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int t = e % h;
    if (row0 + rho >= rows) continue;
    const float2 z = s[t * pitch + rho];
    reinterpret_cast<float2*>(y + (row0 + rho) * n)[t] =
        make_float2(z.x * inv_n, z.y * inv_n);
  }
}

// One launch of the forward (kDif picks the lane order); 0 or the CUDA
// error.
template <bool kDif>
int launch_rfft(const float* x, float* yr, float* yi, const void* tw_h,
                const void* tw_n, long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? packed_rfft_kernel<kDif, true>
                                   : packed_rfft_kernel<kDif, false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), x, yr,
      yi, static_cast<const float2*>(tw_h), static_cast<const float2*>(tw_n),
      g.plan, n, rows, g.RB);
}

template <bool kDif>
int launch_irfft(const float* xr, const float* xi, float* y, const void* tw_h,
                 const void* tw_n, long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? packed_irfft_kernel<kDif, true>
                                   : packed_irfft_kernel<kDif, false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), xr, xi,
      y, static_cast<const float2*>(tw_h), static_cast<const float2*>(tw_n),
      g.plan, n, rows, g.RB);
}

}  // namespace

// Forward: x (rows, n) real -> (yr, yi) (rows, n/2).  tw_h: n/2 float2 of
// exp(-2 pi i m/(n/2)); tw_n: n/2 float2 of exp(-2 pi i k/n).
extern "C" int packed_rfft_launch(const float* x, float* yr, float* yi,
                                  const void* tw_h, const void* tw_n,
                                  long long rows, int n, void* stream) {
  return launch_rfft<false>(x, yr, yi, tw_h, tw_n, rows, n, stream);
}

// Inverse: (xr, xi) (rows, n/2) -> y (rows, n) real, scaled by 1/n.
// tw_h and tw_n as above with the opposite sign, exp(+...).
extern "C" int packed_irfft_launch(const float* xr, const float* xi, float* y,
                                   const void* tw_h, const void* tw_n,
                                   long long rows, int n, void* stream) {
  return launch_irfft<false>(xr, xi, y, tw_h, tw_n, rows, n, stream);
}

// Rows 17-18: the same transforms with the spectrum in DIF lane order;
// n must be r*128 with r in {4, 6, 8}.
extern "C" int packed_rfft_zdif_launch(const float* x, float* yr, float* yi,
                                       const void* tw_h, const void* tw_n,
                                       long long rows, int n, void* stream) {
  if (!packedz::zdif_ok(n)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rfft<true>(x, yr, yi, tw_h, tw_n, rows, n, stream);
}

extern "C" int packed_irfft_zdif_launch(const float* xr, const float* xi,
                                        float* y, const void* tw_h,
                                        const void* tw_n, long long rows,
                                        int n, void* stream) {
  if (!packedz::zdif_ok(n)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_irfft<true>(xr, xi, y, tw_h, tw_n, rows, n, stream);
}
