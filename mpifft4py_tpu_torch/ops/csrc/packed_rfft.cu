// Packed-Hermitian c2r along the last (contiguous) axis.
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// irfft_last_packed (_ipacked_kernel), which contracts each row with dense
// (n/2 x n) DFT matrices on the MXU.  The layout is the reference's: the
// spectrum of a real row of length n sits in h = n/2 complex columns,
// column 0 holding X[0] + i*X[n/2].  Its forward, rfft_last_packed (row 4,
// packed_rfft_launch) and rfft_last_zdif (row 17, packed_rfft_zdif_launch),
// is computed by planar_rfft.cu's persistent r2c (planar_rfft_kernel, in
// its packed output modes).
//
// The algorithm is the mirror image of the reference's half-length
// _rfft_last_packed_fact (pallas_fft3d.py:656-669): the packed row is
// folded into Z[k] = (E + i O)[k] of the h-point spectrum of
// z_t = x[2t] + i*x[2t+1] (the inverse of packed_z.cuh's untangle), one
// h-point inverse FFT gives z, and 1/n is folded into the store.
//
// On the H100 the row transform is HBM-bound like fft_axis (about
// 2.5 n log2 n flops on 12 bytes per real sample).  Rows are contiguous, so
// a block takes RB rows (h * RB = 4096 complex values), builds Z of each
// row in shared memory (index-major, with an odd pitch of RB + 1 so the
// strided accesses spread over the banks), runs the Stockham FFT of
// fft_block.cuh over its RB columns, and stores (x[2t], x[2t+1]) with
// coalesced 8-byte stores.
//
// The template parameter kDif picks the lane order of the spectrum.  false:
// natural (column k holds X[k]).  true: the DIF order of the reference's
// mpifft4py_tpu/ops/pallas_zdif.py irfft_last_zdif (_zdif_bwd_kernel), row
// 18, which the packed 2D layout keeps at n = r*128, r in {4, 6, 8}.  The
// TPU splits the transform in frequency to cut its dense matmuls; here the
// half-length FFT already does O(n log n) work, so only the order of the
// loads changes, through the closed form zdif_lane of packed_z.cuh: the
// kernel reads X[k] and X[h-k] from lanes zdif_lane(k), zdif_lane(h-k)
// (h-k is never 0, so the rider lane is read only for k = 0).  Bound: HBM
// bytes, as the natural kernel; a 2D field is small (1024 rows at 1024^2:
// 128 blocks of 8 rows) and its steps are bound by launches, not by this
// kernel.
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

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

// One launch of the inverse (kDif picks the lane order); 0 or the CUDA
// error.
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

// Inverse: (xr, xi) (rows, n/2) -> y (rows, n) real, scaled by 1/n.
// tw_h: n/2 float2 of exp(+2 pi i m/(n/2)); tw_n: n/2 float2 of
// exp(+2 pi i k/n).
extern "C" int packed_irfft_launch(const float* xr, const float* xi, float* y,
                                   const void* tw_h, const void* tw_n,
                                   long long rows, int n, void* stream) {
  return launch_irfft<false>(xr, xi, y, tw_h, tw_n, rows, n, stream);
}

// Row 18: the same with the spectrum in DIF lane order; n must be r*128
// with r in {4, 6, 8}.
extern "C" int packed_irfft_zdif_launch(const float* xr, const float* xi,
                                        float* y, const void* tw_h,
                                        const void* tw_n, long long rows,
                                        int n, void* stream) {
  if (!packedz::zdif_ok(n)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_irfft<true>(xr, xi, y, tw_h, tw_n, rows, n, stream);
}
