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
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

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
  fftblock::block_fft(s, h, RB, pitch, plan, tw_h, -1.f);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / h;
    const int k = e % h;
    if (row0 + rho >= rows) continue;
    const float2 X = packedz::untangle(s, pitch, rho, k, h, tw_n);
    const long long g = (row0 + rho) * h + k;
    yr[g] = X.x;
    yi[g] = X.y;
  }
}

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
      const float Xr = xr[g + k];
      const float Xi = xi[g + k];
      if (k == 0) {
        // X[0] = Xr, X[n/2] = Xi: E0 = X0 + Xny, O0 = X0 - Xny
        Z = make_float2(Xr + Xi, Xr - Xi);
      } else {
        const float Xfr = xr[g + h - k];
        const float Xfi = xi[g + h - k];
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
  fftblock::block_fft(s, h, RB, pitch, plan, tw_h, 1.f);
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

}  // namespace

// Forward: x (rows, n) real -> (yr, yi) (rows, n/2).  tw_h: n/2 float2 of
// exp(-2 pi i m/(n/2)); tw_n: n/2 float2 of exp(-2 pi i k/n).
extern "C" int packed_rfft_launch(const float* x, float* yr, float* yi,
                                  const void* tw_h, const void* tw_n,
                                  long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      packed_rfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_rfft_kernel<<<g.blocks, g.threads, g.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, yr, yi, static_cast<const float2*>(tw_h),
      static_cast<const float2*>(tw_n), g.plan, n, rows, g.RB);
  return static_cast<int>(cudaGetLastError());
}

// Inverse: (xr, xi) (rows, n/2) -> y (rows, n) real, scaled by 1/n.
// tw_h and tw_n as above with the opposite sign, exp(+...).
extern "C" int packed_irfft_launch(const float* xr, const float* xi, float* y,
                                   const void* tw_h, const void* tw_n,
                                   long long rows, int n, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      packed_irfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_irfft_kernel<<<g.blocks, g.threads, g.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xr, xi, y, static_cast<const float2*>(tw_h),
      static_cast<const float2*>(tw_n), g.plan, n, rows, g.RB);
  return static_cast<int>(cudaGetLastError());
}
