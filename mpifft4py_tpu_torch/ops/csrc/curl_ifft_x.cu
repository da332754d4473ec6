// Curl and x-axis inverse FFT of a packed spectral 3-stack, in one pass.
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// curl_irfft3d_packed (_curl_ifft_x_kernel), which forms the vorticity
// spectrum i K x U in VMEM and runs the x inverse as factored MXU matmuls,
// so the curl never lands in device memory.  Planar form of the curl:
//   re(iK x U)_c = -(K_{c+1} Ui_{c+2} - K_{c+2} Ui_{c+1}),
//   im(iK x U)_c =   K_{c+1} Ur_{c+2} - K_{c+2} Ur_{c+1}.
//
// The state pair is (3, n, Q) with Q = N1 * h flattened (k1, k2) columns;
// the wavenumbers arrive as the 1-D vectors k0 (n), k1 (N1), k2 (h).  Like
// fft_axis.cu this is bound by HBM bandwidth, so the design keeps the curl
// out of device memory and reads the state once per block:
//
// - a block takes T consecutive columns of all three components across all
//   n rows, as a tile of n x 3T complex values in shared memory (T from
//   fftblock::stack3_cols: 16 up to n = 256, 96 KB);
// - pass 0 loads the curl, formed from the state and the k vectors as it is
//   read, and one block_fft transforms the three components together;
// - with the state, pass 1 loads the state itself and transforms it in the
//   same buffer (its reads hit the lines pass 0 brought into cache);
// - 1/n is folded into the store.  The outputs go to one (3 or 6, n, Q)
//   pair, curl first, so the y and z inverses that follow run once over all
//   six components.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

__global__ void __launch_bounds__(1024)
curl_ifft_x_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                   const float* __restrict__ k0, const float* __restrict__ k1,
                   const float* __restrict__ k2, float* __restrict__ yr,
                   float* __restrict__ yi, const float2* __restrict__ tw,
                   Plan plan, int n, int h, int Q, int T, int passes) {
  extern __shared__ float2 s[];
  const int ncol = 3 * T;
  const int q0 = blockIdx.x * T;
  const long long plane = static_cast<long long>(n) * Q;
  const int elems = n * ncol;
  const float scale = 1.f / static_cast<float>(n);
  for (int pass = 0; pass < passes; ++pass) {
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int r = e / ncol;
      const int col = e % ncol;
      const int c = col / T;
      const int q = q0 + col % T;
      float2 v = make_float2(0.f, 0.f);
      if (q < Q) {
        const long long g = static_cast<long long>(r) * Q + q;
        if (pass == 0) {
          // K_{c+1} and K_{c+2}, components taken cyclically
          const float kx = k0[r], ky = k1[q / h], kz = k2[q % h];
          const float Ka = c == 0 ? ky : (c == 1 ? kz : kx);
          const float Kb = c == 0 ? kz : (c == 1 ? kx : ky);
          const long long g1 = ((c + 1) % 3) * plane + g;
          const long long g2 = ((c + 2) % 3) * plane + g;
          v = make_float2(-(Ka * ui[g2] - Kb * ui[g1]),
                          Ka * ur[g2] - Kb * ur[g1]);
        } else {
          v = make_float2(ur[c * plane + g], ui[c * plane + g]);
        }
      }
      s[r * ncol + col] = v;
    }
    __syncthreads();
    fftblock::block_fft(s, n, ncol, ncol, plan, tw, 1.f);
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int r = e / ncol;
      const int col = e % ncol;
      const int q = q0 + col % T;
      if (q < Q) {
        const long long g = (pass * 3 + col / T) * plane
                            + static_cast<long long>(r) * Q + q;
        const float2 v = s[r * ncol + col];
        yr[g] = v.x * scale;
        yi[g] = v.y * scale;
      }
    }
    __syncthreads();  // the next pass overwrites s
  }
}

}  // namespace

// ur, ui: (3, n, n1 * h) state pair; k0 (n), k1 (n1), k2 (h) float32;
// yr, yi: (3 or 6, n, n1 * h), the curl's x inverse first, then (with_state)
// the state's.  tw: n float2 of exp(+2 pi i m / n).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int curl_ifft_x_launch(const float* ur, const float* ui,
                                  const float* k0, const float* k1,
                                  const float* k2, float* yr, float* yi,
                                  const void* tw, int n, int n1, int h,
                                  int with_state, void* stream) {
  const Plan plan = fftblock::make_plan(n);
  const long long Q = static_cast<long long>(n1) * h;
  if (plan.nst == 0 || n > 1024 || n1 < 1 || h < 1 || Q > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = fftblock::stack3_cols(n);
  const long long blocks = (Q + T - 1) / T;
  const size_t smem = static_cast<size_t>(n) * 3 * T * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      curl_ifft_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = fftblock::threads_for(n * 3 * T);
  curl_ifft_x_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      ur, ui, k0, k1, k2, yr, yi, static_cast<const float2*>(tw), plan, n, h,
      static_cast<int>(Q), T, with_state ? 2 : 1);
  return static_cast<int>(cudaGetLastError());
}
