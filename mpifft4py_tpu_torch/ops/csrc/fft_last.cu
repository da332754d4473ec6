// c2c FFT along the last (contiguous) axis of a planar (re, im) float32
// pair viewed as (rows, n).
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_last_planar_c2c (_cfft_last_planar_kernel over _dense_cs), which
// multiplies each row by a dense (n x n) DFT matrix on the MXU (three real
// matmuls, 6 n^2 flops a row).  fft_axis.cu serves every other axis; its
// tiles take T neighbouring columns across all n rows, which on the last
// axis would read one element per row.  So this kernel takes whole rows:
//
// - a block takes RB rows (n * RB <= 4096 complex values), reads them with
//   coalesced 4-byte loads from each plane (neighbouring threads on
//   neighbouring elements of one row) into a transposed tile with an odd
//   pitch where RB is even (index-major, column = row, as packed_rfft.cu
//   keeps its tile), so the strided accesses spread over the banks;
// - the Stockham FFT of fft_block.cuh runs over the RB columns in shared
//   memory (at most 40 KB);
// - it stores in natural order, with 1/n folded into the inverse's store
//   and an optional scale (1/padsize^3 of the 3/2 rule) into both.
//
// It moves 16 bytes a point through HBM (5 n log2 n flops a transform, 2.5
// flops a byte at n = 256), so it is bound by HBM bandwidth, like fft_axis.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

__global__ void __launch_bounds__(1024)
fft_last_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n,
                long long rows, int RB, float sign, float scale) {
  extern __shared__ float2 s[];
  const int pitch = RB + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  const int elems = n * RB;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / n;
    const int t = e % n;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + rho < rows) {
      const long long g = (row0 + rho) * n + t;
      v = make_float2(xr[g], xi[g]);
    }
    s[t * pitch + rho] = v;
  }
  __syncthreads();
  fftblock::block_fft(s, n, RB, pitch, plan, tw, sign);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / n;
    const int k = e % n;
    if (row0 + rho >= rows) continue;
    const long long g = (row0 + rho) * n + k;
    const float2 v = s[k * pitch + rho];
    yr[g] = v.x * scale;
    yi[g] = v.y * scale;
  }
}

}  // namespace

// xr, xi -> yr, yi, each (rows, n) float32.  tw: n float2, tw[m] =
// exp(sign * 2*pi*i * m / n), sign = +1 if inverse (which also scales by
// 1/n); every output is multiplied by scale as well.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fft_last_launch(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long rows,
                               int n, int inverse, float scale,
                               void* stream) {
  fftblock::RowGeometry g;
  const int bad = fftblock::row_geometry(n, rows, &g);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      fft_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sign = inverse ? 1.f : -1.f;
  const float sc = inverse ? scale / static_cast<float>(n) : scale;
  fft_last_kernel<<<g.blocks, g.threads, g.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, static_cast<const float2*>(tw), g.plan, n, rows, g.RB,
      sign, sc);
  return static_cast<int>(cudaGetLastError());
}
