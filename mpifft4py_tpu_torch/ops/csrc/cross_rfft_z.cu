// Cross product of two physical 3-stacks with the packed z r2c behind it.
//
// Replaces the z stage of the Pallas kernels mpifft4py_tpu/ops/
// pallas_fft3d.py: cross_rfft_zy_packed (_cross_zy_kernel, the one-shot
// kernel for 256-class planes) and _cross_rfft_zy_acc (_cross_zy_acc_kernel,
// the same function tiled along z because a 512-class plane overflows the
// TPU's 16 MB of VMEM).  Both form F = A x B in VMEM and contract it with
// dense DFT matrices, so F never lands in device memory.  The y c2c that
// those kernels also run is a separate fft_axis launch here: a 256^3 packed
// y-plane pair is 256 KB, above one block's 227 KB of shared memory.
//
// The transform is packed_rfft.cu's (an h-point FFT of x[2t] + i*x[2t+1]
// and the untangle of packed_z.cuh), with a different load: a block takes
// RB rows (RB * h = 4096) of all three output components, reads the rows of
// A and B it needs with coalesced 8-byte loads (each input row is read by
// two components; the second read hits the cache), forms the cross product
// as it stores the tile, and transforms the 3 * RB columns together.  It
// works row by row with no whole-plane working set, so it serves the
// 512-class planes of row 13 unchanged (96 KB of shared memory either way).
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

__global__ void __launch_bounds__(1024)
cross_rfft_z_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float2* __restrict__ tw_h,
                    const float2* __restrict__ tw_n, Plan plan, int n,
                    long long rows, int RB) {
  extern __shared__ float2 s[];
  const int h = n / 2;
  const int ncol = 3 * RB;        // column c * RB + rho: component c, row rho
  const int pitch = ncol + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  const long long comp = rows * n;
  const int elems = h * ncol;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int col = e / h;
    const int t = e % h;
    const int c = col / RB;
    const long long row = row0 + col % RB;
    float2 v = make_float2(0.f, 0.f);
    if (row < rows) {
      // F_c = A_{c+1} B_{c+2} - A_{c+2} B_{c+1}, two samples at a time
      const long long g = row * n;
      const long long o1 = ((c + 1) % 3) * comp + g;
      const long long o2 = ((c + 2) % 3) * comp + g;
      const float2 a1 = reinterpret_cast<const float2*>(a + o1)[t];
      const float2 a2 = reinterpret_cast<const float2*>(a + o2)[t];
      const float2 b1 = reinterpret_cast<const float2*>(b + o1)[t];
      const float2 b2 = reinterpret_cast<const float2*>(b + o2)[t];
      v = make_float2(a1.x * b2.x - a2.x * b1.x, a1.y * b2.y - a2.y * b1.y);
    }
    s[t * pitch + col] = v;
  }
  __syncthreads();
  fftblock::block_fft(s, h, ncol, pitch, plan, tw_h, -1.f);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int col = e / h;
    const int k = e % h;
    const long long row = row0 + col % RB;
    if (row >= rows) continue;
    const float2 X = packedz::untangle(s, pitch, col, k, h, tw_n);
    const long long g = (col / RB) * rows * h + row * h + k;
    yr[g] = X.x;
    yi[g] = X.y;
  }
}

}  // namespace

// a, b: (3, rows, n) real; yr, yi: (3, rows, n/2) packed, z transformed.
// tw_h: n/2 float2 of exp(-2 pi i m/(n/2)); tw_n: n/2 float2 of
// exp(-2 pi i k/n).  Returns cudaGetLastError() after the launch.
extern "C" int cross_rfft_z_launch(const float* a, const float* b, float* yr,
                                   float* yi, const void* tw_h,
                                   const void* tw_n, long long rows, int n,
                                   void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g, 3);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      cross_rfft_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_rfft_z_kernel<<<g.blocks, g.threads, g.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b, yr, yi, static_cast<const float2*>(tw_h),
      static_cast<const float2*>(tw_n), g.plan, n, rows, g.RB);
  return static_cast<int>(cudaGetLastError());
}
