// A product of physical stacks with the packed z r2c behind it.
//
// Replaces the z stage of the Pallas kernels mpifft4py_tpu/ops/
// pallas_fft3d.py: cross_rfft_zy_packed (_cross_zy_kernel, the one-shot
// kernel for 256-class planes), _cross_rfft_zy_acc (_cross_zy_acc_kernel,
// the same function tiled along z because a 512-class plane overflows the
// TPU's 16 MB of VMEM) and mul_rfft_zy_packed (_mul_zy_kernel).  They form
// the product F in VMEM and contract it with dense DFT matrices, so F never
// lands in device memory.  The product is one of (the template's OP):
//   cross:  F_m = A_{m+1} B_{m+2} - A_{m+2} B_{m+1}              (A x B)
//   cross2: the same plus C_{m+1} D_{m+2} - C_{m+2} D_{m+1}      (MHD)
//   mul:    F_m = A_m t, with t a scalar field (1, rows, n)     (Boussinesq)
// The y c2c that those kernels also run is a separate fft_axis launch here:
// a 256^3 packed y-plane pair is 256 KB, above one block's 227 KB of shared
// memory.
//
// The transform is packed_rfft.cu's (an h-point FFT of x[2t] + i*x[2t+1]
// and the untangle of packed_z.cuh), with a different load: a block takes
// RB rows (RB * h = 4096) of all three output components, reads the rows of
// the inputs it needs with coalesced 8-byte loads (each input row of a
// cross is read by two components, t by all three; the repeats hit the
// cache), forms the product as it stores the tile, and transforms the
// 3 * RB columns together.  It is bound by HBM bandwidth: cross2 reads
// twice cross's bytes for the same transform.  It works row by row with no
// whole-plane working set, so it serves the 512-class planes of row 13
// unchanged (96 KB of shared memory either way).
#include <cuda_runtime.h>

#include "fft_block.cuh"
#include "packed_z.cuh"

using fftblock::Plan;

namespace {

enum Op { kCross = 0, kCross2 = 1, kMul = 2 };

// Two samples of (P_{m+1} Q_{m+2} - P_{m+2} Q_{m+1}) at rows o1, o2.
__device__ __forceinline__ float2 cross_pair(const float* __restrict__ p,
                                             const float* __restrict__ q,
                                             long long o1, long long o2,
                                             int t) {
  const float2 p1 = reinterpret_cast<const float2*>(p + o1)[t];
  const float2 p2 = reinterpret_cast<const float2*>(p + o2)[t];
  const float2 q1 = reinterpret_cast<const float2*>(q + o1)[t];
  const float2 q2 = reinterpret_cast<const float2*>(q + o2)[t];
  return make_float2(p1.x * q2.x - p2.x * q1.x, p1.y * q2.y - p2.y * q1.y);
}

template <int OP>
__global__ void __launch_bounds__(1024)
product_rfft_z_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ d, float* __restrict__ yr,
                      float* __restrict__ yi,
                      const float2* __restrict__ tw_h,
                      const float2* __restrict__ tw_n, Plan plan, int n,
                      long long rows, int RB) {
  extern __shared__ float2 s[];
  const int h = n / 2;
  const int ncol = 3 * RB;        // column m * RB + rho: component m, row rho
  const int pitch = ncol + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * RB;
  const long long comp = rows * n;
  const int elems = h * ncol;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int col = e / h;
    const int t = e % h;
    const int m = col / RB;
    const long long row = row0 + col % RB;
    float2 v = make_float2(0.f, 0.f);
    if (row < rows) {
      const long long g = row * n;  // two samples at a time
      if (OP == kMul) {
        const float2 am = reinterpret_cast<const float2*>(a + m * comp + g)[t];
        const float2 tt = reinterpret_cast<const float2*>(b + g)[t];
        v = make_float2(am.x * tt.x, am.y * tt.y);
      } else {
        const long long o1 = ((m + 1) % 3) * comp + g;
        const long long o2 = ((m + 2) % 3) * comp + g;
        v = cross_pair(a, b, o1, o2, t);
        if (OP == kCross2) {
          const float2 w = cross_pair(c, d, o1, o2, t);
          v = make_float2(v.x + w.x, v.y + w.y);
        }
      }
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

template <int OP>
int launch(const float* a, const float* b, const float* c, const float* d,
           float* yr, float* yi, const void* tw_h, const void* tw_n,
           long long rows, int n, const fftblock::RowGeometry& g,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      product_rfft_z_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  product_rfft_z_kernel<OP><<<g.blocks, g.threads, g.smem, stream>>>(
      a, b, c, d, yr, yi, static_cast<const float2*>(tw_h),
      static_cast<const float2*>(tw_n), g.plan, n, rows, g.RB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op 0 (cross): a, b (3, rows, n) real; c, d unused.  op 1 (cross2): a, b,
// c, d (3, rows, n).  op 2 (mul): a (3, rows, n), b = t (1, rows, n); c, d
// unused.  yr, yi: (3, rows, n/2) packed, z transformed.  tw_h: n/2 float2
// of exp(-2 pi i m/(n/2)); tw_n: n/2 float2 of exp(-2 pi i k/n).  Returns
// cudaGetLastError() after the launch.
extern "C" int cross_rfft_z_launch(const float* a, const float* b,
                                   const float* c, const float* d, float* yr,
                                   float* yi, const void* tw_h,
                                   const void* tw_n, long long rows, int n,
                                   int op, void* stream) {
  fftblock::RowGeometry g;
  const int bad = packedz::half_geometry(n, rows, &g, 3);
  if (bad) return bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kCross:
      return launch<kCross>(a, b, c, d, yr, yi, tw_h, tw_n, rows, n, g, st);
    case kCross2:
      if (c == nullptr || d == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<kCross2>(a, b, c, d, yr, yi, tw_h, tw_n, rows, n, g, st);
    case kMul:
      return launch<kMul>(a, b, c, d, yr, yi, tw_h, tw_n, rows, n, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
