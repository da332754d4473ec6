// c2c FFT along the middle axis of a planar (re, im) float32 pair viewed as
// (pre, n, post).
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_axis_planar (_factored_fft_kernel), which runs the DFT as factored
// MXU matmuls.  On the H100 an FFT of n <= 1024 points does 5 n log2 n
// flops on 16 bytes per point moved through device memory, about
// 3 flops per byte at n = 256: the kernel is bound by HBM bandwidth, not by
// the 67 TFLOP/s of FP32 on CUDA cores.  So it is written to move each
// element through HBM once in and once out, in full 32-byte sectors:
//
// - a block takes T consecutive `post` columns across all n rows, so the
//   threads of a warp read and write neighbouring addresses of one row;
// - the whole transform of those T columns runs in shared memory
//   (n * T * 8 bytes, at most 128 KB: T = 32 for n <= 512, 16 above);
// - the inverse folds the 1/n scale into the store.
//
// The template parameter kC64 picks the global layout: false, the planar
// pair above; true, interleaved complex64 (x and y each one array of
// float2), for the dense tier's mpifft4py_tpu/ops/pallas_fft.py: fft_axis
// (_fft_axis_pallas, _cfft_kernel), row 19, which takes complex64 and runs
// the c2c DFT along a non-last axis of (pre, n, post) as one dense n x n
// matmul pair.  Only the loads and stores differ; the transform, the tiles
// and the bound (HBM bytes) are the planar kernel's.
//
// A later version can widen the x stage's tiles with a thread-block
// cluster and distributed shared memory, or fuse the y stage with the
// packed z transform (one pass per direction, as the TPU's fused_zy
// kernels do): a 256^3 slab's packed pair is 256 KB, above one block's
// 227 KB, so that needs a cluster.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

template <bool kC64, bool kMixed>
__global__ void __launch_bounds__(1024)
fft_axis_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n,
                long long post, int T, long long tiles, float sign,
                float scale) {
  extern __shared__ float2 s[];
  const long long p = blockIdx.x / tiles;
  const long long q0 = (blockIdx.x % tiles) * T;
  const long long base = p * n * post + q0;
  const int elems = n * T;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int c = e % T;
    float2 v = make_float2(0.f, 0.f);
    if (q0 + c < post) {
      const long long g = base + r * post + c;
      v = kC64 ? reinterpret_cast<const float2*>(xr)[g]
               : make_float2(xr[g], xi[g]);
    }
    s[r * T + c] = v;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n, T, T, plan, tw, sign);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int c = e % T;
    if (q0 + c < post) {
      const long long g = base + r * post + c;
      const float2 v = s[r * T + c];
      if (kC64) {
        reinterpret_cast<float2*>(yr)[g] =
            make_float2(v.x * scale, v.y * scale);
      } else {
        yr[g] = v.x * scale;
        yi[g] = v.y * scale;
      }
    }
  }
}

// One launch; for kC64, xr and yr are the interleaved arrays and xi, yi
// are unused.
template <bool kC64>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const void* tw, long long pre, int n, long long post, int inverse,
           void* stream) {
  const Plan plan = fftblock::make_plan(n);
  if (plan.nst == 0 || pre < 1 || post < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = n <= 512 ? 32 : 16;
  const long long tiles = (post + T - 1) / T;
  const long long blocks = pre * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::launch_kernel(
      fftblock::mixed_plan(plan) ? fft_axis_kernel<kC64, true>
                                 : fft_axis_kernel<kC64, false>,
      static_cast<unsigned>(blocks), fftblock::threads_for(n * T),
      static_cast<size_t>(n) * T * sizeof(float2),
      static_cast<cudaStream_t>(stream), xr, xi, yr, yi,
      static_cast<const float2*>(tw), plan, n, post, T, tiles,
      inverse ? 1.f : -1.f, inverse ? 1.f / static_cast<float>(n) : 1.f);
}

}  // namespace

// tw: n float2, tw[m] = exp(sign * 2*pi*i * m / n), sign = +1 if inverse.
// Any 2 <= n <= 1024.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fft_axis_launch(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long pre,
                               int n, long long post, int inverse,
                               void* stream) {
  return launch<false>(xr, xi, yr, yi, tw, pre, n, post, inverse, stream);
}

// Row 19: x -> y, each interleaved complex64 (pre, n, post); tw as above.
extern "C" int fft_axis_c64_launch(const void* x, void* y, const void* tw,
                                   long long pre, int n, long long post,
                                   int inverse, void* stream) {
  return launch<true>(static_cast<const float*>(x), nullptr,
                      static_cast<float*>(y), nullptr, tw, pre, n, post,
                      inverse, stream);
}
