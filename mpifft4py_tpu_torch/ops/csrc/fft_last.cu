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
// The template parameter kC64 picks the global layout, as in fft_axis.cu:
// true reads and writes interleaved complex64 rows, for the dense tier's
// mpifft4py_tpu/ops/pallas_fft.py: _fft_last_pallas (_cfft_last_kernel),
// row 20, fft_axis's post == 1 branch, which multiplies each row by a
// dense n x n DFT matrix pair.
//
// It moves 16 bytes a point through HBM (5 n log2 n flops a transform, 2.5
// flops a byte at n = 256), so it is bound by HBM bandwidth, like fft_axis.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

template <bool kC64, bool kMixed>
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
      v = kC64 ? reinterpret_cast<const float2*>(xr)[g]
               : make_float2(xr[g], xi[g]);
    }
    s[t * pitch + rho] = v;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n, RB, pitch, plan, tw, sign);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int rho = e / n;
    const int k = e % n;
    if (row0 + rho >= rows) continue;
    const long long g = (row0 + rho) * n + k;
    const float2 v = s[k * pitch + rho];
    if (kC64) {
      reinterpret_cast<float2*>(yr)[g] = make_float2(v.x * scale, v.y * scale);
    } else {
      yr[g] = v.x * scale;
      yi[g] = v.y * scale;
    }
  }
}

// One launch; for kC64, xr and yr are the interleaved arrays and xi, yi
// are unused.
template <bool kC64>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const void* tw, long long rows, int n, int inverse, float scale,
           void* stream) {
  fftblock::RowGeometry g;
  const int bad = fftblock::row_geometry(n, rows, &g);
  if (bad) return bad;
  return fftblock::launch_kernel(
      fftblock::mixed_plan(g.plan) ? fft_last_kernel<kC64, true>
                                   : fft_last_kernel<kC64, false>,
      g.blocks, g.threads, g.smem, static_cast<cudaStream_t>(stream), xr, xi,
      yr, yi, static_cast<const float2*>(tw), g.plan, n, rows, g.RB,
      inverse ? 1.f : -1.f,
      inverse ? scale / static_cast<float>(n) : scale);
}

}  // namespace

// xr, xi -> yr, yi, each (rows, n) float32, any 2 <= n <= 1024.  tw: n
// float2, tw[m] = exp(sign * 2*pi*i * m / n), sign = +1 if inverse (which
// also scales by 1/n); every output is multiplied by scale as well.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fft_last_launch(const float* xr, const float* xi, float* yr,
                               float* yi, const void* tw, long long rows,
                               int n, int inverse, float scale,
                               void* stream) {
  return launch<false>(xr, xi, yr, yi, tw, rows, n, inverse, scale, stream);
}

// Row 20: x -> y, each interleaved complex64 (rows, n); tw as above.
extern "C" int fft_last_c64_launch(const void* x, void* y, const void* tw,
                                   long long rows, int n, int inverse,
                                   void* stream) {
  return launch<true>(static_cast<const float*>(x), nullptr,
                      static_cast<float*>(y), nullptr, tw, rows, n, inverse,
                      1.f, stream);
}
