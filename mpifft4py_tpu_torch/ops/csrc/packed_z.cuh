// The half-length r2c along the last axis: the untangle step and the launch
// geometry of the row kernels built on it.
//
// A real row x of length n = 2h is transformed as one h-point complex FFT
// of z_t = x[2t] + i*x[2t+1]; the untangle turns its spectrum Z into the
// packed X (h columns, column 0 holding X[0] + i*X[n/2]):
//   X[k] = (Z[k] + conj Z[h-k])/2 + e^{-2 pi i k/n} (Z[k] - conj Z[h-k])/(2i).
// Shared by planar_rfft.cu (the r2c of every layout: planar, complex64 and
// packed, rows 8, 21, 4 and 17, by a paired form of the untangle, and the
// c2r of the 3/2 rule), packed_rfft.cu (the packed c2r) and cross_rfft_z.cu
// (the cross product with the r2c behind it).
#pragma once

#include <cuda_runtime.h>

#include "fft_block.cuh"

namespace packedz {

// X[k] from the spectrum Z held in shared memory at s[j * pitch + col]
// (j = 0..h-1); tw_n[k] = exp(-2 pi i k / n).
__device__ __forceinline__ float2 untangle(const float2* s, int pitch,
                                           int col, int k, int h,
                                           const float2* __restrict__ tw_n) {
  const float2 Z = s[k * pitch + col];
  if (k == 0) return make_float2(Z.x + Z.y, Z.x - Z.y);  // X[0], X[n/2]
  const float2 Zf = s[(h - k) * pitch + col];
  const float Er = 0.5f * (Z.x + Zf.x);
  const float Ei = 0.5f * (Z.y - Zf.y);
  const float Or = 0.5f * (Z.y + Zf.y);
  const float Oi = 0.5f * (Zf.x - Z.x);
  const float2 w = tw_n[k];
  return make_float2(Er + (w.x * Or - w.y * Oi), Ei + (w.x * Oi + w.y * Or));
}

// The DIF lane order of the reference's pallas_zdif.py (n = r*128, r in
// {4, 6, 8}, h = n/2 = 64 r): k = r*t + b (t < 64) sits at lane off[b] + t,
// slot p = lane / 128 holding the 64-lane pieces [b = p | b = r - p] and
// slot 0 holding [0 | r/2].  zdif_lane(k, n) is the lane of column k, a
// closed form, no table (mirrored by mpifft4py_tpu_torch/ops/zdif.py
// zdif_lane, whose inverse is zdif_k there).
__host__ __device__ inline bool zdif_ok(int n) {
  return n % 256 == 0 && n / 128 >= 4 && n / 128 <= 8;
}

__device__ __forceinline__ int zdif_lane(int k, int n) {
  const int r = n / 128;
  const int b = k % r;
  const int t = k / r;
  const int off = b == r / 2 ? 64 : 128 * min(b, r - b) + (b > r / 2 ? 64 : 0);
  return off + t;
}

// The row geometry of the h-point FFT of real rows of length n = 2h (any
// even n <= 2048: fft_block.cuh plans every h <= 1024).
inline int half_geometry(int n, long long rows, fftblock::RowGeometry* g,
                         int comps = 1) {
  if (n % 2) return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::row_geometry(n / 2, rows, g, comps);
}

}  // namespace packedz
