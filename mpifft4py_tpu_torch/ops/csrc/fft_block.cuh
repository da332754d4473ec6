// Shared-memory Stockham FFT over the columns of one thread block's tile.
//
// A tile holds `ncol` independent complex sequences of length n, element
// (index i, column c) at s[i * pitch + c] (pitch >= ncol; a pitch one larger
// than the column count keeps strided accesses off a single bank).  Each
// stage reads every element into registers, synchronises, and writes the
// butterfly outputs back in Stockham order, so one buffer of n * pitch
// float2 serves all stages and the result leaves in natural order.
//
// n = 2^a * 3^b with b <= 1: one radix-2 stage when a is odd, radix-4 for
// the rest of the power of two, one radix-3 stage for the factor 3.
// Twiddles come from a float32 table tw[m] = exp(sign * 2*pi*i * m / n)
// that the host computes in float64.  FP32 throughout; no fast-math
// intrinsics (the round trip must stay below 1e-6 relative).
#pragma once

#include <cuda_runtime.h>

namespace fftblock {

// Elements each thread holds in registers per stage: the launcher sizes the
// block so that blockDim.x * kEPT >= n * ncol.
constexpr int kEPT = 16;
constexpr int kMaxStages = 12;

struct Plan {
  int nst;
  int radix[kMaxStages];
};

// Host and device: the radix sequence for n, or nst = 0 outside the envelope.
__host__ __device__ inline Plan make_plan(int n) {
  Plan p;
  p.nst = 0;
  int m = n;
  bool three = false;
  if (m % 3 == 0) {
    three = true;
    m /= 3;
  }
  int a = 0;
  while ((1 << a) < m) ++a;
  if (m < 1 || (1 << a) != m || m % 3 == 0) return p;
  if (a % 2) p.radix[p.nst++] = 2;
  for (int i = 0; i < a / 2; ++i) p.radix[p.nst++] = 4;
  if (three) p.radix[p.nst++] = 3;
  return p;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// R-point DFT in place, y_q = sum_t v_t exp(sign * 2*pi*i * t*q / R).
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R], float sign);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2], float) {
  float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4], float sign) {
  float2 t0 = cadd(v[0], v[2]);
  float2 t1 = csub(v[0], v[2]);
  float2 t2 = cadd(v[1], v[3]);
  float2 d = csub(v[1], v[3]);
  float2 t3 = make_float2(-sign * d.y, sign * d.x);  // d * (sign * i)
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<3>(float2 (&v)[3], float sign) {
  const float h = 0.866025403784438647f;  // sqrt(3) / 2
  float2 s = cadd(v[1], v[2]);
  float2 d = csub(v[1], v[2]);
  float2 m = make_float2(v[0].x - 0.5f * s.x, v[0].y - 0.5f * s.y);
  float2 r = make_float2(-sign * h * d.y, sign * h * d.x);  // i*sign*h*d
  v[0] = cadd(v[0], s);
  v[1] = cadd(m, r);
  v[2] = csub(m, r);
}

template <int R>
__device__ __forceinline__ void stage(float2* s, int n, int ncol, int pitch,
                                      int Ns, const float2* __restrict__ tw,
                                      float sign) {
  constexpr int kMaxB = (kEPT + R - 1) / R;
  const int stride = n / R;
  const int nb = stride * ncol;
  const int twstep = n / (Ns * R);
  float2 v[kMaxB][R];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    if (b < nb) {
      const int c = b % ncol;
      const int j = b / ncol;
      const int k = j % Ns;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        float2 x = s[(j + t * stride) * pitch + c];
        if (t > 0 && k > 0) x = cmul(x, __ldg(&tw[t * k * twstep]));
        v[i][t] = x;
      }
      dft<R>(v[i], sign);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    if (b < nb) {
      const int c = b % ncol;
      const int j = b / ncol;
      const int k = j % Ns;
      const int d = (j / Ns) * Ns * R + k;
#pragma unroll
      for (int t = 0; t < R; ++t) s[(d + t * Ns) * pitch + c] = v[i][t];
    }
  }
  __syncthreads();
}

// Transforms every column of the tile; the caller has filled s and
// synchronised.  Returns after a barrier, with the spectrum in s.
__device__ inline void block_fft(float2* s, int n, int ncol, int pitch,
                                 const Plan& plan,
                                 const float2* __restrict__ tw, float sign) {
  int Ns = 1;
  for (int st = 0; st < plan.nst; ++st) {
    const int R = plan.radix[st];
    if (R == 4) {
      stage<4>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 2) {
      stage<2>(s, n, ncol, pitch, Ns, tw, sign);
    } else {
      stage<3>(s, n, ncol, pitch, Ns, tw, sign);
    }
    Ns *= R;
  }
}

// Threads for a tile of `elems` complex values: a whole number of warps.
inline int threads_for(int elems) {
  int t = (elems + kEPT - 1) / kEPT;
  return ((t + 31) / 32) * 32;
}

constexpr int kTile = 4096;  // complex values per component per row block

// Launch geometry of a row kernel: one m-point FFT on each of `rows`
// contiguous rows, `comps` components side by side.  RB rows a block
// (m * RB <= kTile), a tile of m x (comps * RB + 1) float2 (an odd pitch
// where comps * RB is even spreads the strided accesses over the banks).
struct RowGeometry {
  Plan plan;
  int RB;
  unsigned blocks;
  size_t smem;
  int threads;
};

// Returns 0 and fills `g`, or cudaErrorInvalidValue outside the envelope.
inline int row_geometry(int m, long long rows, RowGeometry* g,
                        int comps = 1) {
  g->plan = make_plan(m);
  if (g->plan.nst == 0 || m > 1024 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g->RB = kTile / m > 1 ? kTile / m : 1;
  const long long b = (rows + g->RB - 1) / g->RB;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  g->blocks = static_cast<unsigned>(b);
  g->smem = static_cast<size_t>(m) * (comps * g->RB + 1) * sizeof(float2);
  g->threads = threads_for(m * comps * g->RB);
  return 0;
}

// Columns per component for a block that transforms three components side
// by side (a tile of n rows x 3T columns): the largest T of 16, 8, 4, 2, 1
// that keeps the tile within one 1024-thread block.  T = 16 up to n = 256
// (96 KB of shared memory), 8 up to 512, 4 up to 1024.
inline int stack3_cols(int n) {
  int T = 16;
  while (T > 1 && n * 3 * T > 1024 * kEPT) T /= 2;
  return T;
}

}  // namespace fftblock
