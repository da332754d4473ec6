// The complex spectral layout's pointwise right-hand side, one pass a stage.
//
// Replaces no TPU kernel.  The JAX package leaves the pointwise work of
// NavierStokes3D.rhs in the complex layout (mpifft4py_tpu/models/
// navier_stokes.py: the curl i K x U, the product U x w, the Leray
// projection with the viscous term) to XLA, which fuses each stage into one
// loop.  Run eagerly, each stage was a chain of torch kernels that moved its
// fields some 33-54 times; each kernel here moves them once:
//
//   rhs_curl:       y = i K x U                     read U, write y
//   rhs_cross:      y = A x B                       read A, B, write y
//   rhs_leray_visc: y = F - K (K.F)/k^2 - nu k^2 U  read F, U, write y
//                   (k^2 = 0 taken as 1 in the divisor)
//
// U, F and y are complex64 (3, n0, n1, nf) stacks (float pairs), A, B and
// y float32 (3, plane) stacks; the wavenumbers arrive as the 1-D vectors k0
// (n0), k1 (n1) and k2 (nf), so no K array is read.
//
// Bound: bytes (48, 36 and 72 a point; a few flops a value, far below the
// ridge), so the design only has to stream at HBM speed:
// - a flat index over each component plane: a thread takes W floats of
//   every plane it reads, one 16-byte load each where the planes' bases lie
//   on the 16-byte grid (W = 4), else one 8-byte (complex) or 4-byte (real)
//   load; neighbouring threads take neighbouring chunks, so rows of nf = 257
//   complex values need no alignment of their own;
// - one chunk a thread, its 3 or 6 loads issued before any arithmetic (two
//   or four chunks a thread ran 0.3-1.3% slower);
// - a chunk's (i0, i1, i2) from one division pair, then stepped; k0, k1 and
//   k2 through the read-only cache (a few KB, resident);
// - loads through the read-only path (ld.global.nc) and plain stores: with
//   the streaming hints (ld.global.cs, st.global.cs) every kernel ran 1-3%
//   slower (H100, 512^3 and 768^3).
//
// Arithmetic: float32, each product rounded on its own (__fmul_rn and
// friends keep nvcc from contracting into FMAs) and IEEE division, in the
// order of the eager expressions (ops/fft3d.py, rhs_*_ref), so the curl and
// the product round as their twins do; the projection's quotient may differ
// from torch's complex division in its last bit.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void ld(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void ld(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void st(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st(float* p, const float (&v)[1]) {
  *p = v[0];
}

// x*y - z*w with both products rounded (as two eager multiplies and a
// subtraction)
__device__ __forceinline__ float mul_sub(float x, float y, float z, float w) {
  return __fsub_rn(__fmul_rn(x, y), __fmul_rn(z, w));
}

// (k0[i0], k1[i1], k2[i2]) of the complex values of an (n0, n1, nf) plane,
// walked along the flat index
struct Walk {
  unsigned i0, i1, i2;
  __device__ __forceinline__ Walk(unsigned e, unsigned n1, unsigned nf) {
    const unsigned r = e / nf;
    i2 = e - r * nf;
    i0 = r / n1;
    i1 = r - i0 * n1;
  }
  __device__ __forceinline__ void next(unsigned n1, unsigned nf) {
    if (++i2 == nf) {
      i2 = 0;
      if (++i1 == n1) { i1 = 0; ++i0; }
    }
  }
  __device__ __forceinline__ void k(const float* __restrict__ k0,
                                    const float* __restrict__ k1,
                                    const float* __restrict__ k2,
                                    float (&kv)[3]) const {
    kv[0] = __ldg(k0 + i0);
    kv[1] = __ldg(k1 + i1);
    kv[2] = __ldg(k2 + i2);
  }
};

// i (K x U): component c is i (K_a U_b - K_b U_a) with (a, b) = (c+1, c+2)
// cyclically, so re = -(K_a Ui_b - K_b Ui_a), im = K_a Ur_b - K_b Ur_a.
// W floats a plane a thread: W / 2 complex values.
template <int W>
__global__ void __launch_bounds__(kThreads)
rhs_curl_kernel(const float* __restrict__ u, const float* __restrict__ k0,
                const float* __restrict__ k1, const float* __restrict__ k2,
                float* __restrict__ y, unsigned n1, unsigned nf,
                unsigned plane) {
  constexpr int C = W / 2;
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= plane / C) return;
  const size_t S = 2 * static_cast<size_t>(plane);   // floats a component
  const size_t at0 = static_cast<size_t>(q) * W;
  float v[3][W];
#pragma unroll
  for (int c = 0; c < 3; ++c) ld(u + c * S + at0, v[c]);
  Walk at(q * C, n1, nf);
  float o[3][W];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j) at.next(n1, nf);
    float kv[3];
    at.k(k0, k1, k2, kv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a = (c + 1) % 3, b = (c + 2) % 3;
      o[c][2 * j] = -mul_sub(kv[a], v[b][2 * j + 1], kv[b], v[a][2 * j + 1]);
      o[c][2 * j + 1] = mul_sub(kv[a], v[b][2 * j], kv[b], v[a][2 * j]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) st(y + c * S + at0, o[c]);
}

// A x B: component c is A_a B_b - A_b B_a with (a, b) = (c+1, c+2)
template <int W>
__global__ void __launch_bounds__(kThreads)
rhs_cross_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ y, size_t plane) {
  const size_t q = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= plane / W) return;
  float va[3][W], vb[3][W];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ld(a + c * plane + q * W, va[c]);
    ld(b + c * plane + q * W, vb[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int p = (c + 1) % 3, r = (c + 2) % 3;
    float o[W];
#pragma unroll
    for (int j = 0; j < W; ++j)
      o[j] = mul_sub(va[p][j], vb[r][j], va[r][j], vb[p][j]);
    st(y + c * plane + q * W, o);
  }
}

// F - K (K.F)/k^2 - (nu k^2) U, k^2 = 0 taken as 1 in the divisor; the sums
// and differences in the eager order: ((K0 F0 + K1 F1) + K2 F2),
// (F_c - K_c d) - (nu k^2) U_c
template <int W>
__global__ void __launch_bounds__(kThreads)
rhs_leray_visc_kernel(const float* __restrict__ f, const float* __restrict__ u,
                      const float* __restrict__ k0,
                      const float* __restrict__ k1,
                      const float* __restrict__ k2, float* __restrict__ y,
                      unsigned n1, unsigned nf, unsigned plane, float nu) {
  constexpr int C = W / 2;
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= plane / C) return;
  const size_t S = 2 * static_cast<size_t>(plane);
  const size_t at0 = static_cast<size_t>(q) * W;
  float vf[3][W], vu[3][W];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ld(f + c * S + at0, vf[c]);
    ld(u + c * S + at0, vu[c]);
  }
  Walk at(q * C, n1, nf);
  float o[3][W];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j) at.next(n1, nf);
    float kv[3];
    at.k(k0, k1, k2, kv);
    const float ksq = __fadd_rn(__fadd_rn(__fmul_rn(kv[0], kv[0]),
                                          __fmul_rn(kv[1], kv[1])),
                                __fmul_rn(kv[2], kv[2]));
    const float den = ksq == 0.f ? 1.f : ksq;
    const float nk = __fmul_rn(nu, ksq);
#pragma unroll
    for (int p = 0; p < 2; ++p) {              // re, then im
      const int e = 2 * j + p;
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(kv[0], vf[0][e]),
                                            __fmul_rn(kv[1], vf[1][e])),
                                  __fmul_rn(kv[2], vf[2][e]));
      const float d = __fdiv_rn(dot, den);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        o[c][e] = __fsub_rn(__fsub_rn(vf[c][e], __fmul_rn(kv[c], d)),
                            __fmul_rn(nk, vu[c][e]));
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) st(y + c * S + at0, o[c]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned blocks_for(long long chunks) {
  return static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
}

// the complex stacks' plane, or -1 where the kernels' unsigned indices do
// not reach it
long long complex_plane(int n0, int n1, int nf) {
  if (n0 < 1 || n1 < 1 || nf < 1) return -1;
  const long long plane = static_cast<long long>(n0) * n1 * nf;
  return plane > INT_MAX ? -1 : plane;
}

}  // namespace

// u, y: complex64 (3, n0, n1, nf) as float pairs; k0, k1, k2: float32 (n0),
// (n1), (nf).  y = i K x u.  Returns cudaGetLastError().
extern "C" int rhs_curl_launch(const float* u, const float* k0,
                               const float* k1, const float* k2, float* y,
                               int n0, int n1, int nf, void* stream) {
  const long long plane = complex_plane(n0, n1, nf);
  if (plane < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto strm = static_cast<cudaStream_t>(stream);
  if (plane % 2 == 0 && aligned16(u) && aligned16(y))
    rhs_curl_kernel<4><<<blocks_for(plane / 2), kThreads, 0, strm>>>(
        u, k0, k1, k2, y, n1, nf, static_cast<unsigned>(plane));
  else
    rhs_curl_kernel<2><<<blocks_for(plane), kThreads, 0, strm>>>(
        u, k0, k1, k2, y, n1, nf, static_cast<unsigned>(plane));
  return static_cast<int>(cudaGetLastError());
}

// a, b, y: float32 (3, plane).  y = a x b.  Returns cudaGetLastError().
extern "C" int rhs_cross_launch(const float* a, const float* b, float* y,
                                long long plane, void* stream) {
  if (plane < 1 || plane / kThreads >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto strm = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(plane);
  if (plane % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(y))
    rhs_cross_kernel<4><<<blocks_for(plane / 4), kThreads, 0, strm>>>(a, b, y,
                                                                     n);
  else
    rhs_cross_kernel<1><<<blocks_for(plane), kThreads, 0, strm>>>(a, b, y, n);
  return static_cast<int>(cudaGetLastError());
}

// f, u, y: complex64 (3, n0, n1, nf) as float pairs; k0, k1, k2 as for
// rhs_curl_launch.  y = f - K (K.f)/k^2 - nu k^2 u.  Returns
// cudaGetLastError().
extern "C" int rhs_leray_visc_launch(const float* f, const float* u,
                                     const float* k0, const float* k1,
                                     const float* k2, float* y, int n0,
                                     int n1, int nf, float nu, void* stream) {
  const long long plane = complex_plane(n0, n1, nf);
  if (plane < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto strm = static_cast<cudaStream_t>(stream);
  if (plane % 2 == 0 && aligned16(f) && aligned16(u) && aligned16(y))
    rhs_leray_visc_kernel<4><<<blocks_for(plane / 2), kThreads, 0, strm>>>(
        f, u, k0, k1, k2, y, n1, nf, static_cast<unsigned>(plane), nu);
  else
    rhs_leray_visc_kernel<2><<<blocks_for(plane), kThreads, 0, strm>>>(
        f, u, k0, k1, k2, y, n1, nf, static_cast<unsigned>(plane), nu);
  return static_cast<int>(cudaGetLastError());
}
