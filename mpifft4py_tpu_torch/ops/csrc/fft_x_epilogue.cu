// x-axis forward FFT of a packed 3-stack with a spectral right-hand side's
// epilogue, in one pass.
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_x_epilogue_packed (_fft_x_epilogue_kernel), which runs the x forward
// as factored MXU matmuls and applies, in VMEM, in this order
// (pallas_fft3d.py:1845-1894):
//   1. the 2/3-rule mask M0(k0) M1(k1) M2(k2);
//   2. with the buoyancy rider (Boussinesq, mode "project" only),
//      F_2 += Ri * theta, theta the unmasked state's scalar;
//   3. the mode (the template's MODE), with S the unmasked state:
//      project: F - K (K.F)/k^2 - visc k^2 S (k^2 = 0 taken as 1);
//      curl:    i K x F - visc k^2 S                      (VV, MHD induction);
//      div:     -i K.F - visc k^2 S, S and the output one component
//               (the Boussinesq scalar).
// So the pre-epilogue spectrum never lands in device memory.
//
// Layout as curl_ifft_x.cu: the pair is (3, n, Q) with Q = N1 * h columns,
// the wavenumbers and masks are 1-D float32 vectors.  The kernel is bound
// by HBM bandwidth (it moves 4 pairs of 3 planes for ~15 n log2 n flops per
// column): a block takes T columns of all three components across all n
// rows (T from fftblock::stack3_cols, 96 KB of shared memory at n = 256),
// transforms the three together with one block_fft, and each thread then
// finishes whole (row, column) points across the three components, since
// every mode mixes them.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

enum Mode { kProject = 0, kCurl = 1, kDiv = 2 };

template <int MODE, bool BUOY>
__global__ void __launch_bounds__(1024)
fft_x_epilogue_kernel(const float* __restrict__ fr,
                      const float* __restrict__ fi,
                      const float* __restrict__ sr,
                      const float* __restrict__ si,
                      const float* __restrict__ tr,
                      const float* __restrict__ ti,
                      const float* __restrict__ k0,
                      const float* __restrict__ k1,
                      const float* __restrict__ k2,
                      const float* __restrict__ m0,
                      const float* __restrict__ m1,
                      const float* __restrict__ m2, float* __restrict__ yr,
                      float* __restrict__ yi, const float2* __restrict__ tw,
                      Plan plan, int n, int h, int Q, int T, float visc,
                      float ri) {
  extern __shared__ float2 s[];
  const int ncol = 3 * T;         // column c * T + t: component c, column t
  const int q0 = blockIdx.x * T;
  const long long plane = static_cast<long long>(n) * Q;
  const int elems = n * ncol;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / ncol;
    const int col = e % ncol;
    const int q = q0 + col % T;
    float2 v = make_float2(0.f, 0.f);
    if (q < Q) {
      const long long g =
          (col / T) * plane + static_cast<long long>(r) * Q + q;
      v = make_float2(fr[g], fi[g]);
    }
    s[r * ncol + col] = v;
  }
  __syncthreads();
  fftblock::block_fft(s, n, ncol, ncol, plan, tw, -1.f);
  for (int e = threadIdx.x; e < n * T; e += blockDim.x) {
    const int r = e / T;
    const int t = e % T;
    const int q = q0 + t;
    if (q >= Q) continue;
    const int j1 = q / h;
    const int j2 = q % h;
    const float K[3] = {k0[r], k1[j1], k2[j2]};
    const float mask = m0[r] * (m1[j1] * m2[j2]);
    const long long g = static_cast<long long>(r) * Q + q;
    float2 F[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 v = s[r * ncol + c * T + t];
      F[c] = make_float2(v.x * mask, v.y * mask);
    }
    if (BUOY) {
      F[2].x += ri * tr[g];
      F[2].y += ri * ti[g];
    }
    const float ksq = K[0] * K[0] + K[1] * K[1] + K[2] * K[2];
    const float nk = visc * ksq;
    if (MODE == kProject) {
      const float inv = 1.f / (ksq == 0.f ? 1.f : ksq);
      const float dr = (K[0] * F[0].x + K[1] * F[1].x + K[2] * F[2].x) * inv;
      const float di = (K[0] * F[0].y + K[1] * F[1].y + K[2] * F[2].y) * inv;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long gc = c * plane + g;
        yr[gc] = F[c].x - K[c] * dr - nk * sr[gc];
        yi[gc] = F[c].y - K[c] * di - nk * si[gc];
      }
    } else if (MODE == kCurl) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3;
        const int c2 = (c + 2) % 3;
        const long long gc = c * plane + g;
        yr[gc] = -(K[c1] * F[c2].y - K[c2] * F[c1].y) - nk * sr[gc];
        yi[gc] = (K[c1] * F[c2].x - K[c2] * F[c1].x) - nk * si[gc];
      }
    } else {
      yr[g] = (K[0] * F[0].y + K[1] * F[1].y + K[2] * F[2].y) - nk * sr[g];
      yi[g] = -(K[0] * F[0].x + K[1] * F[1].x + K[2] * F[2].x) - nk * si[g];
    }
  }
}

struct Args {
  const float *fr, *fi, *sr, *si, *tr, *ti, *k0, *k1, *k2, *m0, *m1, *m2;
  float *yr, *yi;
  const float2* tw;
};

template <int MODE, bool BUOY>
int launch(const Args& a, const Plan& plan, int n, int h, int Q, int T,
           float visc, float ri, cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(Q) + T - 1) / T;
  const size_t smem = static_cast<size_t>(n) * 3 * T * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fft_x_epilogue_kernel<MODE, BUOY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = fftblock::threads_for(n * 3 * T);
  fft_x_epilogue_kernel<MODE, BUOY>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          a.fr, a.fi, a.sr, a.si, a.tr, a.ti, a.k0, a.k1, a.k2, a.m0, a.m1,
          a.m2, a.yr, a.yi, a.tw, plan, n, h, Q, T, visc, ri);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fr, fi: (3, n, n1 * h) pair after the z and y forwards; sr, si: the state
// pair, (3, n, n1 * h), or (1, n, n1 * h) for mode 2; tr, ti: the
// buoyancy rider's scalar pair (1, n, n1 * h), or null for none (mode 0
// only); k0, m0 (n), k1, m1 (n1), k2, m2 (h) float32, the masks 0/1; yr, yi:
// shaped as sr.  tw: n float2 of exp(-2 pi i m / n).  mode: 0 project,
// 1 curl, 2 div.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fft_x_epilogue_launch(const float* fr, const float* fi,
                                     const float* sr, const float* si,
                                     const float* tr, const float* ti,
                                     const float* k0, const float* k1,
                                     const float* k2, const float* m0,
                                     const float* m1, const float* m2,
                                     float* yr, float* yi, const void* tw,
                                     int n, int n1, int h, float visc,
                                     int mode, float ri, void* stream) {
  const Plan plan = fftblock::make_plan(n);
  const long long Q = static_cast<long long>(n1) * h;
  const bool buoy = tr != nullptr;
  if (plan.nst == 0 || n > 1024 || n1 < 1 || h < 1 || Q > 0x7fffffffLL ||
      buoy != (ti != nullptr) || (buoy && mode != kProject))
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = fftblock::stack3_cols(n);
  const Args a{fr, fi, sr, si, tr, ti, k0, k1, k2, m0, m1, m2, yr, yi,
               static_cast<const float2*>(tw)};
  const int q = static_cast<int>(Q);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kProject:
      return buoy ? launch<kProject, true>(a, plan, n, h, q, T, visc, ri, st)
                  : launch<kProject, false>(a, plan, n, h, q, T, visc, ri, st);
    case kCurl:
      return launch<kCurl, false>(a, plan, n, h, q, T, visc, ri, st);
    case kDiv:
      return launch<kDiv, false>(a, plan, n, h, q, T, visc, ri, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
