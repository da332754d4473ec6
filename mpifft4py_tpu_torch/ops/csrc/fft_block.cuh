// Shared-memory Stockham FFT over the columns of one thread block's tile.
//
// A tile holds `ncol` independent complex sequences of length n, element
// (index i, column c) at s[i * pitch + c] (pitch >= ncol; a pitch one larger
// than the column count keeps strided accesses off a single bank).  Each
// stage reads what it needs into registers, synchronises, and writes its
// outputs back in Stockham order, so one buffer of n * pitch float2 serves
// all stages and the result leaves in natural order.
//
// Any 2 <= n <= kMaxN (1024) has a plan (mixed radix):
// - register stages: one radix-2 stage when the power of two is odd,
//   radix 4 for the rest of it, then radix 3, 5 and 7 for each such
//   factor; a thread holds its butterflies' inputs in registers;
// - a direct stage for each remaining prime factor p (11..1021): each
//   thread computes up to kEPT of the stage's outputs, each a p-term sum
//   over the tile, in registers, before the barrier; so it needs no second
//   buffer, and its shared memory is the register stages'.  The sum is
//   compensated (Kahan), so its float32 error does not grow with p.
//   fft_last.cu, planar_rfft.cu's r2c and fft_axis.cu run the pair-sum
//   form instead (stage_pairsum, in block_fft_fast): ~1/4 of the
//   arithmetic an output.
// The reference's c2c envelope (supported_c2c: n = r*m, m <= 128 the
// largest divisor, r <= 8) has prime factors up to 127; the half-length
// h = n/2 <= 1024 of its r2c envelope (even n <= 2048) up to 1021.
// Twiddles come from a float32 table tw[m] = exp(sign * 2*pi*i * m / n)
// that the host computes in float64; a direct stage indexes it with the
// exact product (t * (k + q * Ns)) mod (Ns * p).  FP32 throughout; no
// fast-math intrinsics (the round trip must stay below 1e-6 relative).
#pragma once

#include <cuda_runtime.h>

namespace fftblock {

// Elements each thread holds in registers per stage: the launcher sizes the
// block so that blockDim.x * kEPT >= n * ncol.
constexpr int kEPT = 16;
constexpr int kMaxStages = 12;
constexpr int kMaxN = 1024;

struct Plan {
  int nst;
  int radix[kMaxStages];
};

// Host and device: the radix sequence for n, or nst = 0 outside
// 2 <= n <= kMaxN.  Radices above 7 are direct stages.
__host__ __device__ inline Plan make_plan(int n) {
  Plan p;
  p.nst = 0;
  if (n < 2 || n > kMaxN) return p;
  int m = n;
  int a = 0;
  while (m % 2 == 0) {
    m /= 2;
    ++a;
  }
  if (a % 2) p.radix[p.nst++] = 2;
  for (int i = 0; i < a / 2; ++i) p.radix[p.nst++] = 4;
  for (int f = 3; f <= m; f += 2) {
    while (m % f == 0) {
      p.radix[p.nst++] = f;
      m /= f;
    }
  }
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

// Odd R-point DFT from the symmetric pairs v_t +- v_{R-t}: with
// c[m] = cos(2*pi*m/R), s[m] = sin(2*pi*m/R) for m = 0..(R-1)/2 and the
// angles 2*pi*t*q/R,
//   y_q     = v_0 + sum_t (v_t + v_{R-t}) cos
//                 + i*sign * sum_t (v_t - v_{R-t}) sin,
//   y_{R-q} = the same with the sine term negated.
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&v)[R], float sign,
                                        const float* c, const float* s) {
  constexpr int H = (R - 1) / 2;
  float2 sp[H + 1], dm[H + 1];
  float2 out[R];
  out[0] = v[0];
#pragma unroll
  for (int t = 1; t <= H; ++t) {
    sp[t] = cadd(v[t], v[R - t]);
    dm[t] = csub(v[t], v[R - t]);
    out[0] = cadd(out[0], sp[t]);
  }
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 a = v[0];
    float2 b = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      const int m = (t * q) % R;
      const float cm = m <= H ? c[m] : c[R - m];
      const float sm = m <= H ? s[m] : -s[R - m];
      a = make_float2(a.x + cm * sp[t].x, a.y + cm * sp[t].y);
      b = make_float2(b.x + sm * dm[t].x, b.y + sm * dm[t].y);
    }
    const float2 ib = make_float2(-sign * b.y, sign * b.x);  // i*sign*b
    out[q] = cadd(a, ib);
    out[R - q] = csub(a, ib);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = out[q];
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&v)[5], float sign) {
  const float c[3] = {1.f, 0.309016994374947424f, -0.809016994374947424f};
  const float s[3] = {0.f, 0.951056516295153572f, 0.587785252292473129f};
  dft_odd<5>(v, sign, c, s);
}

template <>
__device__ __forceinline__ void dft<7>(float2 (&v)[7], float sign) {
  const float c[4] = {1.f, 0.623489801858733531f, -0.222520933956314404f,
                      -0.900968867902419127f};
  const float s[4] = {0.f, 0.781831482468029809f, 0.974927912181823607f,
                      0.433883739117558120f};
  dft_odd<7>(v, sign, c, s);
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

// sum += term with Kahan's compensation in comp.
__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          float term) {
  const float y = term - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// A direct p-point stage in Stockham order: output q of butterfly j
// (k = j mod Ns) is y_q = sum_t x[j + t*n/p] tw[((t*(k + q*Ns)) mod (Ns*p))
// * n/(Ns*p)], the inter-stage twiddle and the DFT's in one table entry.
// Each thread computes up to kEPT outputs (index e = r*ncol + c, r = q*n/p
// + j) in registers before the barrier.
__device__ inline void stage_direct(float2* s, int n, int ncol, int pitch,
                                    int Ns, int p,
                                    const float2* __restrict__ tw) {
  const int stride = n / p;
  const int M = Ns * p;
  const int twstep = n / M;
  const int elems = n * ncol;
  float2 y[kEPT];
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < elems) {
      const int c = e % ncol;
      const int r = e / ncol;
      const int j = r % stride;
      const int q = r / stride;
      const int step = (j % Ns + q * Ns) % M;
      float2 sum = make_float2(0.f, 0.f);
      float2 comp = make_float2(0.f, 0.f);
      int idx = 0;
      for (int t = 0; t < p; ++t) {
        const float2 x = s[(j + t * stride) * pitch + c];
        const float2 w = __ldg(&tw[idx * twstep]);
        kahan_add(sum.x, comp.x, x.x * w.x - x.y * w.y);
        kahan_add(sum.y, comp.y, x.x * w.y + x.y * w.x);
        idx += step;
        if (idx >= M) idx -= M;
      }
      y[i] = sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < elems) {
      const int c = e % ncol;
      const int r = e / ncol;
      const int j = r % stride;
      const int q = r / stride;
      const int k = j % Ns;
      s[((j / Ns) * M + k + q * Ns) * pitch + c] = y[i];
    }
  }
  __syncthreads();
}

// True when the plan has a stage other than radix 2, 3 and 4 (radix 5 or
// 7, or a direct stage).  Each kernel has two instances, kMixed false and
// true: ptxas allocates registers for the largest stage a kernel can run,
// and with the radix-5/7 and direct stages compiled in it gave the kernels
// 64 registers a thread where they had 32 (at 1024 threads a block, one
// block an SM where there were two), and the kernels of the 256^3 plans
// ran 16-43% slower on an H100 80GB HBM3 (700 W).  So the plans of the
// old envelope (2^a * 3^b) keep the instance without those stages.
__host__ __device__ inline bool mixed_plan(const Plan& p) {
  for (int st = 0; st < p.nst; ++st)
    if (p.radix[st] > 4) return true;
  return false;
}

// Transforms every column of the tile; the caller has filled s and
// synchronised.  Returns after a barrier, with the spectrum in s.  The
// plan's radices must be 2, 3 and 4 unless kMixed.
template <bool kMixed>
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
    } else if (!kMixed || R == 3) {
      stage<3>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 5) {
      stage<5>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 7) {
      stage<7>(s, n, ncol, pitch, Ns, tw, sign);
    } else {
      stage_direct(s, n, ncol, pitch, Ns, R, tw);
    }
    Ns *= R;
  }
}

// ---- the row kernel's stages (fft_last.cu): the same Stockham plan with
// cheap index arithmetic and a pair-sum prime stage ----------------------
//
// On an H100 the stages above spend most of their instructions on index
// arithmetic: b % ncol, b / ncol and j % Ns by run-time divisors (~20
// instructions each), recomputed after the barrier.  The variants below
// divide by one multiply-high (FastDiv) and keep each butterfly's output
// offset across the barrier; their arithmetic and order are the stages'.

// x / d for 0 <= x < 2^16 and 1 <= d < 2^16: __umulhi(x, ceil(2^32 / d)) is
// exact there (d = 1 returns x).
struct FastDiv {
  int d;
  unsigned m;
  __device__ __forceinline__ explicit FastDiv(int dd)
      : d(dd), m(dd > 1 ? 0xffffffffu / static_cast<unsigned>(dd) + 1u : 0u) {}
  __device__ __forceinline__ int div(int x) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(x), m))
                 : x;
  }
};

// Radix 2, 3 and 4 issue all of a thread's loads, then all its twiddle
// loads, before any butterfly, so they are in flight together; radix 5
// and 7 transform each butterfly as it arrives (held all at once, their
// values spilled in the mixed instance).  Twiddles: none in the first
// stage (k = 0 throughout); where k = 0 later, tw[0] = 1 exactly.
template <int R>
constexpr bool kBatch = R <= 4;

template <int R, int kE>
__device__ __forceinline__ void stage_fast(float2* s, int n,
                                           const FastDiv& ncol, int pitch,
                                           int Ns,
                                           const float2* __restrict__ tw,
                                           float sign) {
  constexpr int kMaxB = (kE + R - 1) / R;
  const int stride = n / R;
  const int nb = stride * ncol.d;
  const int twstep = n / (Ns * R);
  const FastDiv ns(Ns);
  float2 v[kMaxB][R];
  int in[kMaxB], k[kMaxB], out[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    const int j = ncol.div(b);
    const int c = b - j * ncol.d;
    const int jq = ns.div(j);
    k[i] = j - jq * Ns;
    in[i] = j * pitch + c;
    out[i] = b < nb ? (jq * Ns * R + k[i]) * pitch + c : -1;
    if (b < nb) {
#pragma unroll
      for (int t = 0; t < R; ++t) v[i][t] = s[in[i] + t * stride * pitch];
      if (!kBatch<R>) {
        if (Ns > 1) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i] * twstep]));
        }
        dft<R>(v[i], sign);
      }
    }
  }
  if (kBatch<R>) {
    if (Ns > 1) {
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) {
        if (out[i] >= 0) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i] * twstep]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) dft<R>(v[i], sign);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    if (out[i] >= 0) {
#pragma unroll
      for (int t = 0; t < R; ++t) s[out[i] + t * Ns * pitch] = v[i][t];
    }
  }
  __syncthreads();
}

// Output items a thread holds in registers in a pair-sum stage: a p-point
// stage has (p + 1)/2 items a butterfly (y_0 and the pairs (q, p - q)), at
// most 6/11 of the tile's n * ncol values for p >= 11, so kE values a
// thread give at most pair_items(kE) items.
__host__ __device__ constexpr int pair_items(int kE) {
  return (kE * 6 + 10) / 11;
}
// Pair-sum stages with p above this compensate a_q and b_q (Kahan): the
// c2c envelope's primes (<= 127) hold the round trip to 1e-6 without it; at
// p = 1021 (the dense tier's lengths) a float32 model of the uncompensated
// sums came to 8e-7 (tests/test_torch_prime_stage.py).
constexpr int kPairSumExact = 127;

// A p-point stage (odd p >= 11) in Stockham order from the symmetric pairs,
// dft_odd's form over the tile, in place of stage_direct:
// - pass 1 multiplies input t of butterfly j (k = j mod Ns) by the
//   inter-stage twiddle tw[t * k * n/(Ns*p)] in place, as stage<R> does;
// - pass 2: a thread takes item q = 0..(p-1)/2 of butterfly j, column c,
//   and with x_t = s[j + t*n/p] sums
//     a_q = x_0 + sum_t cos(2*pi*t*q/p) * (x_t + x_{p-t}),
//     b_q =       sum_t sin(2*pi*t*q/p) * (x_t - x_{p-t}),  t = 1..(p-1)/2,
//   reading the cosines and (signed) sines at tw[m * n/p], m = t*q mod p
//   advanced by addition; y_q = a_q + i*b_q, y_{p-q} = a_q - i*b_q (q = 0
//   gives y_0 with m = 0).  ~4 FMAs a term an output pair, where
//   stage_direct spends ~16 flops a term an output.
template <bool kKahan, int kE>
__device__ inline void stage_pairsum(float2* s, int n, const FastDiv& ncol,
                                     int pitch, int Ns, int p,
                                     const float2* __restrict__ tw) {
  const int stride = n / p;
  const FastDiv fs(stride);
  if (Ns > 1) {
    const FastDiv ns(Ns);
    const int twstep = n / (Ns * p);
    const int elems = n * ncol.d;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int r = ncol.div(e);
      const int t = fs.div(r);
      const int j = r - t * stride;
      const int k = j - ns.div(j) * Ns;
      if (t > 0 && k > 0) {
        float2* a = &s[r * pitch + e - r * ncol.d];
        *a = cmul(*a, __ldg(&tw[t * k * twstep]));
      }
    }
    __syncthreads();
  }
  const int H = (p - 1) / 2;
  const int items = (H + 1) * stride * ncol.d;
  const int tstep = stride * pitch;
  constexpr int kItems = pair_items(kE);
  float2 y0[kItems], y1[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < items) {
      const int r = ncol.div(e);
      const int q = fs.div(r);
      const float2* lo = s + (r - q * stride) * pitch + e - r * ncol.d;
      const float2* hi = lo + (p - 1) * tstep;
      float2 a = *lo;
      float2 b = make_float2(0.f, 0.f);
      float2 ca = b, cb = b;
      int m = 0;
      for (int t = 1; t <= H; ++t) {
        lo += tstep;
        m += q;
        if (m >= p) m -= p;
        const float2 xp = *lo, xm = *hi;
        hi -= tstep;
        const float2 w = __ldg(&tw[m * stride]);
        const float2 sp = cadd(xp, xm), dm = csub(xp, xm);
        if (kKahan) {
          kahan_add(a.x, ca.x, w.x * sp.x);
          kahan_add(a.y, ca.y, w.x * sp.y);
          kahan_add(b.x, cb.x, w.y * dm.x);
          kahan_add(b.y, cb.y, w.y * dm.y);
        } else {
          a = make_float2(fmaf(w.x, sp.x, a.x), fmaf(w.x, sp.y, a.y));
          b = make_float2(fmaf(w.y, dm.x, b.x), fmaf(w.y, dm.y, b.y));
        }
      }
      y0[i] = make_float2(a.x - b.y, a.y + b.x);
      y1[i] = make_float2(a.x + b.y, a.y - b.x);
    }
  }
  __syncthreads();
  const FastDiv ns(Ns);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < items) {
      const int r = ncol.div(e);
      const int q = fs.div(r);
      const int j = r - q * stride;
      const int jq = ns.div(j);
      const int d = (jq * p * Ns + j - jq * Ns) * pitch + e - r * ncol.d;
      s[d + q * Ns * pitch] = y0[i];
      if (q > 0) s[d + (p - q) * Ns * pitch] = y1[i];
    }
  }
  __syncthreads();
}

// The last stage (Ns * R == n) of a plan whose last radix is a register
// stage, writing its outputs through out(c, k, y_k) (column c, index k in
// natural order) instead of back to the tile: threads take j fastest, so
// the tile reads stride by the odd pitch (no bank conflicts) and
// neighbouring threads write neighbouring k (coalesced global stores).
// No barrier: the caller synchronises before the tile is written again.
template <int R, int kE, typename Out>
__device__ __forceinline__ void stage_fast_last(const float2* s, int n,
                                                int ncol, int pitch,
                                                const float2* __restrict__ tw,
                                                float sign, Out out) {
  constexpr int kMaxB = (kE + R - 1) / R;
  const int Ns = n / R;
  const FastDiv fs(Ns);
  float2 v[kMaxB][R];
  int c[kMaxB], k[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    c[i] = b < Ns * ncol ? fs.div(b) : -1;
    k[i] = b - fs.div(b) * Ns;
    if (c[i] >= 0) {
#pragma unroll
      for (int t = 0; t < R; ++t)
        v[i][t] = s[(k[i] + t * Ns) * pitch + c[i]];
      if (!kBatch<R>) {
        if (Ns > 1) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i]]));
        }
        dft<R>(v[i], sign);
#pragma unroll
        for (int t = 0; t < R; ++t) out(c[i], k[i] + t * Ns, v[i][t]);
      }
    }
  }
  if (kBatch<R>) {
    if (Ns > 1) {
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) {
        if (c[i] >= 0) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i]]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      if (c[i] >= 0) {
        dft<R>(v[i], sign);
#pragma unroll
        for (int t = 0; t < R; ++t) out(c[i], k[i] + t * Ns, v[i][t]);
      }
    }
  }
}

// The last stage (Ns * R == n) of a column tile (fft_axis.cu): stage_fast's
// order, threads take the column c fastest, so neighbouring threads read
// and write neighbouring columns; its outputs go through out(c, k, y_k) as
// in stage_fast_last.  No barrier: the caller synchronises before the tile
// is written again.
template <int R, int kE, typename Out>
__device__ __forceinline__ void stage_fast_cols(const float2* s, int n,
                                                const FastDiv& ncol,
                                                int pitch,
                                                const float2* __restrict__ tw,
                                                float sign, Out out) {
  constexpr int kMaxB = (kE + R - 1) / R;
  const int Ns = n / R;
  const int nb = Ns * ncol.d;
  float2 v[kMaxB][R];
  int c[kMaxB], k[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    const int b = threadIdx.x + i * blockDim.x;
    k[i] = ncol.div(b);
    c[i] = b < nb ? b - k[i] * ncol.d : -1;
    if (c[i] >= 0) {
#pragma unroll
      for (int t = 0; t < R; ++t)
        v[i][t] = s[(k[i] + t * Ns) * pitch + c[i]];
      if (!kBatch<R>) {
        if (Ns > 1) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i]]));
        }
        dft<R>(v[i], sign);
#pragma unroll
        for (int t = 0; t < R; ++t) out(c[i], k[i] + t * Ns, v[i][t]);
      }
    }
  }
  if (kBatch<R>) {
    if (Ns > 1) {
#pragma unroll
      for (int i = 0; i < kMaxB; ++i) {
        if (c[i] >= 0) {
#pragma unroll
          for (int t = 1; t < R; ++t)
            v[i][t] = cmul(v[i][t], __ldg(&tw[t * k[i]]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      if (c[i] >= 0) {
        dft<R>(v[i], sign);
#pragma unroll
        for (int t = 0; t < R; ++t) out(c[i], k[i] + t * Ns, v[i][t]);
      }
    }
  }
}

// The last register stage of block_fft_fast: stage_fast_last (j fastest,
// the row kernels) or, with kCols, stage_fast_cols (c fastest).
template <int R, int kE, bool kCols, typename Out>
__device__ __forceinline__ void stage_last(const float2* s, int n,
                                           const FastDiv& ncol, int pitch,
                                           const float2* __restrict__ tw,
                                           float sign, Out out) {
  if constexpr (kCols)
    stage_fast_cols<R, kE>(s, n, ncol, pitch, tw, sign, out);
  else
    stage_fast_last<R, kE>(s, n, ncol.d, pitch, tw, sign, out);
}

// Values a thread holds in a stage of the row kernels (fft_last.cu,
// planar_rfft.cu's r2c) and of fft_axis.cu: 16 (256 threads a tile of
// kTile, at most 128 registers) for the plans of radix 2, 3 and 4; 8 (512
// threads, at most 64 registers) for the mixed instance, whose radix-5/7
// and pair-sum stages spilled 784 bytes a thread at 16.  On an H100 the
// other choice was 41% slower at row 10's n = 256 and 27% slower at row
// 20's n = 129 (tools/ab_fft_last.py).  Two blocks share a multiprocessor
// either way.
template <bool kMixed>
constexpr int kRowEPT = kMixed ? 8 : 16;

// block_fft's plan over the tile with the stages above: radix 2, 3 and 4
// (5 and 7 if kMixed) as stage_fast, each prime factor p >= 11 as
// stage_pairsum (kMixed only).  ncol.d < 2^16 columns, n * ncol < 2^16;
// the block has at least n * ncol / kE threads (kE values a thread).  A
// last register stage writes through `out` (stage_fast_last, or with kCols
// stage_fast_cols) and the call returns true; else the spectrum is left in
// the tile.
template <bool kMixed, int kE, bool kCols = false, typename Out>
__device__ inline bool block_fft_fast(float2* s, int n, const FastDiv& ncol,
                                      int pitch, const Plan& plan,
                                      const float2* __restrict__ tw,
                                      float sign, Out out) {
  const int last = plan.radix[plan.nst - 1];
  const bool fused = last <= (kMixed ? 7 : 4);
  int Ns = 1;
  for (int st = 0; st < plan.nst - (fused ? 1 : 0); ++st) {
    const int R = plan.radix[st];
    if (R == 4) {
      stage_fast<4, kE>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 2) {
      stage_fast<2, kE>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (!kMixed || R == 3) {
      stage_fast<3, kE>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 5) {
      stage_fast<5, kE>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R == 7) {
      stage_fast<7, kE>(s, n, ncol, pitch, Ns, tw, sign);
    } else if (R > kPairSumExact) {
      stage_pairsum<true, kE>(s, n, ncol, pitch, Ns, R, tw);
    } else {
      stage_pairsum<false, kE>(s, n, ncol, pitch, Ns, R, tw);
    }
    Ns *= R;
  }
  if (!fused) return false;
  if (last == 4) {
    stage_last<4, kE, kCols>(s, n, ncol, pitch, tw, sign, out);
  } else if (last == 2) {
    stage_last<2, kE, kCols>(s, n, ncol, pitch, tw, sign, out);
  } else if (!kMixed || last == 3) {
    stage_last<3, kE, kCols>(s, n, ncol, pitch, tw, sign, out);
  } else if (last == 5) {
    stage_last<5, kE, kCols>(s, n, ncol, pitch, tw, sign, out);
  } else {
    stage_last<7, kE, kCols>(s, n, ncol, pitch, tw, sign, out);
  }
  return true;
}

// Sets `kernel`'s dynamic shared memory to smem bytes and launches it with
// `args`; 0 or the CUDA error.
template <typename... P, typename... A>
int launch_kernel(void (*kernel)(P...), unsigned blocks, int threads,
                  size_t smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
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
  if (g->plan.nst == 0 || rows < 1)
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
