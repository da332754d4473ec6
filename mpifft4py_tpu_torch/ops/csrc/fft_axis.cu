// c2c FFT along the middle axis of a planar (re, im) float32 pair viewed as
// (pre, n, post).
//
// Replaces the Pallas kernel mpifft4py_tpu/ops/pallas_fft3d.py:
// fft_axis_planar (_factored_fft_kernel), which runs the DFT as factored
// MXU matmuls.  The template parameter kC64 picks the global layout: false,
// the planar pair above (row 1); true, interleaved complex64 (x and y each
// one array of float2), for the dense tier's mpifft4py_tpu/ops/pallas_fft.py:
// fft_axis (_fft_axis_pallas, _cfft_kernel), row 19, which runs the c2c DFT
// along a non-last axis of (pre, n, post) as one dense n x n matmul pair.
// Only the bytes a value and the planes differ.
//
// An FFT of n <= 1024 points does 5 n log2 n flops on 16 bytes a point
// moved through HBM, ~3 flops a byte: HBM bytes bound it ((3, 512, 512,
// 256) along axis 2, the packed 512^3 step's y stage: 3.22 GB, 0.96 ms at
// 3.35 TB/s).  The stages (fft_axis_kernel below: column tiles through
// shared memory, block_fft_fast's radix-2/3/4 stages) ran at 24-36% of that
// bound in the benchmark's cells: each value went through shared memory
// about seven times (five stages at n = 512, two barriers each, an
// interleave pass, a staged store), so the stages, not the copies, set
// their pace.  The register passes (fft_axis_kernel_passes), for n = r1 *
// r2 with radices of kRadix (pass_plan: every 2^a 3^b <= 1024 with b <= 2):
//
// - a tile is T neighbouring `post` columns across all n rows of one `pre`
//   index (tile_cols: n T <= kAxisTile, widened to 64-byte row segments
//   within n T <= kAxisMaxTile: T = 16 at n = 512, 8 at 768 and 1024); a
//   last ragged tile transforms only its own columns;
// - a persistent grid walks the tiles; two slots, an mbarrier each: every
//   thread copies its share of a tile's row segments into a slot by
//   cp.async (load_plane), 16-byte chunks where every segment starts on
//   the 16-byte grid (kGrid); complex64 rows off it (row 19) land shifted
//   by the segment's offset past the grid, a chunk inside the segment
//   whole, its head and tail value by value;
// - the first pass: a thread holds an r1-point sub-transform of a column in
//   registers (rdft: radix 4 and 2 with constant twiddles), read from the
//   slot (conjugated for the inverse), and leaves it in the work tile; one
//   barrier, and the copy of tile it + 2 into the slot starts;
// - the second pass: an r2-point sub-transform times tw[t k], stored
//   straight to global memory with 1/n folded in, neighbouring threads on
//   neighbouring columns (whole 32-byte sectors of a row a warp); a barrier
//   before the work tile is written again.
//
// So a value passes through shared memory three times a tile (landing, the
// work tile in, out) with two barriers, where the stages took seven passes
// and ~12 barriers.  The stages keep the plans with a factor 3^3 or a prime
// above 3 (radix 5/7, the pair sums), and planar rows off the 16-byte grid
// (the 3/2 rule's y stage, 1028-byte rows): there the passes' copies of
// 32-byte segments that straddle two sectors were slower than the stages'
// (launch below).  The two kernels' names tell them apart in a trace.
//
// Measured on an H100 80GB HBM3 (700 W; tools/ab_fft_last.py --kernel
// fft_axis, the stages on every launch in the same call; ms, share of
// 3.35 TB/s):
// (3, 512, 512, 256) along axis 2 1.48 (65%; the stages 2.88, 32-byte
// segments 2.34); (6, 512, 512, 256) 3.16 (61%; 6.74); (512, 512, 256)
// along axes 0 and 1 0.44 and 0.46 (73%, 70%; 0.90, 0.88); (3, 768, 512,
// 257) along axis 1 2.84 (51%; 5.04); (3, 256, 1024, 512) along axis 2
// 3.32 (58%; 5.90); (3, 1024, 256, 512) along axis 1 4.00 (48%; 6.35);
// complex64 (256, 256, 129) along axis 1 0.074 (55%; 0.110).  The stages
// at (3, 768, 768, 257) along axis 2: 9.84 (22%); the passes, in another
// call, 11.86.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "bulk_ring.cuh"
#include "fft_block.cuh"

using fftblock::Plan;

namespace {

using namespace bulkring;

// ---- the stages in shared memory (fft_axis_kernel) ------------------------
//
// The plans the register passes do not serve, and planar rows off the
// 16-byte grid (see launch below).  Two slots, an mbarrier each, filled
// by load_cols (16-byte chunks where a plane's whole tile lies on the grid,
// else value by value); the slot's planes are interleaved into a work tile
// of float2, block_fft_fast (fft_block.cuh) transforms its columns, its
// last stage stages the spectrum in the slot (stage_fast_cols), and the
// threads store the slot (store_cols).

// Every thread: copies its share of the column tile (bulk_ring.cuh) of x0
// (and, if kTwo, x1, landing PL floats further) into `slot` and arrives on
// `bar` once it has landed.  The caller has ordered the slot's earlier
// reads (a barrier).
template <int kB, bool kTwo>
__device__ void load_cols(const float* x0, const float* x1, long long g0,
                          long long pitch, int n, int w, int lgT, float* slot,
                          int PL, uint64_t* bar) {
  constexpr int kF = kB / 4;
  const auto plane = [&](const float* x, float* dst) {
    if (whole_chunks<kB>(x, g0, pitch, w))
      for_copies<kB, true>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        cp_async<16>(dst + e * kF, x + g);
      });
    else
      for_copies<kB, false>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        cp_async<kB>(dst + e * kF, x + g);
      });
  };
  plane(x0, slot);
  if (kTwo) plane(x1, slot + PL);
  cp_async_arrive(bar);
}

// Every thread: stores its share of the tile staged in `slot` (as
// load_cols lands it) to y0 (and y1), in 16-byte chunks where the tile
// goes whole.  The staged values are visible to it (a barrier).
template <int kB, bool kTwo>
__device__ void store_cols(float* y0, float* y1, long long g0,
                           long long pitch, int n, int w, int lgT,
                           const float* slot, int PL) {
  constexpr int kF = kB / 4;
  using V = typename std::conditional<kB == 8, float2, float>::type;
  const auto plane = [&](float* y, const float* src) {
    if (whole_chunks<kB>(y, g0, pitch, w))
      for_copies<kB, true>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        *reinterpret_cast<float4*>(y + g) =
            *reinterpret_cast<const float4*>(src + e * kF);
      });
    else
      for_copies<kB, false>(g0, pitch, n, w, lgT, [&](int e, long long g) {
        *reinterpret_cast<V*>(y + g) =
            *reinterpret_cast<const V*>(src + e * kF);
      });
  };
  plane(y0, slot);
  if (kTwo) plane(y1, slot + PL);
}

// Values a tile: the default budget, and the most (a tile of a 1024-point
// plan keeps a 32-byte segment a plane: T = 8 planar).
constexpr int kAxisTile = 4096;
constexpr int kAxisMaxTile = 8192;

// Tile it of a block lands in slot it % 2.  In iteration it the block
// waits for tile it and interleaves it into the work tile; then it starts
// the copy of tile it + 1 into slot (it + 1) % 2 (stored from in
// iteration it - 1), transforms tile it, stages the spectrum in slot
// it % 2 (now free) and stores it.
template <bool kC64, bool kMixed>
__global__ void
__launch_bounds__(kAxisMaxTile / fftblock::kRowEPT<kMixed>, 1)
fft_axis_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n,
                long long post, int lgT, long long tpp, long long tiles,
                float sign, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kC64 ? 8 : 4;
  const int T = 1 << lgT;
  const int PL = n * T;  // floats a plane of a slot (planar)
  const int SL = 2 * PL;  // floats a slot
  float2* s = reinterpret_cast<float2*>(smem + 2 * SL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + n * T);
  // tile -> its first value (p, 0, q0) and its width
  const auto origin = [&](long long t, long long& g0, int& w) {
    const long long p = t / tpp;
    const long long q0 = (t - p * tpp) << lgT;
    g0 = p * n * post + q0;
    w = static_cast<int>(min(static_cast<long long>(T), post - q0));
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], blockDim.x);
    mbar_init(&bar[1], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  {
    long long g0;
    int w;
    origin(blockIdx.x, g0, w);
    load_cols<kB, !kC64>(xr, xi, g0, post, n, w, lgT, smem, PL, &bar[0]);
  }

  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    float* slot = smem + b * SL;
    long long g0;
    int w;
    origin(tile, g0, w);
    mbar_wait(&bar[b], (it >> 1) & 1);

    // the slot -> the work tile (the same order; planar: the planes
    // interleaved), 16 bytes a load
    const float4* in = reinterpret_cast<const float4*>(slot);
    float4* work = reinterpret_cast<float4*>(s);
    if (kC64) {
      for (int e = threadIdx.x; e < SL / 4; e += blockDim.x) work[e] = in[e];
    } else {
      for (int e = threadIdx.x; e < PL / 4; e += blockDim.x) {
        const float4 re = in[e], im = in[PL / 4 + e];
        work[2 * e] = make_float4(re.x, im.x, re.y, im.y);
        work[2 * e + 1] = make_float4(re.z, im.z, re.w, im.w);
      }
    }
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      long long h0;
      int hw;
      origin(next, h0, hw);
      load_cols<kB, !kC64>(xr, xi, h0, post, n, hw, lgT,
                           smem + (b ^ 1) * SL, PL, &bar[b ^ 1]);
    }

    // column c, index k of the spectrum, scaled, staged in the slot
    const auto put = [&](int c, int k, float2 v) {
      const int e = (k << lgT) + c;
      if (kC64) {
        reinterpret_cast<float2*>(slot)[e] =
            make_float2(v.x * scale, v.y * scale);
      } else {
        slot[e] = v.x * scale;
        slot[PL + e] = v.y * scale;
      }
    };
    const fftblock::FastDiv fcol(w);
    if (!fftblock::block_fft_fast<kMixed, fftblock::kRowEPT<kMixed>, true>(
            s, n, fcol, T, plan, tw, sign, put)) {
      for (int e = threadIdx.x; e < PL; e += blockDim.x)
        if ((e & (T - 1)) < w) put(e & (T - 1), e >> lgT, s[e]);
    }
    __syncthreads();
    store_cols<kB, !kC64>(yr, yi, g0, post, n, w, lgT, slot, PL);
  }
}

// Bytes a row segment at least: the stages' where the rows start off the
// 16-byte grid (their pitch is not a multiple of 16 bytes: a segment then
// straddles one more 32-byte sector, so wider ones waste less; one sector
// elsewhere), and the register passes' everywhere.
constexpr int kWide = 64;

// log2 of the columns a tile: the most with n * T <= kAxisTile, widened
// (n * T <= kAxisMaxTile) to segments of seg bytes, at most `post` rounded
// up to a power of two (but a 16-byte unit); then halved, down to that
// segment width, while the tiles would not give every multiprocessor two.
int tile_cols(int n, long long pre, long long post, int kB, int sms,
              int seg) {
  const int unit = 16 / kB;
  int T = unit;
  while (2 * T * n <= kAxisTile) T *= 2;
  while (T * kB < seg && 2 * T * n <= kAxisMaxTile) T *= 2;
  while (T > unit && T / 2 >= post) T /= 2;
  while (T * kB > seg && pre * ((post + T - 1) / T) < 2LL * sms) T /= 2;
  int lg = 0;
  while ((1 << lg) < T) ++lg;
  return lg;
}

template <bool kC64, bool kMixed>
int launch_instance(const float* xr, const float* xi, float* yr, float* yi,
                    const float2* tw, const Plan& plan, long long pre, int n,
                    long long post, float sign, float scale,
                    cudaStream_t stream) {
  constexpr int kB = kC64 ? 8 : 4;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int lgT =
      tile_cols(n, pre, post, kB, sms, (post * kB) % 16 ? kWide : 32);
  const int T = 1 << lgT;
  constexpr int kE = fftblock::kRowEPT<kMixed>;
  const int threads = (n * T + kE * 32 - 1) / (kE * 32) * 32;
  const size_t smem = sizeof(float) * 4 * n * T + sizeof(float2) * n * T +
                      sizeof(uint64_t) * 2;
  const long long tpp = (post + T - 1) / T;
  return launch_persistent(fft_axis_kernel<kC64, kMixed>, pre * tpp,
                           threads, smem, stream, xr, xi, yr, yi, tw, plan,
                           n, post, lgT, tpp, pre * tpp, sign, scale);
}

// ---- the register passes (fft_axis_kernel_passes) -------------------------

// A compile-time index: decltype(i)::value in a template argument, the
// conversion elsewhere (std::integral_constant's is host-only without
// --expt-relaxed-constexpr).
template <int I>
struct Idx {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(Idx<i>) for i = 0..N-1, unrolled at compile time.
template <typename F, int... I>
__device__ __forceinline__ void unroll_seq(F& f,
                                           std::integer_sequence<int, I...>) {
  (f(Idx<I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_seq(f, std::make_integer_sequence<int, N>{});
}

// cos(2 pi j / 96) for 0 <= j < 96, from the first quadrant's values.
__host__ __device__ constexpr double cos96(int j) {
  constexpr double q[25] = {
      1.0, 0.99785892323860351, 0.99144486137381041, 0.98078528040323045,
      0.96592582628906829, 0.94693012949510566, 0.92387953251128676,
      0.8968727415326883, 0.86602540378443865, 0.83146961230254524,
      0.79335334029123516, 0.7518398074789774, 0.70710678118654752,
      0.65934581510006887, 0.60876142900872064, 0.55557023301960222, 0.5,
      0.44228869021900128, 0.38268343236508977, 0.32143946530316158,
      0.25881904510252076, 0.19509032201612827, 0.13052619222005159,
      0.065403129230143067, 0.0};
  return j <= 24 ? q[j] : j <= 48 ? -q[48 - j] : j <= 72 ? -q[j - 48]
                                                        : q[96 - j];
}

// x * exp(-2 pi i M / R) for R dividing 96: the quarter turns exactly, the
// rest by the float32 cosine and sine, rounded once from double.
template <int R, int M>
__device__ __forceinline__ float2 rot(float2 x) {
  constexpr int m = M % R;
  if constexpr (m == 0) {
    return x;
  } else if constexpr (4 * m == R) {
    return make_float2(x.y, -x.x);
  } else if constexpr (2 * m == R) {
    return make_float2(-x.x, -x.y);
  } else if constexpr (4 * m == 3 * R) {
    return make_float2(-x.y, x.x);
  } else {
    constexpr int j = m * (96 / R);
    constexpr float c = static_cast<float>(cos96(j));
    constexpr float s = static_cast<float>(cos96((j + 72) % 96));
    return make_float2(x.x * c + x.y * s, x.y * c - x.x * s);
  }
}

// The forward R-point DFT of v in registers, in place (R a radix of
// kRadix): R = A * B, A = 4 (or 2) point DFTs of the B strided
// subsequences, the twiddles exp(-2 pi i b k / R), B-point DFTs; every
// index a constant.
template <int R>
__device__ __forceinline__ void rdft(float2 (&v)[R]) {
  if constexpr (R <= 4) {
    fftblock::dft<R>(v, -1.f);
  } else {
    constexpr int A = R % 4 == 0 ? 4 : 2, B = R / A;
    float2 y[A][B];
    unroll<B>([&](auto b) {
      float2 u[A];
      unroll<A>([&](auto a) { u[a] = v[b + B * a]; });
      fftblock::dft<A>(u, -1.f);
      unroll<A>([&](auto k) {
        y[k][b] = rot<R, decltype(b)::value * decltype(k)::value>(u[k]);
      });
    });
    unroll<A>([&](auto k) {
      rdft<B>(y[k]);
      unroll<B>([&](auto q) { v[k + A * q] = y[k][q]; });
    });
  }
}

// The radices of the register passes: 2^a 3^b up to 32 (b <= 1), each a
// divisor of 96.
constexpr int kRadix[] = {2, 3, 4, 6, 8, 12, 16, 24, 32};

// f(Idx<r>) for the radix r.
template <typename F>
__device__ __forceinline__ void with_radix(int r, F&& f) {
  switch (r) {
    case 2: f(Idx<2>{}); break;
    case 3: f(Idx<3>{}); break;
    case 4: f(Idx<4>{}); break;
    case 6: f(Idx<6>{}); break;
    case 8: f(Idx<8>{}); break;
    case 12: f(Idx<12>{}); break;
    case 16: f(Idx<16>{}); break;
    case 24: f(Idx<24>{}); break;
    case 32: f(Idx<32>{}); break;
  }
}

// A tile in its slot (load_plane below): value (r, c) at row r (P values a
// row); complex64 one plane of float2, each row shifted by m(r) = (m0 + r
// pm) mod 2 values, its segment's offset past the 16-byte grid (none where
// kGrid); planar (on the grid only) the re plane then the im plane, PL
// floats apart.
template <bool kC64, bool kGrid>
struct TileIn {
  const float* s;
  int PL, P, m0, pm;
  __device__ __forceinline__ float2 at(int r, int c) const {
    const int e = r * P + c;
    if constexpr (kC64) {
      const int m = kGrid ? 0 : (m0 + r * pm) & 1;
      return reinterpret_cast<const float2*>(s)[e + m];
    } else {
      static_assert(kGrid, "planar rows off the grid take the stages");
      return make_float2(s[e], s[PL + e]);
    }
  }
};

// The output at global value g, scaled: re by sr, im by si (the inverse's
// conjugation and 1/n).
template <bool kC64>
struct TileOut {
  float* yr;
  float* yi;
  long long g0, post;
  float sr, si;
  __device__ __forceinline__ void put(long long g, float2 v) const {
    if constexpr (kC64) {
      reinterpret_cast<float2*>(yr)[g] = make_float2(v.x * sr, v.y * si);
    } else {
      yr[g] = v.x * sr;
      yi[g] = v.y * si;
    }
  }
};

// The whole transform in one pass (n = R): a thread a live column, its n
// values in registers, straight to global memory.
template <int R, bool kC64, bool kGrid>
__device__ __forceinline__ void pass_one(const TileIn<kC64, kGrid>& in,
                                         const TileOut<kC64>& out, int w,
                                         float cj) {
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    float2 v[R];
    unroll<R>([&](auto t) {
      const float2 x = in.at(t, c);
      v[t] = make_float2(x.x, x.y * cj);
    });
    rdft<R>(v);
    unroll<R>([&](auto t) { out.put(out.g0 + c + t * out.post, v[t]); });
  }
}

// The first of two passes (n = R * S, S = n / R): sub-transform b = (j, c)
// (j < S, column c fastest) takes rows j + t S of column c from the slot,
// conjugated for the inverse, and leaves its R outputs at work rows
// j (R + 1) + t (Stockham order, Ns = 1; one row of padding every R rows
// spreads neighbouring j over the banks).
template <int R, bool kC64, bool kGrid>
__device__ __forceinline__ void pass_first(const TileIn<kC64, kGrid>& in,
                                           float2* work, int n, int lgT,
                                           int w, float cj) {
  const int S = n / R;
  const int T = 1 << lgT;
  for (int b = threadIdx.x; b < S << lgT; b += blockDim.x) {
    const int c = b & (T - 1), j = b >> lgT;
    if (c >= w) continue;
    float2 v[R];
    unroll<R>([&](auto t) {
      const float2 x = in.at(j + t * S, c);
      v[t] = make_float2(x.x, x.y * cj);
    });
    rdft<R>(v);
    float2* o = work + ((j * (R + 1)) << lgT) + c;
    unroll<R>([&](auto t) { o[t << lgT] = v[t]; });
  }
}

// The second pass (Ns = n / R, the first pass's radix): sub-transform b =
// (k, c) (k < Ns) takes work rows k + t Ns (padded), times tw[t k]
// (conjugated for the inverse), and stores output k + t Ns of column c
// straight to global memory: neighbouring threads on neighbouring columns.
template <int R, bool kC64>
__device__ __forceinline__ void pass_last(const float2* work,
                                          const TileOut<kC64>& out, int n,
                                          int lgT, int w,
                                          const float2* __restrict__ tw,
                                          float cj) {
  const int Ns = n / R;
  const int T = 1 << lgT;
  const int step = (Ns + 1) << lgT;
  for (int b = threadIdx.x; b < Ns << lgT; b += blockDim.x) {
    const int c = b & (T - 1), k = b >> lgT;
    if (c >= w) continue;
    const float2* s = work + (k << lgT) + c;
    float2 v[R];
    unroll<R>([&](auto t) { v[t] = s[t * step]; });
    unroll<R>([&](auto t) {
      if constexpr (decltype(t)::value > 0) {
        const float2 f = __ldg(&tw[t * k]);
        v[t] = fftblock::cmul(v[t], make_float2(f.x, f.y * cj));
      }
    });
    rdft<R>(v);
    const long long o0 = out.g0 + static_cast<long long>(k) * out.post + c;
    const long long os = static_cast<long long>(Ns) * out.post;
    unroll<R>([&](auto t) { out.put(o0 + t * os, v[t]); });
  }
}

// Every thread: its cp.async copies of one plane of a tile (n row segments
// of w values of kB bytes, segment r at value g0 + r * pitch of x; its
// offset past the 16-byte grid m(r) = (m0 + r pm) mod U values) into `dst`,
// row r at r * P values, value c at m(r) + c: the row's 16-byte chunks (P /
// U of them) whole where they lie inside the segment (all of them where
// kGrid), the values of one that holds the segment's head or tail one by
// one.  Neighbouring threads take neighbouring chunks.
template <int kB, bool kGrid>
__device__ __forceinline__ void load_plane(const float* x, long long g0,
                                           long long pitch, int n, int w,
                                           int P, const fftblock::FastDiv& C,
                                           int m0, int pm, float* dst) {
  constexpr int U = 16 / kB, kF = kB / 4;
  for (int i = threadIdx.x; i < n * C.d; i += blockDim.x) {
    const int r = C.div(i), q = i - r * C.d;
    const int m = kGrid ? 0 : (m0 + r * pm) & (U - 1);
    const int lo = q * U - m;  // the chunk's first value in the segment
    const float* a = x + (g0 + r * pitch + lo) * kF;
    float* d = dst + (r * P + q * U) * kF;
    if (lo >= 0 && lo + U <= w) {
      cp_async<16>(d, a);
    } else if (!kGrid) {
#pragma unroll
      for (int e = 0; e < U; ++e)
        if (lo + e >= 0 && lo + e < w) cp_async<kB>(d + e * kF, a + e * kF);
    }
  }
}

// Slots a block: tile it lands in slot it % kAxisSlots.
constexpr int kAxisSlots = 2;
// Threads a block at most: 128 registers a thread.
constexpr int kAxisThreads = 512;

// n = r1 * r2 (r2 = 1: one pass).  In iteration it the block waits for tile
// it in its slot, runs the first pass (slot -> work tile), and once every
// thread has read the slot starts the copy of tile it + kAxisSlots into it;
// then the second pass (work tile -> global memory).  kGrid: every row
// segment of x starts on the 16-byte grid (planar: always).
template <bool kC64, bool kGrid>
__global__ void __launch_bounds__(kAxisThreads, 1)
fft_axis_kernel_passes(const float* __restrict__ xr,
                       const float* __restrict__ xi, float* __restrict__ yr,
                       float* __restrict__ yi, const float2* __restrict__ tw,
                       int r1, int r2, int n, long long post, int lgT, int P,
                       long long tpp, long long tiles, float cj,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kB = kC64 ? 8 : 4, U = 16 / kB;
  const int T = 1 << lgT;
  const int PL = n * P;     // floats a plane of a slot (planar)
  const int SL = 2 * PL;    // floats a slot
  float2* work = reinterpret_cast<float2*>(smem + kAxisSlots * SL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      work + (r2 > 1 ? (n + n / r1) << lgT : 0));
  const fftblock::FastDiv chunks(P / U);
  const int xb = static_cast<int>(reinterpret_cast<uintptr_t>(xr) / kB);
  const int pm = static_cast<int>(post & (U - 1));
  // tile -> its first value (p, 0, q0) and its width
  const auto origin = [&](long long t, long long& g0, int& w) {
    const long long p = t / tpp;
    const long long q0 = (t - p * tpp) << lgT;
    g0 = p * n * post + q0;
    w = static_cast<int>(min(static_cast<long long>(T), post - q0));
  };
  const auto shift = [&](long long g0) {
    return static_cast<int>((xb + g0) & (U - 1));
  };
  const auto load = [&](long long t, int b) {
    long long g0;
    int w;
    origin(t, g0, w);
    float* slot = smem + b * SL;
    load_plane<kB, kGrid>(xr, g0, post, n, w, P, chunks, shift(g0), pm,
                          slot);
    if constexpr (!kC64)
      load_plane<4, kGrid>(xi, g0, post, n, w, P, chunks, 0, 0, slot + PL);
    cp_async_arrive(&bar[b]);
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < kAxisSlots; ++b) mbar_init(&bar[b], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int b = 0; b < kAxisSlots; ++b) {
    const long long t = blockIdx.x + static_cast<long long>(b) * gridDim.x;
    if (t < tiles) load(t, b);
  }

  long long tile = blockIdx.x;
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int b = it % kAxisSlots;
    long long g0;
    int w;
    origin(tile, g0, w);
    mbar_wait(&bar[b], (it / kAxisSlots) & 1);
    const TileIn<kC64, kGrid> in{smem + b * SL, PL, P, shift(g0), pm};
    const TileOut<kC64> out{yr, yi, g0, post, scale, scale * cj};
    if (r2 == 1)
      with_radix(r1, [&](auto R) {
        pass_one<decltype(R)::value>(in, out, w, cj);
      });
    else
      with_radix(r1, [&](auto R) {
        pass_first<decltype(R)::value>(in, work, n, lgT, w, cj);
      });
    __syncthreads();
    const long long next =
        tile + static_cast<long long>(kAxisSlots) * gridDim.x;
    if (next < tiles) load(next, b);
    if (r2 > 1) {
      with_radix(r2, [&](auto R) {
        pass_last<decltype(R)::value>(work, out, n, lgT, w, tw, cj);
      });
      __syncthreads();
    }
  }
}

bool is_radix(int r) {
  for (int q : kRadix)
    if (q == r) return true;
  return false;
}

// n = r1 * r2 over kRadix, r2 = 1 where n is one: of the splits, the most
// even, the larger radix first; r1 = 0 where there is none (a factor 3^3, a
// prime above 3, 2^a 3^b above 1024 in two).
void pass_plan(int n, int& r1, int& r2) {
  r1 = 0;
  r2 = 0;
  if (is_radix(n)) {
    r1 = n;
    r2 = 1;
    return;
  }
  for (int a : kRadix) {
    if (n % a || !is_radix(n / a)) continue;
    const int lo = std::min(a, n / a), best = std::min(r1, r2);
    if (!r1 || lo > best || (lo == best && a > r1)) {
      r1 = a;
      r2 = n / a;
    }
  }
}

// Bytes of shared memory fft_axis_kernel_passes takes: the slots (P values
// a row), the work tile (two passes) and the mbarriers.
size_t pass_smem(int n, int lgT, int P, int r1, int r2) {
  return sizeof(float) * kAxisSlots * 2 * n * P +
         (r2 > 1 ? sizeof(float2) * ((n + n / r1) << lgT) : 0) +
         sizeof(uint64_t) * kAxisSlots;
}

template <bool kC64, bool kGrid>
int launch_passes(const float* xr, const float* xi, float* yr, float* yi,
                  const float2* tw, int r1, int r2, long long pre, int n,
                  long long post, float cj, float scale,
                  cudaStream_t stream) {
  constexpr int kB = kC64 ? 8 : 4, U = 16 / kB;
  int dev = 0, sms = 0, most = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  // tile_cols' width, halved while the slots and the work tile would not fit
  int lgT = tile_cols(n, pre, post, kB, sms, kWide);
  const auto pitch = [&](int lg) { return kGrid ? 1 << lg : (1 << lg) + U; };
  while ((1 << lgT) > U &&
         pass_smem(n, lgT, pitch(lgT), r1, r2) > static_cast<size_t>(most))
    --lgT;
  const int T = 1 << lgT, P = pitch(lgT);
  const int subs = r2 == 1 ? T : std::max(n / r1, r1) * T;
  const int threads = std::min(kAxisThreads, (subs + 31) / 32 * 32);
  const long long tpp = (post + T - 1) / T;
  return launch_persistent(fft_axis_kernel_passes<kC64, kGrid>, pre * tpp,
                           threads, pass_smem(n, lgT, P, r1, r2), stream, xr,
                           xi, yr, yi, tw, r1, r2, n, post, lgT, P, tpp,
                           pre * tpp, cj, scale);
}

// One launch; for kC64, xr and yr are the interleaved arrays and xi, yi
// are unused.  A base misaligned for its value type (not 4-byte aligned
// planar, not 8-byte aligned complex64) is refused.
template <bool kC64>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const void* tw, long long pre, int n, long long post, int inverse,
           void* stream) {
  const Plan plan = fftblock::make_plan(n);
  if (plan.nst == 0 || pre < 1 || post < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = kC64 ? 8 : 4;
  if ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
       reinterpret_cast<uintptr_t>(yr) | reinterpret_cast<uintptr_t>(yi)) %
      align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float sign = inverse ? 1.f : -1.f;
  const float sc = inverse ? 1.f / static_cast<float>(n) : 1.f;
  const auto* t = static_cast<const float2*>(tw);
  auto st = static_cast<cudaStream_t>(stream);
  // The register passes where n has a pass plan: on the 16-byte grid, and
  // off it for complex64 (row 19's 1032-byte rows: 0.074 ms, the stages
  // 0.110).  Planar rows off the grid take the stages: at the 3/2 rule's y
  // stage, (3, 768, 768, 257) along axis 2, the passes took 11.86 ms and
  // the stages 9.7-9.8 (the header).  The stages' plain instance serves the
  // planar plans of radix 2, 3 and 4; the mixed one the rest, and every
  // complex64 plan the passes do not (those with a factor 3^3).
  int r1, r2;
  pass_plan(n, r1, r2);
  const float cj = inverse ? -1.f : 1.f;
  const bool grid =
      (post * (kC64 ? 8 : 4)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(xr) |
       (kC64 ? 0 : reinterpret_cast<uintptr_t>(xi))) % 16 == 0;
  if (r1 && grid)
    return launch_passes<kC64, true>(xr, xi, yr, yi, t, r1, r2, pre, n, post,
                                     cj, sc, st);
  if constexpr (kC64) {
    if (r1)
      return launch_passes<true, false>(xr, xi, yr, yi, t, r1, r2, pre, n,
                                        post, cj, sc, st);
    return launch_instance<true, true>(xr, xi, yr, yi, t, plan, pre, n,
                                       post, sign, sc, st);
  } else {
    return fftblock::mixed_plan(plan)
               ? launch_instance<false, true>(xr, xi, yr, yi, t, plan, pre,
                                              n, post, sign, sc, st)
               : launch_instance<false, false>(xr, xi, yr, yi, t, plan, pre,
                                               n, post, sign, sc, st);
  }
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
