// The decompositions' transposes fused with a c2c FFT, over peer memory.
//
// Replaces the Pallas kernels of mpifft4py_tpu/parallel/rdma.py:
// - fused_transpose_fft_x (_fused_kernel), row 24: the slab's all-to-all
//   receive (split axis 1 -> concat axis 0) with the forward x c2c;
// - fused_ifft_x_transpose (_fused_inv_kernel), row 25: the inverse x c2c
//   (1/N0 folded in) with the all-to-all's send (split 0 -> concat 1);
// - fused_transpose_fft_y (_fused_y_kernel), row 26: the pencil's P2-group
//   receive (split the lanes -> concat y) with the forward y c2c;
// - fused_ifft_y_transpose (_fused_y_inv_kernel), row 27: the inverse y
//   c2c (1/N1 folded in) with the send (split y -> concat the lanes).
// On the TPU each is one kernel that posts per-peer remote DMAs over ICI
// and overlaps chunk c+1's copies with chunk c's MXU matmuls.  Here every
// rank of the group owns a *symmetric buffer*, a float32 tensor (re plane,
// then im plane) whose address every peer holds, through CUDA IPC, in a
// device table of P base pointers, and the four are one kernel over
// (outer, n, inner) strides.  A rank's buffer holds (outer, n/P, P*inner)
// per plane: n/P rows of the transformed axis, each row the P ranks'
// `inner` columns side by side; the rank's local side is (outer, n, inner):
// - rows 24-25: outer = C components, n = N0, inner = Np1*h (the buffer is
//   the zy stage's pair (C, Np0, N1, h));
// - rows 26-27: outer = C*n0 (components and x rows), n = N1, inner =
//   w2 = W/P lanes (the buffer is the z stage's pair (C, n0, N1/P, W)).
// - pull (forward): a block takes T consecutive columns of this rank's
//   inner block of one outer index and gathers their n points, n/P rows
//   from each peer d (rows d*n/P ...), into shared memory, runs the c2c
//   there with fft_block.cuh's plan and writes the local (outer, n,
//   inner);
// - push (inverse): a block loads T local columns (n points each), runs
//   the inverse c2c and stores rows d*n/P ... into peer d's buffer at
//   columns my*inner ...: the layout lax.all_to_all(tiled=True) gives.
// A column's n points lie at one address in each of n/P rows of a peer,
// so the T columns of a block read and write T consecutive floats of each
// row, as fft_axis.cu does.  T is at most 32 (16 above n = 512) and evens
// out the tiles of a row: the pencil's inner width is small and odd (w2 =
// 65 at 256^3 on a 2x2 grid: 3 tiles of 22, not 32 + 32 + 1), and the
// ragged last tile is masked.  On one card the peers' buffers are in the
// same HBM; across cards the same loads and stores go over NVLink through
// the IPC mappings.  Offsets are 64-bit throughout.
//
// Bound: bytes.  Each point is read once and written once (16 bytes a
// complex point), 5 n log2 n flops a column: ~3 flops a byte at n = 256,
// far below the card's FP32 rate.  The design moves each byte once, like
// the plain stage; the host orders the ranks (the producer, a stream
// synchronise and a group barrier before the launch; a synchronise and a
// barrier after), so nothing in the kernel waits on another process:
// ranks that share one card run by time slices, and a kernel spinning on
// a peer's flag could stall for a whole slice.  In-kernel flags and
// overlap of the copy with the FFT are later work.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

// kPull: forward (gather from the peers, write locally); else inverse
// (read locally, scatter to the peers).  Per plane, a peer's buffer is
// (outer, n/P, P*inner) and the local side (outer, n, inner).
template <bool kPull, bool kMixed>
__global__ void __launch_bounds__(1024)
peer_fft_kernel(float* const* __restrict__ peers,
                const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, Plan plan, int n, int nloc,
                long long inner, int P, int my, int T, long long tiles,
                long long plane, float sign, float scale) {
  extern __shared__ float2 s[];
  const long long o = blockIdx.x / tiles;
  const long long q0 = (blockIdx.x % tiles) * T;
  const long long local = o * n * inner + q0;
  const long long wrow = P * inner;  // a peer's row: P ranks' columns
  const int elems = n * T;
  // the peer-side offset of (outer o, row rr, column my*inner + q0)
  auto peer_off = [&](int rr) {
    return (o * nloc + rr) * wrow + my * inner + q0;
  };
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int col = e % T;
    float2 v = make_float2(0.f, 0.f);
    if (q0 + col < inner) {
      if (kPull) {
        const float* src = peers[r / nloc] + peer_off(r % nloc) + col;
        v = make_float2(src[0], src[plane]);
      } else {
        const long long g = local + static_cast<long long>(r) * inner + col;
        v = make_float2(xr[g], xi[g]);
      }
    }
    s[r * T + col] = v;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n, T, T, plan, tw, sign);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int col = e % T;
    if (q0 + col < inner) {
      const float2 v = s[r * T + col];
      if (kPull) {
        const long long g = local + static_cast<long long>(r) * inner + col;
        yr[g] = v.x * scale;
        yi[g] = v.y * scale;
      } else {
        float* dst = peers[r / nloc] + peer_off(r % nloc) + col;
        dst[0] = v.x * scale;
        dst[plane] = v.y * scale;
      }
    }
  }
}

// One launch of the kernel over `outer` x (n, inner) blocks.
template <bool kPull>
int launch(float* const* peers, const float* xr, const float* xi, float* yr,
           float* yi, const void* tw, int n, long long outer,
           long long inner, int P, int my, void* stream) {
  const Plan plan = fftblock::make_plan(n);
  if (plan.nst == 0 || P < 1 || n % P || my < 0 || my >= P || inner < 1 ||
      outer < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tmax = n <= 512 ? 32 : 16;
  const long long tiles = (inner + tmax - 1) / tmax;
  const int T = static_cast<int>((inner + tiles - 1) / tiles);
  const long long blocks = tiles * outer;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::launch_kernel(
      fftblock::mixed_plan(plan) ? peer_fft_kernel<kPull, true>
                                 : peer_fft_kernel<kPull, false>,
      static_cast<unsigned>(blocks), fftblock::threads_for(n * T),
      static_cast<size_t>(n) * T * sizeof(float2),
      static_cast<cudaStream_t>(stream), peers, xr, xi, yr, yi,
      static_cast<const float2*>(tw), plan, n, n / P, inner, P, my, T, tiles,
      outer * (n / P) * P * inner, kPull ? -1.f : 1.f,
      kPull ? 1.f : 1.f / static_cast<float>(n));
}

}  // namespace

// Row 24.  peers: device table of P float* (each rank's symmetric buffer,
// (2, comps, n0/P, n1, h)); yr, yi: this rank's output, each
// (comps, n0, n1/P, h); tw: n0 float2, exp(-2*pi*i*m/n0).  Any
// 2 <= n0 <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int peer_fft_x_pull_launch(float* const* peers, float* yr,
                                      float* yi, const void* tw, int n0,
                                      int n1, int h, int P, int my, int comps,
                                      void* stream) {
  if (P < 1 || n1 % P) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(peers, nullptr, nullptr, yr, yi, tw, n0, comps,
                      static_cast<long long>(n1 / P) * h, P, my, stream);
}

// Row 25.  xr, xi: this rank's spectrum, each (comps, n0, n1/P, h); the
// inverse x c2c (scaled 1/n0) lands in every peer's symmetric buffer;
// tw: n0 float2, exp(+2*pi*i*m/n0).
extern "C" int peer_ifft_x_push_launch(float* const* peers, const float* xr,
                                       const float* xi, const void* tw,
                                       int n0, int n1, int h, int P, int my,
                                       int comps, void* stream) {
  if (P < 1 || n1 % P) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(peers, xr, xi, nullptr, nullptr, tw, n0, comps,
                       static_cast<long long>(n1 / P) * h, P, my, stream);
}

// Row 26.  peers: device table of P float* (each rank's symmetric buffer,
// (2, rows, n1/P, w), w = P * w2 lanes; rows = C * n0); yr, yi: this rank's
// output, each (rows, n1, w2); tw: n1 float2, exp(-2*pi*i*m/n1).  Any
// 2 <= n1 <= 1024.
extern "C" int peer_fft_y_pull_launch(float* const* peers, float* yr,
                                      float* yi, const void* tw, int n1,
                                      int w, int P, int my, int rows,
                                      void* stream) {
  if (P < 1 || w % P) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(peers, nullptr, nullptr, yr, yi, tw, n1, rows, w / P,
                      P, my, stream);
}

// Row 27.  xr, xi: this rank's spectrum, each (rows, n1, w2); the inverse y
// c2c (scaled 1/n1) lands in every peer's symmetric buffer (2, rows, n1/P,
// w) at lanes my * w2 ...; tw: n1 float2, exp(+2*pi*i*m/n1).
extern "C" int peer_ifft_y_push_launch(float* const* peers, const float* xr,
                                       const float* xi, const void* tw,
                                       int n1, int w, int P, int my,
                                       int rows, void* stream) {
  if (P < 1 || w % P) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(peers, xr, xi, nullptr, nullptr, tw, n1, rows, w / P,
                       P, my, stream);
}
