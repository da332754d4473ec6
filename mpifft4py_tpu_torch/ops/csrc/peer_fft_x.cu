// The slab transpose fused with the x-axis c2c FFT, over peer memory.
//
// Replaces the Pallas kernels of mpifft4py_tpu/parallel/rdma.py:
// - fused_transpose_fft_x (_fused_kernel), row 24: the all-to-all's
//   receive (split axis 1 -> concat axis 0) with the forward x c2c;
// - fused_ifft_x_transpose (_fused_inv_kernel), row 25: the inverse x c2c
//   (1/N0 folded in) with the all-to-all's send (split 0 -> concat 1).
// On the TPU each is one kernel that posts per-peer remote DMAs over ICI
// and overlaps chunk c+1's copies with chunk c's MXU matmuls.  Here every
// rank of the slab group owns a *symmetric buffer*: a float32 tensor
// (2, C, Np0, N1, h) (re plane, then im plane; C stacked components)
// whose address every peer holds, through CUDA IPC, in a device table of
// P base pointers.  The pair lives in the buffer between the zy stage and
// the x stage:
// - forward (pull): the zy stage writes its pair into this rank's buffer;
//   a block of this kernel takes T consecutive (k1, lane) columns of this
//   rank's Np1 slab of one component and gathers their N0 x-points, Np0
//   rows from each peer d (rows d*Np0 ...), into shared memory, runs the
//   x c2c there with fft_block.cuh's plan and writes the local output
//   (C, N0, Np1, h);
// - inverse (push): a block loads T local columns (N0 points each), runs
//   the inverse x c2c and stores rows d*Np0 ... into peer d's buffer at
//   k1 = my*Np1 ...: the layout lax.all_to_all(tiled=True) gives.
// A column's N0 points lie at one address in each of Np0 rows of a peer,
// so the T columns of a block read and write T consecutive floats of each
// row, in full sectors, as fft_axis.cu does.  On one card the peers' buffers
// are in the same HBM; across cards the same loads and stores go over
// NVLink through the IPC mappings.
//
// Bound: bytes.  Each point is read once and written once (16 bytes a
// complex point), 5 N0 log2 N0 flops a column: ~3 flops a byte at N0 =
// 256, far below the card's FP32 rate.  The design moves each byte once,
// like the plain x stage; the host orders the ranks (the zy stage, a
// stream synchronise and a group barrier before the launch; a synchronise
// and a barrier after), so nothing in the kernel waits on another process:
// ranks that share one card run by time slices, and a kernel spinning on a
// peer's flag could stall for a whole slice.  In-kernel flags and overlap
// of the copy with the FFT are later work.
#include <cuda_runtime.h>

#include "fft_block.cuh"

using fftblock::Plan;

namespace {

// kPull: forward (gather from the peers, write locally); else inverse
// (read locally, scatter to the peers).
template <bool kPull, bool kMixed>
__global__ void __launch_bounds__(1024)
peer_fft_x_kernel(float* const* __restrict__ peers,
                  const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi,
                  const float2* __restrict__ tw, Plan plan, int n0, int np0,
                  int n1, int np1, int h, int my, int comps, int T,
                  long long tiles, float sign, float scale) {
  extern __shared__ float2 s[];
  const long long post = static_cast<long long>(np1) * h;  // local columns
  const long long plane = static_cast<long long>(comps) * np0 * n1 * h;
  const int c = static_cast<int>(blockIdx.x / tiles);
  const long long q0 = (blockIdx.x % tiles) * T;
  const long long local = static_cast<long long>(c) * n0 * post + q0;
  const int elems = n0 * T;
  // the peer-side offset of (component c, row rr, k1 = my*np1, column q0)
  auto peer_off = [&](int rr) {
    return ((static_cast<long long>(c) * np0 + rr) * n1 +
            static_cast<long long>(my) * np1) * h + q0;
  };
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int col = e % T;
    float2 v = make_float2(0.f, 0.f);
    if (q0 + col < post) {
      if (kPull) {
        const float* src = peers[r / np0] + peer_off(r % np0) + col;
        v = make_float2(src[0], src[plane]);
      } else {
        const long long g = local + static_cast<long long>(r) * post + col;
        v = make_float2(xr[g], xi[g]);
      }
    }
    s[r * T + col] = v;
  }
  __syncthreads();
  fftblock::block_fft<kMixed>(s, n0, T, T, plan, tw, sign);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int r = e / T;
    const int col = e % T;
    if (q0 + col < post) {
      const float2 v = s[r * T + col];
      if (kPull) {
        const long long g = local + static_cast<long long>(r) * post + col;
        yr[g] = v.x * scale;
        yi[g] = v.y * scale;
      } else {
        float* dst = peers[r / np0] + peer_off(r % np0) + col;
        dst[0] = v.x * scale;
        dst[plane] = v.y * scale;
      }
    }
  }
}

template <bool kPull>
int launch(float* const* peers, const float* xr, const float* xi, float* yr,
           float* yi, const void* tw, int n0, int n1, int h, int P, int my,
           int comps, void* stream) {
  const Plan plan = fftblock::make_plan(n0);
  if (plan.nst == 0 || P < 1 || n0 % P || n1 % P || my < 0 || my >= P ||
      h < 1 || comps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np0 = n0 / P;
  const int np1 = n1 / P;
  const int T = n0 <= 512 ? 32 : 16;
  const long long post = static_cast<long long>(np1) * h;
  const long long tiles = (post + T - 1) / T;
  const long long blocks = tiles * comps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return fftblock::launch_kernel(
      fftblock::mixed_plan(plan) ? peer_fft_x_kernel<kPull, true>
                                 : peer_fft_x_kernel<kPull, false>,
      static_cast<unsigned>(blocks), fftblock::threads_for(n0 * T),
      static_cast<size_t>(n0) * T * sizeof(float2),
      static_cast<cudaStream_t>(stream), peers, xr, xi, yr, yi,
      static_cast<const float2*>(tw), plan, n0, np0, n1, np1, h, my, comps,
      T, tiles, kPull ? -1.f : 1.f,
      kPull ? 1.f : 1.f / static_cast<float>(n0));
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
  return launch<true>(peers, nullptr, nullptr, yr, yi, tw, n0, n1, h, P, my,
                      comps, stream);
}

// Row 25.  xr, xi: this rank's spectrum, each (comps, n0, n1/P, h); the
// inverse x c2c (scaled 1/n0) lands in every peer's symmetric buffer;
// tw: n0 float2, exp(+2*pi*i*m/n0).
extern "C" int peer_ifft_x_push_launch(float* const* peers, const float* xr,
                                       const float* xi, const void* tw,
                                       int n0, int n1, int h, int P, int my,
                                       int comps, void* stream) {
  return launch<false>(peers, xr, xi, nullptr, nullptr, tw, n0, n1, h, P,
                       my, comps, stream);
}
