// Tiled all-to-all over peer memory: a strided block copy, push form.
//
// Replaces the Pallas kernel mpifft4py_tpu/parallel/rdma.py:
// rdma_all_to_all (_a2a_kernel), row 23, whose every device posts P
// remote DMAs over ICI, block d of its input to slot `my` of device d's
// output, with the layout of lax.all_to_all(split_axis, concat_axis,
// tiled=True).  Here each rank owns a *symmetric buffer* (the output,
// float32) whose address every peer holds, through CUDA IPC, in a device
// table of P base pointers; this kernel reads this rank's input once and
// stores block d straight into peer d's buffer, at slot `my` of the
// concat axis.
//
// The input is viewed in five dimensions (outer, A, mid, B, inner) where A
// and B are the split and the concat axis in their order (split_first
// says which comes first); the output of every rank has the split axis
// cut to ns/P and the concat axis grown to nc*P.  Whichever of the two
// axes comes second, its elements of one block travel together with
// `inner`: nc*inner floats (split first) or (ns/P)*inner floats (concat
// first) are contiguous both in the input and in the destination.  A
// block of threads copies one such run at a time, so the index arithmetic
// is paid once a run, and reads and writes are coalesced.
//
// Bound: bytes, 8 a float32 element (one read, one write).  The host
// orders the ranks (a stream synchronise and a group barrier before the
// launch and after it), so the kernel never waits on another process:
// ranks that share one card run by time slices.  Overlap with compute is
// later work.
#include <cuda_runtime.h>

namespace {

__global__ void peer_a2a_kernel(const float* __restrict__ x,
                                float* const* __restrict__ peers,
                                long long dst_off, int P, int my,
                                long long outer, long long ns, long long mid,
                                long long nc, long long inner,
                                int split_first) {
  const long long b = ns / P;
  const long long run = (split_first ? nc : b) * inner;
  const long long nruns = outer * ns * mid * nc * inner / run;
  for (long long r = blockIdx.x; r < nruns; r += gridDim.x) {
    long long src, dst;
    int d;
    if (split_first) {
      // r = (o, is, m); the run is (ic, i) of split index is
      const long long m = r % mid;
      const long long is = (r / mid) % ns;
      const long long o = r / (mid * ns);
      d = static_cast<int>(is / b);
      src = r * run;
      dst = (((o * b + is % b) * mid + m) * (nc * P) +
             static_cast<long long>(my) * nc) * inner;
    } else {
      // r = (o, ic, m, d); the run is block d of the split axis with i
      d = static_cast<int>(r % P);
      const long long t = r / P;            // (o, ic, m)
      const long long m = t % mid;
      const long long ic = (t / mid) % nc;
      const long long o = t / (mid * nc);
      src = (t * ns + d * b) * inner;
      dst = ((o * (nc * P) + static_cast<long long>(my) * nc + ic) * mid +
             m) * b * inner;
    }
    float* out = peers[d] + dst_off + dst;
    const float* in = x + src;
    for (long long e = threadIdx.x; e < run; e += blockDim.x) out[e] = in[e];
  }
}

}  // namespace

// x: this rank's input (outer, ., mid, ., inner) with the split axis of
// length ns (a multiple of P) and the concat axis of length nc; peers:
// device table of P float*, each rank's output buffer, written at element
// dst_off + (the tiled all-to-all's index).  Returns cudaGetLastError().
extern "C" int peer_a2a_launch(const float* x, float* const* peers,
                               long long dst_off, int P, int my,
                               long long outer, long long ns, long long mid,
                               long long nc, long long inner,
                               int split_first, void* stream) {
  if (P < 1 || my < 0 || my >= P || ns % P || outer < 1 || ns < 1 ||
      mid < 1 || nc < 1 || inner < 1 || dst_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long run = (split_first ? nc : ns / P) * inner;
  long long blocks = outer * ns * mid * nc * inner / run;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  peer_a2a_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, peers, dst_off, P, my, outer, ns, mid, nc, inner, split_first);
  return static_cast<int>(cudaGetLastError());
}
