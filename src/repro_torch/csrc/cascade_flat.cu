// Flat hop cascade of the fluid dataplane (the oracle layout), one
// simulation per thread-block cluster of C CTAs.
//
// Replaces the TPU kernel kernels/linkload.py::linkload_cascade (Pallas
// body _cascade_kernel) of the JAX package.  Plain version:
// repro_torch/kernels/linkload.py::linkload_cascade_torch.
//
// What it computes, per simulation b (rates in bps, links in the sentinel
// layout: L real links plus slot L, capacity 1e30, for absent hops):
//   for h < H: load[l] = sum of r[i] over sub-flows i with lid[i, h] == l
//              scale = min(1, cap / max(load, 1));  r[i] *= scale[lid[i, h]]
//   thr      = r after the last hop
//   arrival  = the sum of the hop loads (0 on the sentinel)
//   queue    = clip(q + (arrival - cap) * dt / 8, 0, qmax) * mask
//   mark     = RED ramp on the new queue (0 on the sentinel)
//
// What bounds it on an H100: each hop's scale needs that hop's complete
// link load, so the H passes are serial, each a scatter-add of n floats
// onto a few hundred links.  The bytes are small (about 0.5 MB per
// simulation at n = 21,504, H = 4; 4.5 MB at the dense engine's 224,464
// sub-flows), so the memory bound is a microsecond or less; the kernel is
// bound by the latency of each pass's scatter on the SMs it occupies and
// by the barriers between passes.  With one CTA per simulation a B = 2
// batch ran on 2 of 132 SMs, and at the dense shape the plain index_add_
// (spread over every SM) beat it.
//
// What the design does about it: the tiered kernel's cluster, without the
// NIC pre-reduction.  One simulation spreads over a cluster of C CTAs
// (kernels/cascade_common.py::cluster_size(n, 1, L + 1): 16 at the fig12
// batch and the dense shape).  CTA r owns sub-flows [r n / C, (r + 1) n / C)
// and their thr entries (the running rates, updated in place each pass,
// read and written by that CTA only).  Each hop is
// cascade_common.cuh::cluster_hop_pass, the tiered kernel's fabric hop:
// each CTA scatters its sub-flows into its own shared-memory partial link
// load with 64-bit integer atomics (fixed point, cascade_common.cuh), the C
// partials are summed through distributed shared memory between two
// cluster barriers and converted to float once (so every CTA derives the
// same scales and running arrival bit for bit, run after run), and each
// CTA scales its own sub-flows.  The queue and mark of link l are written
// by CTA l mod C.  A cluster that does not schedule is a launch error:
// nothing falls back to fewer CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cascade::fixed_t;
using cascade::zero;

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) cascade_flat_kernel(
    const int32_t* __restrict__ lid,    // [B, n, H]
    const float* __restrict__ rates,    // [B, n]
    const float* __restrict__ queue,    // [B, L1]
    const float* __restrict__ cap,      // [L1]
    const float* __restrict__ qmask,    // [L1]
    float* __restrict__ arrival,        // [B, L1]
    float* __restrict__ new_queue,      // [B, L1]
    float* __restrict__ p_mark,         // [B, L1]
    float* __restrict__ thr,            // [B, n]
    int n, int H, int L1, int C,
    float kmin, float kmax, float pmax, float dt, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [L1] this CTA's share of the pass's link load, in fixed point
  fixed_t* partial = reinterpret_cast<fixed_t*>(smem);
  float* scale = reinterpret_cast<float*>(partial + L1);  // [L1] the same in every CTA
  float* arr = scale + L1;        // [L1] running arrival, the same in every CTA
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  lid += (size_t)b * n * H;
  rates += (size_t)b * n;
  thr += (size_t)b * n;
  queue += (size_t)b * L1;
  arrival += (size_t)b * L1;
  new_queue += (size_t)b * L1;
  p_mark += (size_t)b * L1;
  int i_lo, i_hi;  // this CTA's sub-flows
  cascade::share(n, rank, C, &i_lo, &i_hi);

  zero(partial, L1);
  zero(arr, L1);
  for (int i = i_lo + threadIdx.x; i < i_hi; i += blockDim.x) thr[i] = rates[i];
  __syncthreads();
  for (int h = 0; h < H; ++h)
    cascade::cluster_hop_pass(cluster, C, lid, H, h, thr, i_lo, i_hi, partial, scale, arr,
                              cap, L1);
  // arr is final since the last pass, whose second cluster barrier also
  // keeps every CTA's partial alive until the others have read it
  cascade::finish_links(arr, queue, cap, qmask, arrival, new_queue, p_mark, L1,
                        kmin, kmax, pmax, dt, qmax, rank, C);
}

size_t smem_bytes(int L1) { return (size_t)L1 * (sizeof(fixed_t) + 2 * sizeof(float)); }

}  // namespace

// How many clusters of C CTAs (with L1 links each) the card can hold at
// once, into *count; returns 0 or a CUDA error.
extern "C" int cascade_flat_max_clusters(int C, int L1, int* count) {
  return cascade::max_clusters(cascade_flat_kernel, C, kThreads, smem_bytes(L1), count);
}

// B simulations on a grid of B * C CTAs in clusters of C.
extern "C" int cascade_flat_launch(
    const void* lid, const void* rates, const void* queue, const void* cap,
    const void* qmask, void* arrival, void* new_queue, void* p_mark, void* thr,
    int B, int n, int H, int L1, int C,
    float kmin, float kmax, float pmax, float dt, float qmax,
    void* stream) {
  return cascade::launch_clusters(
      cascade_flat_kernel, B, C, kThreads, smem_bytes(L1), stream,
      (const int32_t*)lid, (const float*)rates, (const float*)queue, (const float*)cap,
      (const float*)qmask, (float*)arrival, (float*)new_queue, (float*)p_mark,
      (float*)thr, n, H, L1, C, kmin, kmax, pmax, dt, qmax);
}
