// One-pass switch dataplane step: offered load per link, queue update and
// RED/ECN mark, with no hop cascade and no queue mask, on one thread-block
// cluster of C CTAs.
//
// Replaces the TPU kernel kernels/linkload.py::linkload (Pallas body
// _linkload_kernel) of the JAX package.  Plain version:
// repro_torch/kernels/linkload.py::linkload_torch.
//
// What it computes (rates in bps, L links, no sentinel slot):
//   load[l]  = sum over (i, h) with lid[i, h] == l of rates[i]; ids outside
//              [0, L) (-1 for an absent hop, padding columns) are dropped
//   queue    = clip(q + (load - cap) * dt / 8, 0, 8e6)
//   mark     = RED ramp on the new queue
//
// What bounds it on an H100: the bytes are n * (hops + 1) * 4 in and
// 5 * L * 4 in and out (about 0.4 MB at n = 21,504, hops = 4, L = 448), so
// the memory bound is well under a microsecond; the scatter-add onto a few
// hundred links serialises on the same addresses, and on one CTA (one SM)
// it took tens of microseconds.
//
// What the design does about it: the TPU kernel's one-hot matrix product
// is a device of the TPU's matrix unit and is not carried over.  The rows
// spread over a cluster of C CTAs (kernels/cascade_common.py::
// cluster_size(n, hops, L): 16 at n = 21,504, hops = 4, L = 448).  CTA r
// takes rows [r n / C, (r + 1) n / C) and scatters each of their hops into
// its own shared-memory partial link load with shared atomics (a bounds
// check drops ids outside [0, L)).  The partials are fixed-point integers
// (cascade_common.cuh's fixed_t, 1/64 bps a unit), as in the cascades, so
// that the sum does not depend on the order of the atomics: two launches
// on the same inputs give bitwise-equal outputs.  After a cluster barrier
// CTA r sums the C partials through distributed shared memory for the
// links l = r (mod C), converts each sum to float once, and writes their
// load, queue and mark.  A second cluster barrier keeps every CTA, and so
// its partial, alive until all have read it.  A cluster that does not
// schedule is a launch error: nothing falls back to fewer CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr float kQmax = 8e6f;  // the JAX kernel's fixed queue cap

__global__ void __launch_bounds__(kThreads) linkload_kernel(
    const int32_t* __restrict__ lid,   // [n, hops]
    const float* __restrict__ rates,   // [n]
    const float* __restrict__ queue,   // [L]
    const float* __restrict__ cap,     // [L]
    float* __restrict__ load_out,      // [L]
    float* __restrict__ new_queue,     // [L]
    float* __restrict__ mark,          // [L]
    int n, int hops, int L, int C, float kmin, float kmax, float pmax, float dt) {
  extern __shared__ cascade::fixed_t partial[];  // [L] this CTA's share of the link load
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  int lo, hi;  // this CTA's rows
  cascade::share(n, rank, C, &lo, &hi);
  cascade::zero(partial, L);
  __syncthreads();
  for (int k = lo * hops + threadIdx.x; k < hi * hops; k += blockDim.x) {
    int id = lid[k];
    if (id >= 0 && id < L) atomicAdd(&partial[id], cascade::to_fixed(rates[k / hops]));
  }
  cluster.sync();  // every partial complete
  for (int l = rank + C * threadIdx.x; l < L; l += C * blockDim.x) {
    cascade::fixed_t sum = 0ull;
    for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(partial, r)[l];
    float a = __ll2float_rn((long long)sum) * cascade::kBpsPerUnit;
    float q = fminf(fmaxf(queue[l] + (a - cap[l]) * dt / 8.0f, 0.0f), kQmax);
    load_out[l] = a;
    new_queue[l] = q;
    mark[l] = cascade::red_mark(q, kmin, kmax, pmax);
  }
  cluster.sync();  // every partial read before any CTA retires
}

size_t smem_bytes(int L) { return (size_t)L * sizeof(cascade::fixed_t); }

}  // namespace

// How many clusters of C CTAs (with L links each) the card can hold at
// once, into *count; returns 0 or a CUDA error.
extern "C" int linkload_max_clusters(int C, int L, int* count) {
  return cascade::max_clusters(linkload_kernel, C, kThreads, smem_bytes(L), count);
}

// One cluster of C CTAs.
extern "C" int linkload_launch(
    const void* lid, const void* rates, const void* queue, const void* cap,
    void* load, void* new_queue, void* mark,
    int n, int hops, int L, int C, float kmin, float kmax, float pmax, float dt,
    void* stream) {
  return cascade::launch_clusters(
      linkload_kernel, 1, C, kThreads, smem_bytes(L), stream,
      (const int32_t*)lid, (const float*)rates, (const float*)queue, (const float*)cap,
      (float*)load, (float*)new_queue, (float*)mark, n, hops, L, C, kmin, kmax, pmax, dt);
}
