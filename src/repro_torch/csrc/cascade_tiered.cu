// NIC-tiered hop cascade of the fluid dataplane, one simulation per
// thread-block cluster of C CTAs.
//
// Replaces the TPU kernel kernels/linkload.py::linkload_cascade_tiered
// (Pallas body _cascade_tiered_kernel) of the JAX package.  Plain version:
// repro_torch/kernels/cascade_tiered.py::cascade_tiered_torch.
//
// What it computes, per simulation b (rates in bps, links in the sentinel
// layout: L real links plus slot L, capacity 1e30, for absent hops):
//   host_tx  load[l] = sum over flows w with tx[w] == l of sum_n rate[w, n]
//            scale = min(1, cap / max(load, 1));  r[w, n] = rate * scale[tx[w]]
//   fabric   for h < Hf: load[l] = sum over sub-flows on fab[w, n, h];
//            r[w, n] *= scale[fab[w, n, h]]
//   host_rx  load[l] = sum over flows w with rx[w] == l of sum_n r[w, n];
//            thr[w, n] = r[w, n] * scale[rx[w]]
//   arrival  = the sum of the hop loads (0 on the sentinel)
//   queue    = clip(q + (arrival - cap) * dt / 8, 0, qmax) * mask
//   mark     = RED ramp on the new queue (0 on the sentinel)
//
// What bounds it on an H100: each hop's scale needs that hop's complete
// link load, so the Hf + 2 passes are serial, and the work per pass is a
// scatter-add of W*N floats onto a few hundred links.  The bytes are small
// (about 0.3 MB per simulation at W = 5376, N = 4, Hf = 2), so the memory
// bound is well under a microsecond; the kernel is bound by the latency of
// each pass's scatter on the SMs it occupies and by the barriers between
// passes.  With one CTA per simulation a B = 2 sweep batch ran on 2 of 132
// SMs and the dense engine's one simulation of 224k sub-flows on 1, where
// the plain index_add_ (spread over every SM) beat it.
//
// What the design does about it: the TPU kernel's one-hot matrix products
// are a device of the TPU's matrix unit and are not carried over.  One
// simulation spreads over a cluster of C CTAs (kernels/cascade_common.py::
// cluster_size balances the sub-flows each CTA scatters against the C
// partial link vectors each sums, up to the non-portable size 16: the
// fig12 batch of 21,504 sub-flows a simulation on 449 link slots gets 16,
// as does the dense shape), so a B = 2 batch occupies 32 SMs.  CTA r owns
// flows [r W / C, (r + 1) W / C) and their thr entries (the running rates,
// updated in place each pass, read and written by that CTA only).  Per
// pass each CTA scatters its flows into its own shared-memory partial link
// load with shared atomics on 64-bit integers (fixed point, 1/64 bps a
// unit: cascade_common.cuh); then cascade_common.cuh::cluster_scale_pass
// sums the C partials through distributed shared memory between two
// cluster barriers and converts the sum to float once, so every CTA
// derives the same scales and running arrival bit for bit, and applies
// them to its own flows (a fabric hop is cascade_common.cuh::
// cluster_hop_pass, which the flat kernel shares).  The queue and mark of
// link l are written by CTA l mod C.  An integer sum does not depend on
// the order of its additions, so a launch repeats bit for bit; results
// agree with the plain version (float index_add_) to float round-off.  A
// cluster that does not schedule is a launch error: nothing falls back to
// fewer CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cascade::fixed_t;
using cascade::zero;

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) cascade_tiered_kernel(
    const int32_t* __restrict__ fab,    // [B, W, N, Hf]
    const int32_t* __restrict__ tx,     // [B, W]
    const int32_t* __restrict__ rx,     // [B, W]
    const float* __restrict__ rates,    // [B, W, N]
    const float* __restrict__ queue,    // [B, L1]
    const float* __restrict__ cap,      // [L1]
    const float* __restrict__ qmask,    // [L1]
    float* __restrict__ arrival,        // [B, L1]
    float* __restrict__ new_queue,      // [B, L1]
    float* __restrict__ p_mark,         // [B, L1]
    float* __restrict__ thr,            // [B, W, N]
    int W, int N, int Hf, int L1, int C,
    float kmin, float kmax, float pmax, float dt, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [L1] this CTA's share of the pass's link load, in fixed point
  fixed_t* partial = reinterpret_cast<fixed_t*>(smem);
  float* scale = reinterpret_cast<float*>(partial + L1);  // [L1] the same in every CTA
  float* arr = scale + L1;        // [L1] running arrival, the same in every CTA
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  fab += (size_t)b * W * N * Hf;
  tx += (size_t)b * W;
  rx += (size_t)b * W;
  rates += (size_t)b * W * N;
  thr += (size_t)b * W * N;
  queue += (size_t)b * L1;
  arrival += (size_t)b * L1;
  new_queue += (size_t)b * L1;
  p_mark += (size_t)b * L1;
  int w_lo, w_hi;
  cascade::share(W, rank, C, &w_lo, &w_hi);
  const int i_lo = w_lo * N, i_hi = w_hi * N;  // this CTA's sub-flows

  zero(partial, L1);
  zero(arr, L1);
  __syncthreads();

  // ---- host_tx: pre-reduced over the N sub-flows of a flow
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += rates[w * N + n];
    atomicAdd(&partial[tx[w]], cascade::to_fixed(s));
  }
  cascade::cluster_scale_pass(cluster, C, partial, scale, arr, cap, L1);
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float sc = scale[tx[w]];
    for (int n = 0; n < N; ++n) thr[w * N + n] = rates[w * N + n] * sc;
  }
  __syncthreads();

  // ---- fabric hops, per sub-flow
  for (int h = 0; h < Hf; ++h)
    cascade::cluster_hop_pass(cluster, C, fab, Hf, h, thr, i_lo, i_hi, partial, scale, arr,
                              cap, L1);
  __syncthreads();

  // ---- host_rx: pre-reduced again
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += thr[w * N + n];
    atomicAdd(&partial[rx[w]], cascade::to_fixed(s));
  }
  cascade::cluster_scale_pass(cluster, C, partial, scale, arr, cap, L1);
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float sc = scale[rx[w]];
    for (int n = 0; n < N; ++n) thr[w * N + n] *= sc;
  }

  // ---- queue integration and RED mark (arr is final since the rx pass)
  cascade::finish_links(arr, queue, cap, qmask, arrival, new_queue, p_mark, L1,
                        kmin, kmax, pmax, dt, qmax, rank, C);
}

size_t smem_bytes(int L1) { return (size_t)L1 * (sizeof(fixed_t) + 2 * sizeof(float)); }

}  // namespace

// How many clusters of C CTAs (with L1 links each) the card can hold at
// once, into *count; returns 0 or a CUDA error.
extern "C" int cascade_tiered_max_clusters(int C, int L1, int* count) {
  return cascade::max_clusters(cascade_tiered_kernel, C, kThreads, smem_bytes(L1), count);
}

// B simulations on a grid of B * C CTAs in clusters of C.
extern "C" int cascade_tiered_launch(
    const void* fab, const void* tx, const void* rx, const void* rates,
    const void* queue, const void* cap, const void* qmask,
    void* arrival, void* new_queue, void* p_mark, void* thr,
    int B, int W, int N, int Hf, int L1, int C,
    float kmin, float kmax, float pmax, float dt, float qmax,
    void* stream) {
  return cascade::launch_clusters(
      cascade_tiered_kernel, B, C, kThreads, smem_bytes(L1), stream,
      (const int32_t*)fab, (const int32_t*)tx, (const int32_t*)rx, (const float*)rates,
      (const float*)queue, (const float*)cap, (const float*)qmask,
      (float*)arrival, (float*)new_queue, (float*)p_mark, (float*)thr,
      W, N, Hf, L1, C, kmin, kmax, pmax, dt, qmax);
}
