// Pieces shared by the hop-cascade kernels (cascade_tiered.cu,
// cascade_flat.cu).  Block level: one CTA owns one simulation; `load` and
// `arr` are shared-memory link vectors of L1 = L + 1 floats, slot L the
// sentinel (capacity 1e30) onto which absent hops land.  Cluster level
// (the tiered kernel): one simulation spread over the C CTAs of a
// thread-block cluster, each with its own partial link load, summed over
// the cluster through distributed shared memory.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace cascade {

__device__ __forceinline__ void zero(float* buf, int L1) {
  for (int l = threadIdx.x; l < L1; l += blockDim.x) buf[l] = 0.0f;
}

// A link id of the sentinel layout: absent (-1) hops land on slot L1 - 1.
__device__ __forceinline__ int slot(int lid, int L1) { return lid < 0 ? L1 - 1 : lid; }

// load -> arrival += load (sentinel excluded); load <- min(1, cap / max(load, 1))
__device__ __forceinline__ void scale_pass(float* load, float* arr, const float* cap,
                                           int L1) {
  for (int l = threadIdx.x; l < L1; l += blockDim.x) {
    float v = load[l];
    if (l < L1 - 1) arr[l] += v;
    load[l] = fminf(1.0f, cap[l] / fmaxf(v, 1.0f));
  }
}

// RED/ECN ramp on the queue bytes.
__device__ __forceinline__ float red_mark(float q, float kmin, float kmax, float pmax) {
  float ramp = (q - kmin) / (kmax - kmin);
  return q < kmin ? 0.0f : (q > kmax ? 1.0f : ramp * pmax);
}

// Queue integration and RED mark from the final arrival vector `arr`;
// writes arrival, new_queue and p_mark (0 on the sentinel).
__device__ __forceinline__ void finish_links(
    const float* arr, const float* queue, const float* cap, const float* qmask,
    float* arrival, float* new_queue, float* p_mark, int L1,
    float kmin, float kmax, float pmax, float dt, float qmax, int rank = 0, int C = 1) {
  // CTA `rank` of a cluster of C writes the links l = rank (mod C)
  for (int l = rank + C * threadIdx.x; l < L1; l += C * blockDim.x) {
    float a = arr[l];
    float q = queue[l] + (a - cap[l]) * dt / 8.0f;
    q = fminf(fmaxf(q, 0.0f), qmax) * qmask[l];
    arrival[l] = a;
    new_queue[l] = q;
    p_mark[l] = l == L1 - 1 ? 0.0f : red_mark(q, kmin, kmax, pmax);
  }
}

// ---- one simulation over a cluster of C CTAs

// The share [lo, hi) of n items that CTA `rank` of a cluster of C owns
// (empty when n < C for some ranks).
__device__ __forceinline__ void share(int n, int rank, int C, int* lo, int* hi) {
  *lo = (int)((long long)n * rank / C);
  *hi = (int)((long long)n * (rank + 1) / C);
}

// One pass's link load summed over the cluster.  On entry every CTA has
// scattered its own flows into its `partial`; on exit `scale` holds
// min(1, cap / max(load, 1)), `arr` has the load added (sentinel
// excluded), both bit-identical in every CTA because each sums the C
// partials in rank order 0..C-1, and `partial` is zero again.  Two cluster
// barriers: the partials complete before anyone reads them, and read by
// everyone before they are zeroed for the next pass.
__device__ __forceinline__ void cluster_scale_pass(cooperative_groups::cluster_group& cluster,
                                                   int C, float* partial, float* scale,
                                                   float* arr, const float* cap, int L1) {
  cluster.sync();
  for (int l = threadIdx.x; l < L1; l += blockDim.x) {
    float v = 0.0f;
    for (int r = 0; r < C; ++r) v += cluster.map_shared_rank(partial, r)[l];
    if (l < L1 - 1) arr[l] += v;
    scale[l] = fminf(1.0f, cap[l] / fmaxf(v, 1.0f));
  }
  cluster.sync();
  zero(partial, L1);
  __syncthreads();
}

}  // namespace cascade
