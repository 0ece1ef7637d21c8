// Pieces shared by the link-load kernels (cascade_tiered.cu,
// cascade_flat.cu, linkload.cu).  Link vectors live in shared memory:
// L1 = L + 1 entries in the cascades, slot L the sentinel (capacity 1e30)
// onto which absent hops land.  One simulation spreads over the C CTAs of
// a thread-block cluster, each with its own partial link load, summed over
// the cluster through distributed shared memory; the host side below
// configures, sizes and launches such clusters.
//
// The cascades sum link loads in integer fixed point, so that a sum does
// not depend on the order in which threads add to it: each rate is
// rounded to a multiple of 1/64 bps (kUnitsPerBps), the partials are
// unsigned 64-bit integers added with shared-memory atomics (an integer
// sum is associative, so it is exact in any order), and the sum over the
// cluster is converted to float once, in cluster_scale_pass.  Rates of
// 131 kbps and above are multiples of 1/64 in float32 already and enter
// exactly.  Overflow bound: a link's load is at most the sum of all
// sub-flow rates of a simulation, so n sub-flows of at most
// kernels/cascade_common.py::RATE_BOUND_BPS (400 Gb/s, four times the
// paper's line rate) stay below 2^63 units while n * 4e11 * 64 < 2^63,
// i.e. n <= 360,287; the dense engine's shape (W = 56,116, N = 4: 224,464
// sub-flows) fits.  The wrappers check n against that bound
// (cascade_common.py::check_fixed_point).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cascade {

__device__ __forceinline__ void zero(float* buf, int L1) {
  for (int l = threadIdx.x; l < L1; l += blockDim.x) buf[l] = 0.0f;
}

// Fixed-point link loads: units of 1/64 bps in an unsigned 64-bit integer
// (two's complement, so a sum of signed values wraps back correctly).
typedef unsigned long long fixed_t;
constexpr float kUnitsPerBps = 64.0f;
constexpr float kBpsPerUnit = 1.0f / 64.0f;

__device__ __forceinline__ fixed_t to_fixed(float bps) {
  return (fixed_t)__float2ll_rn(bps * kUnitsPerBps);
}

__device__ __forceinline__ void zero(fixed_t* buf, int L1) {
  for (int l = threadIdx.x; l < L1; l += blockDim.x) buf[l] = 0ull;
}

// A link id of the sentinel layout: absent (-1) hops land on slot L1 - 1.
__device__ __forceinline__ int slot(int lid, int L1) { return lid < 0 ? L1 - 1 : lid; }

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
    float kmin, float kmax, float pmax, float dt, float qmax, int rank, int C) {
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
// scattered its own flows into its fixed-point `partial`; on exit `scale`
// holds min(1, cap / max(load, 1)), `arr` has the load added (sentinel
// excluded), both bit-identical in every CTA and from run to run (the
// integer sum of the C partials is exact, and is converted to float once),
// and `partial` is zero again.  Two cluster barriers: the partials
// complete before anyone reads them, and read by everyone before they are
// zeroed for the next pass.
__device__ __forceinline__ void cluster_scale_pass(cooperative_groups::cluster_group& cluster,
                                                   int C, fixed_t* partial, float* scale,
                                                   float* arr, const float* cap, int L1) {
  cluster.sync();
  for (int l = threadIdx.x; l < L1; l += blockDim.x) {
    fixed_t sum = 0ull;
    for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(partial, r)[l];
    float v = __ll2float_rn((long long)sum) * kBpsPerUnit;
    if (l < L1 - 1) arr[l] += v;
    scale[l] = fminf(1.0f, cap[l] / fmaxf(v, 1.0f));
  }
  cluster.sync();
  zero(partial, L1);
  __syncthreads();
}

// One hop h of a cascade over the cluster: the CTA's sub-flows [i_lo, i_hi)
// of link ids lid [., H] scatter their running rates thr, in fixed point,
// into its partial,
// cluster_scale_pass sums the partials, and each rate takes its link's
// scale.  thr entries are read and written only by the CTA that owns them,
// and each thread rereads only those it wrote.
__device__ __forceinline__ void cluster_hop_pass(
    cooperative_groups::cluster_group& cluster, int C, const int32_t* __restrict__ lid,
    int H, int h, float* __restrict__ thr, int i_lo, int i_hi, fixed_t* partial,
    float* scale, float* arr, const float* cap, int L1) {
  for (int i = i_lo + threadIdx.x; i < i_hi; i += blockDim.x)
    atomicAdd(&partial[slot(lid[i * H + h], L1)], to_fixed(thr[i]));
  cluster_scale_pass(cluster, C, partial, scale, arr, cap, L1);
  for (int i = i_lo + threadIdx.x; i < i_hi; i += blockDim.x)
    thr[i] *= scale[slot(lid[i * H + h], L1)];
}

// ---- host side: launches on clusters of 1 <= C <= kMaxCluster CTAs (above
// 8 only where the card admits a non-portable cluster size)

constexpr int kMaxCluster = 16;

// Allow `smem` bytes of dynamic shared memory and, above 8, a non-portable
// cluster size; returns 0 or a CUDA error.
template <typename Kernel>
inline int configure(Kernel kernel, int C, size_t smem) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A grid of `clusters` clusters of C CTAs of `threads` threads.
inline cudaLaunchConfig_t cluster_config(int clusters, int C, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of C CTAs the card can hold at once, into *count;
// returns 0 or a CUDA error.  0 clusters means that a launch of that size
// cannot be scheduled.
template <typename Kernel>
inline int max_clusters(Kernel kernel, int C, int threads, size_t smem, int* count) {
  int err = configure(kernel, C, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, C, threads, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// Launch `kernel` on `clusters` clusters of C CTAs; returns 0 or a CUDA
// error (a cluster that does not schedule is one: nothing falls back).
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kernel)(Params...), int clusters, int C, int threads,
                           size_t smem, void* stream, Args... args) {
  int err = configure(kernel, C, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(clusters, C, threads, smem, (cudaStream_t)stream,
                                          attr);
  cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace cascade
