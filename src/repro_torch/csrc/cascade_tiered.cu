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
// simulation spreads over a cluster of C CTAs (kernels/cascade_tiered.py::
// cluster_size balances the sub-flows each CTA scatters against the C
// partial link vectors each sums, up to the non-portable size 16: the
// fig12 batch of 21,504 sub-flows a simulation on 449 link slots gets 16,
// as does the dense shape), so a B = 2 batch occupies 32 SMs.  CTA r
// owns flows [r W / C, (r + 1) W / C) and
// their thr entries (the running rates, updated in place each pass, read
// and written by that CTA only).  Per pass each CTA scatters its flows
// into its own shared-memory partial link load with shared atomics; then
// cascade_common.cuh::cluster_scale_pass sums the C partials through
// distributed shared memory in rank order between two cluster barriers,
// so every CTA derives the same scales and running arrival bit for bit,
// and applies them to its own flows.  The queue and mark of link l are
// written by CTA l mod C.  Float atomics within a CTA make the summation
// order vary from run to run, so results agree with the plain version to
// float round-off.  A cluster that does not schedule is a launch error:
// nothing falls back to fewer CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cascade::slot;
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
  extern __shared__ float smem[];
  float* partial = smem;          // [L1] this CTA's share of the pass's link load
  float* scale = smem + L1;       // [L1] the pass's scale, the same in every CTA
  float* arr = smem + 2 * L1;     // [L1] running arrival, the same in every CTA
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
    atomicAdd(&partial[tx[w]], s);
  }
  cascade::cluster_scale_pass(cluster, C, partial, scale, arr, cap, L1);
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float sc = scale[tx[w]];
    for (int n = 0; n < N; ++n) thr[w * N + n] = rates[w * N + n] * sc;
  }
  __syncthreads();

  // ---- fabric hops, per sub-flow (each thread rereads only what it wrote)
  for (int h = 0; h < Hf; ++h) {
    for (int i = i_lo + threadIdx.x; i < i_hi; i += blockDim.x)
      atomicAdd(&partial[slot(fab[i * Hf + h], L1)], thr[i]);
    cascade::cluster_scale_pass(cluster, C, partial, scale, arr, cap, L1);
    for (int i = i_lo + threadIdx.x; i < i_hi; i += blockDim.x)
      thr[i] *= scale[slot(fab[i * Hf + h], L1)];
  }
  __syncthreads();

  // ---- host_rx: pre-reduced again
  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += thr[w * N + n];
    atomicAdd(&partial[rx[w]], s);
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

int configure(int C, size_t smem) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cascade_tiered_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (C > 8) {
    err = cudaFuncSetAttribute(cascade_tiered_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

cudaLaunchConfig_t launch_config(int B, int C, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

}  // namespace

// How many clusters of C CTAs (with L1 links each) the card can hold at
// once, into *count; returns 0 or a CUDA error.  0 clusters means that a
// launch of that size cannot be scheduled.
extern "C" int cascade_tiered_max_clusters(int C, int L1, int* count) {
  if (C < 1 || C > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)L1 * sizeof(float);
  int err = configure(C, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, C, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, cascade_tiered_kernel, &cfg);
}

// B simulations on a grid of B * C CTAs in clusters of C (1 <= C <= 16;
// above 8 only where the card admits a non-portable cluster size).
extern "C" int cascade_tiered_launch(
    const void* fab, const void* tx, const void* rx, const void* rates,
    const void* queue, const void* cap, const void* qmask,
    void* arrival, void* new_queue, void* p_mark, void* thr,
    int B, int W, int N, int Hf, int L1, int C,
    float kmin, float kmax, float pmax, float dt, float qmax,
    void* stream) {
  if (C < 1 || C > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)L1 * sizeof(float);
  int setup = configure(C, smem);
  if (setup != 0) return setup;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(B, C, smem, (cudaStream_t)stream, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, cascade_tiered_kernel,
      (const int32_t*)fab, (const int32_t*)tx, (const int32_t*)rx, (const float*)rates,
      (const float*)queue, (const float*)cap, (const float*)qmask,
      (float*)arrival, (float*)new_queue, (float*)p_mark, (float*)thr,
      W, N, Hf, L1, C, kmin, kmax, pmax, dt, qmax);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
