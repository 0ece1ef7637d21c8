// NIC-tiered hop cascade of the fluid dataplane, one simulation per CTA.
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
// link load, so the passes are serial, and the work per pass is a
// scatter-add of W*N floats onto a few hundred links.  The bytes are small
// (about 0.3 MB per simulation at W = 5376, N = 4, Hf = 2), so the memory
// bound is well under a microsecond and the kernel is bound by launch
// latency and by the barriers between passes.
//
// What the design does about it: the TPU kernel's one-hot matrix products
// are a device of the TPU's matrix unit and are not carried over.  One CTA
// owns one simulation; the link-load and scale vector and the running
// arrival vector live in shared memory (2 * (L + 1) floats: 3.6 KB for
// sim_2tier, 16.6 KB for the default three_tier), the segment sums are
// shared-memory atomicAdds, and a __syncthreads separates the passes.  The
// running rates live in the thr output in global memory (L2-resident at
// these sizes), updated in place each pass.  The batch of simulations maps
// onto the grid.  Float atomics make the summation order vary from run to
// run, so results agree with the plain version to float round-off.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

using cascade::scale_pass;
using cascade::slot;
using cascade::zero;

__global__ void cascade_tiered_kernel(
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
    int W, int N, int Hf, int L1,
    float kmin, float kmax, float pmax, float dt, float qmax) {
  extern __shared__ float smem[];
  float* load = smem;       // [L1] this pass's link load, then its scale
  float* arr = smem + L1;   // [L1] running arrival
  const int b = blockIdx.x;
  fab += (size_t)b * W * N * Hf;
  tx += (size_t)b * W;
  rx += (size_t)b * W;
  rates += (size_t)b * W * N;
  thr += (size_t)b * W * N;
  queue += (size_t)b * L1;
  arrival += (size_t)b * L1;
  new_queue += (size_t)b * L1;
  p_mark += (size_t)b * L1;

  zero(load, L1);
  zero(arr, L1);
  __syncthreads();

  // ---- host_tx: pre-reduced over the N sub-flows of a flow
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += rates[w * N + n];
    atomicAdd(&load[tx[w]], s);
  }
  __syncthreads();
  scale_pass(load, arr, cap, L1);
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float sc = load[tx[w]];
    for (int n = 0; n < N; ++n) thr[w * N + n] = rates[w * N + n] * sc;
  }
  __syncthreads();

  // ---- fabric hops, per sub-flow
  const int WN = W * N;
  for (int h = 0; h < Hf; ++h) {
    zero(load, L1);
    __syncthreads();
    for (int i = threadIdx.x; i < WN; i += blockDim.x) {
      int lid = fab[i * Hf + h];
      atomicAdd(&load[slot(lid, L1)], thr[i]);
    }
    __syncthreads();
    scale_pass(load, arr, cap, L1);
    __syncthreads();
    for (int i = threadIdx.x; i < WN; i += blockDim.x) {
      int lid = fab[i * Hf + h];
      thr[i] *= load[slot(lid, L1)];
    }
    __syncthreads();
  }

  // ---- host_rx: pre-reduced again
  zero(load, L1);
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float s = 0.0f;
    for (int n = 0; n < N; ++n) s += thr[w * N + n];
    atomicAdd(&load[rx[w]], s);
  }
  __syncthreads();
  scale_pass(load, arr, cap, L1);
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float sc = load[rx[w]];
    for (int n = 0; n < N; ++n) thr[w * N + n] *= sc;
  }

  // ---- queue integration and RED mark (arr is final since the rx scale pass)
  cascade::finish_links(arr, queue, cap, qmask, arrival, new_queue, p_mark, L1,
                        kmin, kmax, pmax, dt, qmax);
}

}  // namespace

extern "C" int cascade_tiered_launch(
    const void* fab, const void* tx, const void* rx, const void* rates,
    const void* queue, const void* cap, const void* qmask,
    void* arrival, void* new_queue, void* p_mark, void* thr,
    int B, int W, int N, int Hf, int L1,
    float kmin, float kmax, float pmax, float dt, float qmax,
    void* stream) {
  const int threads = 1024;
  const size_t smem = 2 * (size_t)L1 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cascade_tiered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cascade_tiered_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)fab, (const int32_t*)tx, (const int32_t*)rx, (const float*)rates,
      (const float*)queue, (const float*)cap, (const float*)qmask,
      (float*)arrival, (float*)new_queue, (float*)p_mark, (float*)thr,
      W, N, Hf, L1, kmin, kmax, pmax, dt, qmax);
  return (int)cudaGetLastError();
}
