// Flat hop cascade of the fluid dataplane (the oracle layout), one
// simulation per CTA.
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
// What bounds it on an H100: as in cascade_tiered.cu, each hop's scale
// needs that hop's complete link load, so the H passes are serial, each a
// scatter-add of n floats onto a few hundred links; the bytes are small
// (about 0.5 MB per simulation at n = 21504, H = 4), so the kernel is bound
// by launch latency and by the barriers between passes, not by memory.
//
// What the design does about it: the tiered kernel's, without the NIC
// pre-reduction.  One CTA owns one simulation, the link load/scale vector
// and the running arrival live in shared memory (cascade_common.cuh), the
// segment sums are shared-memory atomicAdds and a __syncthreads separates
// the passes.  The running rates live in the thr output, updated in place
// each pass.  Float atomics make the summation order vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

using cascade::scale_pass;
using cascade::slot;
using cascade::zero;

__global__ void cascade_flat_kernel(
    const int32_t* __restrict__ lid,    // [B, n, H]
    const float* __restrict__ rates,    // [B, n]
    const float* __restrict__ queue,    // [B, L1]
    const float* __restrict__ cap,      // [L1]
    const float* __restrict__ qmask,    // [L1]
    float* __restrict__ arrival,        // [B, L1]
    float* __restrict__ new_queue,      // [B, L1]
    float* __restrict__ p_mark,         // [B, L1]
    float* __restrict__ thr,            // [B, n]
    int n, int H, int L1,
    float kmin, float kmax, float pmax, float dt, float qmax) {
  extern __shared__ float smem[];
  float* load = smem;       // [L1] this pass's link load, then its scale
  float* arr = smem + L1;   // [L1] running arrival
  const int b = blockIdx.x;
  lid += (size_t)b * n * H;
  rates += (size_t)b * n;
  thr += (size_t)b * n;
  queue += (size_t)b * L1;
  arrival += (size_t)b * L1;
  new_queue += (size_t)b * L1;
  p_mark += (size_t)b * L1;

  zero(arr, L1);
  for (int i = threadIdx.x; i < n; i += blockDim.x) thr[i] = rates[i];
  for (int h = 0; h < H; ++h) {
    zero(load, L1);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      atomicAdd(&load[slot(lid[i * H + h], L1)], thr[i]);
    __syncthreads();
    scale_pass(load, arr, cap, L1);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      thr[i] *= load[slot(lid[i * H + h], L1)];
    __syncthreads();
  }
  cascade::finish_links(arr, queue, cap, qmask, arrival, new_queue, p_mark, L1,
                        kmin, kmax, pmax, dt, qmax);
}

}  // namespace

extern "C" int cascade_flat_launch(
    const void* lid, const void* rates, const void* queue, const void* cap,
    const void* qmask, void* arrival, void* new_queue, void* p_mark, void* thr,
    int B, int n, int H, int L1,
    float kmin, float kmax, float pmax, float dt, float qmax,
    void* stream) {
  const int threads = 1024;
  const size_t smem = 2 * (size_t)L1 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cascade_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cascade_flat_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lid, (const float*)rates, (const float*)queue, (const float*)cap,
      (const float*)qmask, (float*)arrival, (float*)new_queue, (float*)p_mark,
      (float*)thr, n, H, L1, kmin, kmax, pmax, dt, qmax);
  return (int)cudaGetLastError();
}
