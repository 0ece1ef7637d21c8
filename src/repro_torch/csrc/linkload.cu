// One-pass switch dataplane step: offered load per link, queue update and
// RED/ECN mark, with no hop cascade and no queue mask.
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
// 5 * L * 4 in and out (about 0.2 MB at n = 8192, hops = 6, L = 512), so
// the memory bound is well under a microsecond; the scatter-add onto a few
// hundred links serialises on the same addresses, and the launch latency
// dominates.
//
// What the design does about it: the TPU kernel's one-hot matrix product
// is a device of the TPU's matrix unit and is not carried over.  One CTA
// accumulates the link vector in shared memory with shared-memory
// atomicAdds (an explicit bounds check keeps ids outside [0, L) from
// writing past it), then a __syncthreads and the queue and mark update.
// Float atomics make the summation order vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cascade_common.cuh"

namespace {

constexpr float kQmax = 8e6f;  // the JAX kernel's fixed queue cap

__global__ void linkload_kernel(
    const int32_t* __restrict__ lid,   // [n, hops]
    const float* __restrict__ rates,   // [n]
    const float* __restrict__ queue,   // [L]
    const float* __restrict__ cap,     // [L]
    float* __restrict__ load_out,      // [L]
    float* __restrict__ new_queue,     // [L]
    float* __restrict__ mark,          // [L]
    int n, int hops, int L, float kmin, float kmax, float pmax, float dt) {
  extern __shared__ float load[];
  for (int l = threadIdx.x; l < L; l += blockDim.x) load[l] = 0.0f;
  __syncthreads();
  const int m = n * hops;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    int id = lid[k];
    if (id >= 0 && id < L) atomicAdd(&load[id], rates[k / hops]);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float a = load[l];
    float q = fminf(fmaxf(queue[l] + (a - cap[l]) * dt / 8.0f, 0.0f), kQmax);
    load_out[l] = a;
    new_queue[l] = q;
    mark[l] = cascade::red_mark(q, kmin, kmax, pmax);
  }
}

}  // namespace

extern "C" int linkload_launch(
    const void* lid, const void* rates, const void* queue, const void* cap,
    void* load, void* new_queue, void* mark,
    int n, int hops, int L, float kmin, float kmax, float pmax, float dt,
    void* stream) {
  const int threads = 1024;
  const size_t smem = (size_t)L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        linkload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  linkload_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lid, (const float*)rates, (const float*)queue, (const float*)cap,
      (float*)load, (float*)new_queue, (float*)mark, n, hops, L, kmin, kmax, pmax, dt);
  return (int)cudaGetLastError();
}
