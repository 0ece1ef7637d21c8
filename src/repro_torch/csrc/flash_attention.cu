// Causal grouped-query flash attention with an optional sliding window and
// tanh softcap; fp32 online softmax, float32 or bfloat16 in and out.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel) of the JAX package.  Plain version:
// repro_torch/kernels/flash_attention.py::flash_attention_torch.
//
// What it computes, for query head h (KV head h / (H / K)) and query row i
// of Sq, at position p = q_offset + i among the Sk keys (q_offset = 0 and
// Sq = Sk: the JAX kernel's call; else the rows [q_offset, q_offset + Sq)
// of that call over Sk queries, a device's block of a split sequence):
//   s[j]  = (q[i] * hd^-0.5) . k[j]           (the scale on q, before the product)
//   s[j]  = softcap * tanh(s[j] / softcap)   (if softcap; before the mask)
//   s[j]  = -1e30 where j > p (causal) or p - j >= window (if window)
//   out   = sum_j softmax(s)[j] v[j], by the online recurrence over key
//           blocks: m = max(m, rowmax), alpha = exp(m_old - m),
//           l = l * alpha + rowsum(p), acc = acc * alpha + p v, and
//           finally acc / max(l, 1e-30)
// The masked value is the finite -1e30 of the JAX kernel, not -inf: a row
// whose first key blocks are all masked (a window) gets p = exp(0) there,
// which the first unmasked block wipes out through alpha = exp(-1e30 - m)
// = 0; with -inf that would be exp(-inf + inf) = NaN.  Key blocks wholly
// above the causal diagonal or wholly below the window are skipped, which
// gives the same result.
//
// What bounds it on an H100: the two products are 4 * hd flops per
// unmasked (query, key) pair, against reading q, k, v and writing the
// output once, so at the shapes of the repo's models (hd = 128 or 256,
// thousands of keys) it is bound by operations: the bf16 tensor-core peak
// (989 TFLOP/s) for bf16 inputs, the fp32 peak (67 TFLOP/s) for float32.
//
// What the design does about it, for now: one CTA of 256 threads per
// (batch, head, 64-query block) with the query tile and 64-key K and V
// tiles in shared memory as fp32; each thread holds a 4 x 4 block of the
// score tile and 4 rows x hd / 16 columns of the fp32 accumulator, so the
// row max and sum reduce over 16 lanes with warp shuffles.  The products
// run on the fp32 CUDA cores, not the tensor cores: this kernel is right
// and simple, and far from its bound.  wgmma, TMA and a pipelined ring of
// K/V tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the sum (or max) over the 16 lanes that share a query row
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int NJ>
constexpr size_t smem_floats() {
  // Q and K tiles padded by one column (conflict-free column reads), V, P
  return (size_t)kBQ * (16 * NJ + 1) + (size_t)kBK * (16 * NJ + 1) +
         (size_t)kBK * 16 * NJ + (size_t)kBQ * (kBK + 1);
}

// NJ = hd / 16: each thread owns output columns tx + 16 * jd, jd < NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,   // [B, Sq, H, hd]
    const T* __restrict__ k,   // [B, Sk, K, hd]
    const T* __restrict__ v,   // [B, Sk, K, hd]
    T* __restrict__ out,       // [B, Sq, H, hd]
    int Sq, int Sk, int q_off, int H, int K, int causal, int window, float softcap,
    float sm_scale) {
  constexpr int HD = 16 * NJ;
  constexpr int QP = HD + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][QP]
  float* Ks = Qs + kBQ * QP;      // [kBK][QP]
  float* Vs = Ks + kBK * QP;      // [kBK][HD]
  float* Ps = Vs + kBK * HD;      // [kBQ][PP]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    int r = idx / HD, d = idx % HD;
    int s = q0 + r;
    Qs[r * QP + d] = s < Sq ? to_float(q[(((size_t)b * Sq + s) * H + h) * HD + d]) * sm_scale
                            : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.0f;
  }

  const int p0 = q_off + q0;  // the position of the block's first row among the keys
  const int n_kb = (Sk + kBK - 1) / kBK;
  int kb_hi = n_kb;
  if (causal) kb_hi = min(n_kb, (p0 + kBQ + kBK - 1) / kBK);
  int kb_lo = 0;
  if (window > 0) kb_lo = max(0, p0 - window + 1) / kBK;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      int c = idx / HD, d = idx % HD;
      int j = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (j < Sk) {
        size_t off = (((size_t)b * Sk + j) * K + kvh) * HD + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      Ks[c * QP + d] = kv;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = p0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        ps += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4], va[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) va[jd] = Vs[c * HD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = fmaf(pa[i], va[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + ty + 16 * i;
    if (sq >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + sq) * H + h) * HD;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) store(o + tx + 16 * jd, acc[i][jd] * inv);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int q_off, int H, int K, int causal, int window, float softcap, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<NJ>() * sizeof(float);
  auto kernel = flash_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                           Sq, Sk, q_off, H, K, causal, window, softcap,
                                           sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
             int q_off, int H, int K, int hd, int causal, int window, float softcap,
             float sm_scale, cudaStream_t st) {
#define FLASH_LAUNCH(NJ)                                                                  \
  launch<T, NJ>(q, k, v, o, B, Sq, Sk, q_off, H, K, causal, window, softcap, sm_scale, st)
  switch (hd) {
    case 16: return FLASH_LAUNCH(1);
    case 32: return FLASH_LAUNCH(2);
    case 64: return FLASH_LAUNCH(4);
    case 128: return FLASH_LAUNCH(8);
    case 256: return FLASH_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output alike); q and the
// output [B, Sq, H, hd], k and v [B, Sk, K, hd], q_offset + Sq <= Sk
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int B, int Sq, int Sk, int q_offset, int H, int K, int hd, int causal, int window,
    float softcap, float sm_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, q_offset, H, K, hd, causal, window,
                           softcap, sm_scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, q_offset, H, K, hd, causal,
                                   window, softcap, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
