// paged_attention: single-token decode attention through a page table.
// q [B, H, D]; kp, vp [P, ps, G, D] page pools; page_table [B, M] int32;
// lengths [B] int32 valid kv count per row. Head h reads kv group
// h / (H / G). Returns o [B, H, D].
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention / _paged_kernel (fp body _paged_body). The TPU grid
// walks all M pages of every row with the table scalar-prefetched; here
// one block per (row, head) reads its own table row and length and stops
// at the row's length, so pages past the frontier cost nothing. The
// online softmax runs across blocks of 128 positions (one per thread):
// each block's maximum updates the running max, the running sum and
// accumulator are rescaled, and the output is normalised once at the end
// by max(l, 1e-30), as in the TPU body.
//
// What bounds it on the H100: reading the valid K and V rows, 4*D flops
// per 2*2*D bytes (bf16) — far below the card's operations-per-byte
// ridge, so it is bound by device-memory bytes. Positions past a row's
// length are never read. The scores and probabilities stay in shared
// memory; the V accumulation is spread over all threads (each owns one
// dim of one position stripe) and reads V rows coalesced along D.
//
// A row's length must lie in [1, M * ps] and its table entries in
// [0, P): the kernel asserts both (for the dense slot grid that is the
// serving engine's `positions < max_len`).
//
// Simple first: no split of one row's pages across blocks
// (flash-decoding), scalar loads. Those are later work.
#include <cassert>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;  // positions per step; also D <= 128
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Block-wide max / sum; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ o, int H,
             int G, int D, int ps, int M, int P, float scale) {
  __shared__ float qs[THREADS];
  __shared__ float prob[THREADS];
  __shared__ float part[THREADS];
  __shared__ float red[WARPS];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int g = h / (H / G);
  const int len = lengths[b];
  assert(len >= 1 && len <= M * ps);
  const int* trow = table + b * M;

  if (tid < D) qs[tid] = to_f32(q[(b * H + h) * D + tid]) * scale;
  __syncthreads();

  // V accumulation layout: thread = (stripe, dim); D divides THREADS
  const int stripes = THREADS / D;
  const int dim = tid % D;
  const int stripe = tid / D;

  float m = NEG_INF, l = 0.f, acc = 0.f;
  for (int t0 = 0; t0 < len; t0 += THREADS) {
    const int t = t0 + tid;
    float s = NEG_INF;
    if (t < len) {
      const int page = trow[t / ps];
      assert(page >= 0 && page < P);
      const T* krow = kp + (((long long)page * ps + t % ps) * G + g) * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qs[d], to_f32(krow[d]), dot);
      s = dot;
    }
    const float m_new = fmaxf(m, block_max(s, red));
    // t0 < len, so m_new is a real score and masked positions get p = 0
    const float p = t < len ? expf(s - m_new) : 0.f;
    prob[tid] = p;
    const float alpha = expf(m - m_new);
    l = l * alpha + block_sum(p, red);  // block_sum syncs: prob is visible
    acc *= alpha;
    const int n = min(THREADS, len - t0);
    for (int j = stripe; j < n; j += stripes) {
      const int tt = t0 + j;
      const int page = trow[tt / ps];
      const T* vrow = vp + (((long long)page * ps + tt % ps) * G + g) * D;
      acc = fmaf(prob[j], to_f32(vrow[dim]), acc);
    }
    m = m_new;
    __syncthreads();  // prob is rewritten by the next step
  }

  part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
    for (int st = 0; st < stripes; ++st) sum += part[st * D + tid];
    store(o + (b * H + h) * D + tid, sum / fmaxf(l, 1e-30f));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D <= 128 and divides 128; H a
// multiple of G; all tensors contiguous. scale = 1/sqrt(D). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* table,
                                      const void* lengths, void* o, int B,
                                      int H, int G, int D, int ps, int M,
                                      int P, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || D <= 0 || D > THREADS ||
      THREADS % D != 0 || ps <= 0 || M <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 0) {
    paged_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), tb, ln, static_cast<float*>(o), H, G,
        D, ps, M, P, scale);
  } else if (dtype == 1) {
    paged_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), tb, ln,
        static_cast<__nv_bfloat16*>(o), H, G, D, ps, M, P, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
