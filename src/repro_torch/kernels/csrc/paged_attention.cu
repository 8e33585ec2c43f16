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
// [0, P): the kernel traps otherwise (for the dense slot grid that is the
// serving engine's `positions < max_len`), so the launch fails with an
// error instead of reading out of bounds. __trap() is no function call,
// so unlike assert() it costs the kernel no stack frame and no spills.
//
// The int8 body (paged_attention_q8_launch) replaces _paged_kernel_q8
// of the same TPU file: kp/vp hold int8 and two f32 scale pools
// ks/vs [P, ps, G, 1] ride the same page-table indirection (one scale
// per token per kv group). Each int8 element is dequantised in registers,
// in f32, before its dot (k * ks) or its accumulation (v * vs), as the
// TPU body rehydrates a page in VMEM; the fp extent never exists in
// device memory. Its bound is the int8 rows plus their scales: 2*(D+4)
// bytes per position per group instead of 2*2*D in bf16.
//
// The block has threads_for(D) threads: 128 for D <= 128, 256 for D =
// 256 (recurrentgemma-2b's MQA heads). That many positions per step, and
// D must divide it so that the V accumulation's (stripe, dim) layout covers
// every dim (at D = 256 one stripe: each thread owns one dim).
//
// Simple first: no split of one row's pages across blocks
// (flash-decoding), scalar loads. Those are later work.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;

// threads per block (= positions per step) for head dim D
constexpr int threads_for(int D) { return D <= 128 ? 128 : 256; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Block-wide max / sum over WARPS warps; every thread gets the result.
template <int WARPS>
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

template <int WARPS>
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

// T: q and o; KV: the pools (T, or int8_t with Q8 and the scale pools
// ks/vs, which are null otherwise); THREADS: threads_for(D).
template <typename T, typename KV, bool Q8, int THREADS>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
             const KV* __restrict__ vp, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ table,
             const int* __restrict__ lengths, T* __restrict__ o, int H,
             int G, int D, int ps, int M, int P, float scale) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float qs[THREADS];
  __shared__ float prob[THREADS];
  __shared__ float part[THREADS];
  __shared__ float red[WARPS];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int g = h / (H / G);
  const int len = lengths[b];
  if (len < 1 || len > M * ps) __trap();
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
      if (page < 0 || page >= P) __trap();
      const long long row = ((long long)page * ps + t % ps) * G + g;
      const KV* krow = kp + row * D;
      const float sk = Q8 ? ks[row] : 1.f;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qs[d], to_f32(krow[d]) * sk, dot);
      s = dot;
    }
    const float m_new = fmaxf(m, block_max<WARPS>(s, red));
    // t0 < len, so m_new is a real score and masked positions get p = 0
    const float p = t < len ? expf(s - m_new) : 0.f;
    prob[tid] = p;
    const float alpha = expf(m - m_new);
    l = l * alpha + block_sum<WARPS>(p, red);  // block_sum syncs: prob is visible
    acc *= alpha;
    const int n = min(THREADS, len - t0);
    for (int j = stripe; j < n; j += stripes) {
      const int tt = t0 + j;
      const int page = trow[tt / ps];
      const long long row = ((long long)page * ps + tt % ps) * G + g;
      const float sv = Q8 ? vs[row] : 1.f;
      acc = fmaf(prob[j], to_f32(vp[row * D + dim]) * sv, acc);
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

bool bad_geometry(int B, int H, int G, int D, int ps, int M, int P) {
  return B <= 0 || H <= 0 || G <= 0 || H % G != 0 || D <= 0 || D > 256 ||
         threads_for(D) % D != 0 || ps <= 0 || M <= 0 || P <= 0;
}

template <typename T, typename KV, bool Q8, int THREADS>
void launch_nt(const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const void* table, const void* lengths,
               void* o, int B, int H, int G, int D, int ps, int M, int P,
               float scale, cudaStream_t stream) {
  paged_kernel<T, KV, Q8, THREADS><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o), H, G, D, ps, M,
      P, scale);
}

template <typename T, typename KV, bool Q8>
void launch(const void* q, const void* kp, const void* vp, const void* ks,
            const void* vs, const void* table, const void* lengths, void* o,
            int B, int H, int G, int D, int ps, int M, int P, float scale,
            cudaStream_t stream) {
  if (threads_for(D) == 128) {
    launch_nt<T, KV, Q8, 128>(q, kp, vp, ks, vs, table, lengths, o, B, H, G,
                              D, ps, M, P, scale, stream);
  } else {
    launch_nt<T, KV, Q8, 256>(q, kp, vp, ks, vs, table, lengths, o, B, H, G,
                              D, ps, M, P, scale, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D divides 128, or D = 256; H a
// multiple of G; all tensors contiguous. scale = 1/sqrt(D). Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* table,
                                      const void* lengths, void* o, int B,
                                      int H, int G, int D, int ps, int M,
                                      int P, float scale, int dtype,
                                      void* stream) {
  if (bad_geometry(B, H, G, D, ps, M, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, float, false>(q, kp, vp, nullptr, nullptr, table, lengths,
                                o, B, H, G, D, ps, M, P, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, kp, vp, nullptr, nullptr, table, lengths, o, B, H, G, D, ps, M, P,
        scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The int8 body: kp, vp int8 [P, ps, G, D]; ks, vs f32 [P, ps, G, 1];
// dtype is q's and o's (0 = float32, 1 = bfloat16); the rest as above.
extern "C" int paged_attention_q8_launch(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* table,
                                         const void* lengths, void* o, int B,
                                         int H, int G, int D, int ps, int M,
                                         int P, float scale, int dtype,
                                         void* stream) {
  if (bad_geometry(B, H, G, D, ps, M, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, int8_t, true>(q, kp, vp, ks, vs, table, lengths, o, B, H,
                                G, D, ps, M, P, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, int8_t, true>(q, kp, vp, ks, vs, table, lengths, o,
                                        B, H, G, D, ps, M, P, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
