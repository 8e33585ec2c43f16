// flash_attention: causal / windowed online-softmax attention,
// q [BH, S, D], k and v [BH, T, D], query and key positions from 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention / _flash_kernel (fp body _flash_body). The TPU grid's
// sequential kv axis, with running max / sum / accumulator carried in
// VMEM scratch across grid steps, becomes a loop over kv blocks inside
// one block per (bh, 64-query block); the running state lives in
// registers. Scores are fp32 and scaled by 1/sqrt(D); causal and window
// masks come from absolute positions; each kv block updates the state
// from its block maximum, as the TPU body does, and the output is
// normalised once at the end by max(l, 1e-30).
//
// What bounds it on the H100: at the prefill shapes of the serving paths
// (qwen1.5-0.5b: bucket <= 512, D = 64; recurrentgemma-2b: bucket 2048 or
// 2560, D = 256, window 2048) the work is 4*D flops per visible
// query-key pair against 4*S*D*BH*2 bytes, so it is operation bound; the
// score matrix never reaches device memory. Blocks past the causal diagonal, and blocks
// wholly before every row's window, are skipped: every row they would
// touch is fully masked there, so the TPU kernel's result is unchanged.
//
// Simple first: one thread per query row, q and the accumulator in
// registers, k / v tiles and the block's scores in shared memory, fp32
// FMA on CUDA cores. Tensor cores and TMA are later work.
//
// D = 256 (recurrentgemma-2b's local attention) takes a second kernel,
// flash_split_kernel: one row's q and accumulator (512 floats) would
// spill out of one thread's registers, and fp32 k / v tiles of 32 keys
// would take 64 KB, over the 48 KB of static shared memory. There TPR = 8
// threads share each query row, each owning D / 8 dims as float4 chunks
// (chunk c of thread `lane` is dims 4 * (c * TPR + lane) .. + 3, so the 8
// threads of a row read 128 consecutive bytes of a key: no bank
// conflicts, and the 4 rows of a warp read the same bytes: a broadcast);
// a row's partial dots are summed by three warp shuffles, so every
// thread of the row holds the whole score and runs the same online
// softmax on its own slice of the accumulator. The tile is 32 rows by 16
// keys (32 KB of shared memory), with the scores of a tile in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;   // query rows per block = threads per block
constexpr int BK = 32;   // kv rows per shared-memory tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Tkv,
             int causal, int window, float scale) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ss[BK][BQ];  // [kv][row]: each thread owns a column

  const int tid = threadIdx.x;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid;
  const bool row_ok = qi < S;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tkv * D;
  const T* vb = v + bh * Tkv * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_f32(qb[(long long)qi * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int kv_end = Tkv;
  if (causal) kv_end = min(Tkv, q0 + BQ);  // keys past the block's last row
  int kv_begin = 0;
  if (window) {  // keys before the block's first row's window
    const int first = q0 - window + 1;
    kv_begin = first > 0 ? (first / BK) * BK : 0;
  }

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    for (int idx = tid; idx < BK * D; idx += BQ) {
      const int j = idx / D, d = idx % D;
      const int gj = t0 + j;
      ks[j][d] = gj < Tkv ? to_f32(kb[(long long)gj * D + d]) : 0.f;
      vs[j][d] = gj < Tkv ? to_f32(vb[(long long)gj * D + d]) : 0.f;
    }
    __syncthreads();

    float bmax = NEG_INF;
    for (int j = 0; j < BK; ++j) {
      const int kp = t0 + j;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      s *= scale;
      bool ok = kp < Tkv;
      if (causal) ok = ok && kp <= qi;
      if (window) ok = ok && (qi - kp) < window;
      s = ok ? s : NEG_INF;
      ss[j][tid] = s;
      bmax = fmaxf(bmax, s);
    }
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(ss[j][tid] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + bh * S * D + (long long)qi * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(ob + d, acc[d] / denom);
  }
}

constexpr int SPLIT_ROWS = 32;  // query rows per block of flash_split_kernel
constexpr int SPLIT_BK = 16;    // kv rows per shared-memory tile there

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(SPLIT_ROWS * TPR)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int S,
                   int Tkv, int causal, int window, float scale) {
  constexpr int NT = SPLIT_ROWS * TPR;
  constexpr int C = D / 4 / TPR;  // float4 chunks per thread
  static_assert(C * 4 * TPR == D && TPR <= 32 && 32 % TPR == 0, "bad split");
  __shared__ __align__(16) float ks[SPLIT_BK][D];
  __shared__ __align__(16) float vs[SPLIT_BK][D];

  const int tid = threadIdx.x;
  const int lane = tid % TPR;  // this thread's slice of D
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * SPLIT_ROWS;
  const int qi = q0 + tid / TPR;
  const bool row_ok = qi < S;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tkv * D;
  const T* vb = v + bh * Tkv * D;

  float4 qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long d = 4 * (c * TPR + lane);
    const T* src = qb + (long long)qi * D + d;
    qr[c] = row_ok ? make_float4(to_f32(src[0]), to_f32(src[1]),
                                 to_f32(src[2]), to_f32(src[3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  int kv_end = Tkv;
  if (causal) kv_end = min(Tkv, q0 + SPLIT_ROWS);
  int kv_begin = 0;
  if (window) {
    const int first = q0 - window + 1;
    kv_begin = first > 0 ? (first / SPLIT_BK) * SPLIT_BK : 0;
  }

  for (int t0 = kv_begin; t0 < kv_end; t0 += SPLIT_BK) {
    for (int idx = tid; idx < SPLIT_BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int gj = t0 + j;
      ks[j][d] = gj < Tkv ? to_f32(kb[(long long)gj * D + d]) : 0.f;
      vs[j][d] = gj < Tkv ? to_f32(vb[(long long)gj * D + d]) : 0.f;
    }
    __syncthreads();

    float sc[SPLIT_BK];
    float bmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < SPLIT_BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = kr[c * TPR + lane];
        s = fmaf(qr[c].x, kk.x, s);
        s = fmaf(qr[c].y, kk.y, s);
        s = fmaf(qr[c].z, kk.z, s);
        s = fmaf(qr[c].w, kk.w, s);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const int kp = t0 + j;
      bool ok = kp < Tkv;
      if (causal) ok = ok && kp <= qi;
      if (window) ok = ok && (qi - kp) < window;
      sc[j] = ok ? s : NEG_INF;
      bmax = fmaxf(bmax, sc[j]);
    }
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < SPLIT_BK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vr[c * TPR + lane];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + bh * S * D + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T* dst = ob + 4 * (c * TPR + lane);
      store(dst + 0, acc[c].x / denom);
      store(dst + 1, acc[c].y / denom);
      store(dst + 2, acc[c].z / denom);
      store(dst + 3, acc[c].w / denom);
    }
  }
}

template <typename T, int D, int TPR>
void launch_split(const void* q, const void* k, const void* v, void* o,
                  int BH, int S, int T_, int causal, int window, float scale,
                  cudaStream_t stream) {
  const dim3 grid((S + SPLIT_ROWS - 1) / SPLIT_ROWS, BH);
  flash_split_kernel<T, D, TPR><<<grid, SPLIT_ROWS * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_, causal, window,
      scale);
}

template <typename T, int D>
void launch_d(const void* q, const void* k, const void* v, void* o, int BH,
              int S, int T_, int causal, int window, float scale,
              cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_, causal, window,
      scale);
}

template <typename T>
bool launch(const void* q, const void* k, const void* v, void* o, int BH,
            int S, int T_, int D, int causal, int window, float scale,
            cudaStream_t stream) {
  switch (D) {
    case 16: launch_d<T, 16>(q, k, v, o, BH, S, T_, causal, window, scale, stream); return true;
    case 32: launch_d<T, 32>(q, k, v, o, BH, S, T_, causal, window, scale, stream); return true;
    case 64: launch_d<T, 64>(q, k, v, o, BH, S, T_, causal, window, scale, stream); return true;
    case 128: launch_d<T, 128>(q, k, v, o, BH, S, T_, causal, window, scale, stream); return true;
    case 256: launch_split<T, 256, 8>(q, k, v, o, BH, S, T_, causal, window, scale, stream); return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 32, 64, 128, 256}; all tensors
// contiguous. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int T_, int D, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || T_ <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = launch<float>(q, k, v, o, BH, S, T_, D, causal, window, scale, s);
  } else if (dtype == 1) {
    ok = launch<__nv_bfloat16>(q, k, v, o, BH, S, T_, D, causal, window, scale, s);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
