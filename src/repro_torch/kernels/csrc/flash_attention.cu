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
//
// The int8 body (flash_attention_q8_launch) replaces _flash_kernel_q8 of
// the same TPU file: int8 k / v [BH, T, D] with per-token f32 scales
// [BH, T, 1]. Each int8 element is widened and multiplied by its row's
// scale in f32 (not rounded) as the tile is staged into shared memory, so
// the fp extent never exists in device memory; the loop is the fp body's.
//
// The shared-prefix entry (prefix_attention_launch) is the form the paged
// serving path needs and the TPU kernel lacks: the queries of a suffix
// sit at positions pre_len + i and attend two key segments with one
// online softmax: a prefix pk / pv [BH, Lp, D] (fp, or int8 with f32
// scales [BH, Lp, 1]), visible below pre_len (rows at or past pre_len are
// never read: their scores are NEG_INF and their tile rows zeros), then
// the fresh fp suffix k / v [BH, S, D], causal on the local index. An
// int8 prefix element is dequantised in f32 and rounded to T, as the
// reference casts the dequantised prefix to the compute dtype. One
// template, flash_kernel<T, PK, K, D>, serves every entry: PK is the
// prefix's storage and K the main segment's (T, or int8_t with scales).
// Its bound: the int8 prefix is D + 4 bytes a token where a bf16 one is
// 2 * D, but at the serving shapes the work is operation bound as above.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;   // query rows per block = threads per block
constexpr int BK = 32;   // kv rows per shared-memory tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v rounded to T (the identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename KV> constexpr bool is_q8 = std::is_same<KV, int8_t>::value;

// Stage rows t0 .. t0 + ROWS - 1 of one bh's k / v into the f32 tiles
// ks / vs with NT threads; rows at or past n are not read (zeros). An
// int8 row is multiplied by its f32 scale; with ROUND each value is then
// rounded to T.
template <typename T, bool ROUND, int D, int ROWS, int NT, typename KV>
__device__ __forceinline__ void stage(float (*ks)[D], float (*vs)[D],
                                      const KV* __restrict__ k,
                                      const KV* __restrict__ v,
                                      const float* __restrict__ kscale,
                                      const float* __restrict__ vscale,
                                      int t0, int n, int tid) {
  for (int idx = tid; idx < ROWS * D; idx += NT) {
    const int j = idx / D, d = idx % D;
    const int gj = t0 + j;
    float a = 0.f, b = 0.f;
    if (gj < n) {
      a = to_f32(k[(long long)gj * D + d]);
      b = to_f32(v[(long long)gj * D + d]);
      if constexpr (is_q8<KV>) {
        a *= kscale[gj];
        b *= vscale[gj];
      }
      if constexpr (ROUND) {
        a = round_to<T>(a);
        b = round_to<T>(b);
      }
    }
    ks[j][d] = a;
    vs[j][d] = b;
  }
}

// The operands of one launch. The prefix segment (pk, pv, pre_len > 0)
// comes first; k / v is the main segment. Scale pointers are null for an
// fp segment; pk / pv are null when pre_len is 0.
struct Args {
  const void* q;
  const void* pk;
  const void* pv;
  const float* pks;
  const float* pvs;
  int pre_span, pre_len;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  void* o;
  int BH, S, T, causal, window;
  float scale;
};

// Pointers of bh's rows: row pointers of the segments, scales per token.
template <typename T, typename PK, typename K, int D>
struct Rows {
  const T* q;
  const PK* pk;
  const PK* pv;
  const float* pks;
  const float* pvs;
  const K* k;
  const K* v;
  const float* ks;
  const float* vs;
  T* o;
  __device__ Rows(const Args& a, long long bh) {
    q = static_cast<const T*>(a.q) + bh * a.S * D;
    o = static_cast<T*>(a.o) + bh * a.S * D;
    const long long pre = bh * a.pre_span;
    pk = a.pre_len ? static_cast<const PK*>(a.pk) + pre * D : nullptr;
    pv = a.pre_len ? static_cast<const PK*>(a.pv) + pre * D : nullptr;
    pks = a.pks ? a.pks + pre : nullptr;
    pvs = a.pvs ? a.pvs + pre : nullptr;
    k = static_cast<const K*>(a.k) + bh * a.T * D;
    v = static_cast<const K*>(a.v) + bh * a.T * D;
    ks = a.ks ? a.ks + bh * a.T : nullptr;
    vs = a.vs ? a.vs + bh * a.T : nullptr;
  }
};

template <typename T, typename PK, typename K, int D>
__global__ void __launch_bounds__(BQ) flash_kernel(const Args a) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ss[BK][BQ];  // [kv][row]: each thread owns a column

  const int tid = threadIdx.x;
  const Rows<T, PK, K, D> r(a, blockIdx.y);
  const int S = a.S, Tkv = a.T, pre_len = a.pre_len;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid;
  const bool row_ok = qi < S;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? to_f32(r.q[(long long)qi * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int kv_end = Tkv;
  if (a.causal) kv_end = min(Tkv, q0 + BQ);  // keys past the block's last row
  int kv_begin = 0;
  if (a.window) {  // keys before the block's first row's window
    const int first = q0 - a.window + 1;
    kv_begin = first > 0 ? (first / BK) * BK : 0;
  }

  // segment 0: the prefix (keys below pre_len, all visible); segment 1:
  // the main keys under the causal / window masks
  for (int seg = 0; seg < 2; ++seg) {
    const bool pre = seg == 0;
    const int end = pre ? pre_len : kv_end;
    for (int t0 = pre ? 0 : kv_begin; t0 < end; t0 += BK) {
      if (pre)
        stage<T, true, D, BK, BQ>(ks, vs, r.pk, r.pv, r.pks, r.pvs, t0, pre_len, tid);
      else
        stage<T, false, D, BK, BQ>(ks, vs, r.k, r.v, r.ks, r.vs, t0, Tkv, tid);
      __syncthreads();

      float bmax = NEG_INF;
      for (int j = 0; j < BK; ++j) {
        const int kp = t0 + j;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
        s *= a.scale;
        bool ok;
        if (pre) {
          ok = kp < pre_len;
        } else {
          ok = kp < Tkv;
          if (a.causal) ok = ok && kp <= qi;
          if (a.window) ok = ok && (qi - kp) < a.window;
        }
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
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = r.o + (long long)qi * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(ob + d, acc[d] / denom);
  }
}

constexpr int SPLIT_ROWS = 32;  // query rows per block of flash_split_kernel
constexpr int SPLIT_BK = 16;    // kv rows per shared-memory tile there

template <typename T, typename PK, typename K, int D, int TPR>
__global__ void __launch_bounds__(SPLIT_ROWS * TPR) flash_split_kernel(const Args a) {
  constexpr int NT = SPLIT_ROWS * TPR;
  constexpr int C = D / 4 / TPR;  // float4 chunks per thread
  static_assert(C * 4 * TPR == D && TPR <= 32 && 32 % TPR == 0, "bad split");
  __shared__ __align__(16) float ks[SPLIT_BK][D];
  __shared__ __align__(16) float vs[SPLIT_BK][D];

  const int tid = threadIdx.x;
  const int lane = tid % TPR;  // this thread's slice of D
  const Rows<T, PK, K, D> r(a, blockIdx.y);
  const int S = a.S, Tkv = a.T, pre_len = a.pre_len;
  const int q0 = blockIdx.x * SPLIT_ROWS;
  const int qi = q0 + tid / TPR;
  const bool row_ok = qi < S;

  float4 qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long d = 4 * (c * TPR + lane);
    const T* src = r.q + (long long)qi * D + d;
    qr[c] = row_ok ? make_float4(to_f32(src[0]), to_f32(src[1]),
                                 to_f32(src[2]), to_f32(src[3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  int kv_end = Tkv;
  if (a.causal) kv_end = min(Tkv, q0 + SPLIT_ROWS);
  int kv_begin = 0;
  if (a.window) {
    const int first = q0 - a.window + 1;
    kv_begin = first > 0 ? (first / SPLIT_BK) * SPLIT_BK : 0;
  }

  for (int seg = 0; seg < 2; ++seg) {
    const bool pre = seg == 0;
    const int end = pre ? pre_len : kv_end;
    for (int t0 = pre ? 0 : kv_begin; t0 < end; t0 += SPLIT_BK) {
      if (pre)
        stage<T, true, D, SPLIT_BK, NT>(ks, vs, r.pk, r.pv, r.pks, r.pvs, t0, pre_len, tid);
      else
        stage<T, false, D, SPLIT_BK, NT>(ks, vs, r.k, r.v, r.ks, r.vs, t0, Tkv, tid);
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
        s *= a.scale;
        const int kp = t0 + j;
        bool ok;
        if (pre) {
          ok = kp < pre_len;
        } else {
          ok = kp < Tkv;
          if (a.causal) ok = ok && kp <= qi;
          if (a.window) ok = ok && (qi - kp) < a.window;
        }
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
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = r.o + (long long)qi * D;
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

template <typename T, typename PK, typename K, int D>
void launch_d(const Args& a, cudaStream_t stream) {
  if constexpr (D == 256) {
    const dim3 grid((a.S + SPLIT_ROWS - 1) / SPLIT_ROWS, a.BH);
    flash_split_kernel<T, PK, K, D, 8><<<grid, SPLIT_ROWS * 8, 0, stream>>>(a);
  } else {
    const dim3 grid((a.S + BQ - 1) / BQ, a.BH);
    flash_kernel<T, PK, K, D><<<grid, BQ, 0, stream>>>(a);
  }
}

template <typename T, typename PK, typename K>
bool launch_dims(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: launch_d<T, PK, K, 16>(a, s); return true;
    case 32: launch_d<T, PK, K, 32>(a, s); return true;
    case 64: launch_d<T, PK, K, 64>(a, s); return true;
    case 128: launch_d<T, PK, K, 128>(a, s); return true;
    case 256: launch_d<T, PK, K, 256>(a, s); return true;
    default: return false;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, o and every fp segment); the
// three storage variants: fp everywhere, an int8 main segment, an int8
// prefix.
int run(const Args& a, int D, int dtype, bool q8_main, bool q8_prefix,
        void* stream) {
  if (a.BH <= 0 || a.S <= 0 || a.T <= 0 || a.pre_len < 0
      || a.pre_len > a.pre_span)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = q8_main ? launch_dims<float, float, int8_t>(a, D, s)
         : q8_prefix ? launch_dims<float, int8_t, float>(a, D, s)
                     : launch_dims<float, float, float>(a, D, s);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    ok = q8_main ? launch_dims<B, B, int8_t>(a, D, s)
         : q8_prefix ? launch_dims<B, int8_t, B>(a, D, s)
                     : launch_dims<B, B, B>(a, D, s);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// D in {16, 32, 64, 128, 256}; all tensors contiguous. Each entry returns
// the cudaError_t of its launch (0 = success).

// fp: q, k, v and o of one dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int T_, int D, int causal, int window,
                                      float scale, int dtype, void* stream) {
  const Args a{q, nullptr, nullptr, nullptr, nullptr, 0, 0, k, v, nullptr,
               nullptr, o, BH, S, T_, causal, window, scale};
  return run(a, D, dtype, false, false, stream);
}

// int8 k / v with f32 scales ks / vs [BH, T]; q and o fp.
extern "C" int flash_attention_q8_launch(const void* q, const void* k,
                                         const void* v, const float* ks,
                                         const float* vs, void* o, int BH,
                                         int S, int T_, int D, int causal,
                                         int window, float scale, int dtype,
                                         void* stream) {
  if (!ks || !vs) return (int)cudaErrorInvalidValue;
  const Args a{q, nullptr, nullptr, nullptr, nullptr, 0, 0, k, v, ks, vs, o,
               BH, S, T_, causal, window, scale};
  return run(a, D, dtype, true, false, stream);
}

// The shared-prefix entry: q, k, v and o [BH, S, D] fp, the prefix pk / pv
// [BH, pre_span, D] in q's dtype, or int8 with f32 scales pks / pvs
// [BH, pre_span] (both null for an fp prefix); keys below pre_len
// (1 <= pre_len <= pre_span) are visible, the suffix is causal.
extern "C" int prefix_attention_launch(const void* q, const void* pk,
                                       const void* pv, const float* pks,
                                       const float* pvs, int pre_span,
                                       int pre_len, const void* k,
                                       const void* v, void* o, int BH, int S,
                                       int D, float scale, int dtype,
                                       void* stream) {
  if (pre_len < 1 || !pk || !pv || (!pks) != (!pvs))
    return (int)cudaErrorInvalidValue;
  const Args a{q, pk, pv, pks, pvs, pre_span, pre_len, k, v, nullptr,
               nullptr, o, BH, S, S, 1, 0, scale};
  return run(a, D, dtype, false, pks != nullptr, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
