// flash_attention: causal / windowed online-softmax attention,
// q [BH, S, D], k and v [BH, T, D], query and key positions from 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention / _flash_kernel (fp body _flash_body). The TPU grid's
// sequential kv axis, with running max / sum / accumulator carried in
// VMEM scratch across grid steps, becomes a loop over kv tiles inside
// one block per (bh, query block); the running state lives in
// registers. Scores are fp32 and scaled by 1/sqrt(D); causal and window
// masks come from absolute positions; each kv tile updates the state
// from its tile maximum, as the TPU body does, and the output is
// normalised once at the end by max(l, 1e-30).
//
// What bounds it on the H100: at the prefill shapes of the serving paths
// (qwen1.5-0.5b: bucket <= 512, D = 64; recurrentgemma-2b: bucket 2048 or
// 2560, D = 256, window 2048) the work is 4*D flops per visible
// query-key pair against 4*S*D*BH*2 bytes, so it is operation bound; the
// score matrix never reaches device memory. Tiles past the causal
// diagonal, and tiles wholly before every row's window, are skipped:
// every row they would touch is fully masked there, so the TPU kernel's
// result is unchanged.
//
// Three kernels, chosen by dtype, storage and head dim:
//
// - flash_tc_kernel<D> (bf16 q with fp k / v, every D: the main causal or
//   windowed body and the shared-prefix entry with an fp prefix): tensor
//   cores, wgmma for Q K^T and P V from swizzled shared tiles, K / V
//   tiles through a cp.async ring; see namespace tc. P is rounded to bf16
//   before P V, where the TPU body multiplies f32 p by f32 v.
// - flash_terms_kernel<T, PK, K, D> (D = 16, 32 and 64, every other
//   form: fp32 q, and the int8 forms with fp32 or bf16 q): the same wgmma
//   products on exact bf16 terms (int8 widened, fp32 split in three), the
//   int8 scales applied in f32 to the scores and folded into p, two
//   warpgroups a block splitting the K / V tiles of one query block and
//   merged in order; D = 16 and 32 zero-padded to 64 as the tiles are
//   staged; see namespace tm.
// - flash_split_kernel<T, PK, K, D, TPR> (D = 128 and 256 off tensor
//   cores): one row's q and accumulator (2 D floats) would spill out of
//   one thread's registers, and fp32 k / v tiles of 32 keys at D = 256
//   would take 64 KB, over the 48 KB of static shared memory. There TPR =
//   D / 32 threads share each query row, each owning D / TPR dims as 8
//   float4 chunks (chunk c of thread `lane` is dims 4 * (c * TPR + lane)
//   .. + 3, so the threads of a row read consecutive 16-byte pieces of a
//   key: no bank conflicts, and the rows of a warp read the same bytes: a
//   broadcast); a row's partial dots are summed by warp shuffles, so
//   every thread of the row holds the whole score and runs the same
//   online softmax on its own slice of the accumulator. The tile is 32
//   rows by 16 keys, with the scores of a tile in registers.
//
// Two more masking forms of the fp entry (flash_attention_launch), for the
// encoder-decoder and prefix-LM serving paths; every kernel above takes
// them (the int8 body and the shared-prefix entry do not):
//
// - per-row key lengths kv_len [B] (BH = B * heads: row bh reads
//   kv_len[bh / heads]): keys at or past the length are masked, the
//   reference's kv_valid of a right-padded encoder batch. Tiles wholly
//   past the length are skipped and rows at or past it are never read
//   (the loads stop at the length, as they stop at T); the tile holding
//   the length goes through the edge path. A row of length 0 has no
//   visible key: its output is 0 (the reference averages V there;
//   serving refuses a request with 0 source frames, so only the inert
//   slots of a serving grid have such rows, and nothing reads them).
// - the prefix-LM mask (bidir > 0, with causal): key kp is visible to
//   query qi when kp <= qi or kp < bidir, the reference's prefix_len
//   (paligemma's 256 patch tokens attended both ways). A tile past a
//   block's diagonal is skipped only when it also lies wholly at or past
//   bidir: the queries inside the prefix see keys up to bidir - 1, past
//   their own position.
//
// The int8 body (flash_attention_q8_launch) replaces _flash_kernel_q8 of
// the same TPU file: int8 k / v [BH, T, D] with per-token f32 scales
// [BH, T, 1]; the fp extent never exists in device memory. On the CUDA-core
// kernel (D = 128, 256) each int8 element is widened and multiplied by its
// row's scale in f32 (not rounded) as the tile is staged.
//
// The training forward is this file compiled a second time, with
// FLASH_TRAIN defined (flash_attention_train.cu): Args then carries lse
// [BH, S] f32, each kernel stores every row's log-sum-exp of the scaled
// scores (natural log) at its end (FLASH_LSE_STORE), flash_tc_kernel
// takes two warpgroups at D = 128 (three would leave a thread 168
// registers, and the store spills there), and the library exports
// flash_attention_lse_launch only (fp, causal or not, S queries over T
// keys, D = 64 and 128: the forms flash_attention_bwd.cu differentiates).
// Without FLASH_TRAIN every hook
// below expands to what the file held before the training forward
// existed, so the serving kernels compile to the same code.
//
// The shared-prefix entry (prefix_attention_launch) is the form the paged
// serving path needs and the TPU kernel lacks: the queries of a suffix
// sit at positions pre_len + i and attend two key segments with one
// online softmax: a prefix pk / pv [BH, Lp, D] (fp, or int8 with f32
// scales [BH, Lp, 1]), visible below pre_len (rows at or past pre_len are
// never read, nor their scales: their scores are masked and their tile
// rows zeros), then the fresh fp suffix k / v [BH, S, D], causal on the local
// index. On the CUDA-core kernel an int8 prefix element is dequantised in
// f32 and rounded to T, as the reference casts the dequantised prefix to
// the compute dtype. PK is the prefix's storage and K the main segment's
// (T, or int8_t with scales). Its bound: the int8 prefix is D + 4 bytes a
// token where a bf16 one is 2 * D; at the serving shapes the work is
// small and latency bound (above).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#ifdef FLASH_TRAIN
#define FLASH_ARGS_LSE float* lse;
#define FLASH_TC_WGS_128 2
#define FLASH_LSE_STORE(cond, row, value) \
  if (cond) a.lse[(long long)blockIdx.y * a.S + (row)] = (value);
#else
#define FLASH_ARGS_LSE
#define FLASH_TC_WGS_128 3
#define FLASH_LSE_STORE(cond, row, value)
#endif

namespace {

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
// fp segment; pk / pv are null when pre_len is 0. kv_len (null: every
// row has T keys) holds the main segment's valid keys per batch row of
// `heads` rows bh; with causal, keys below bidir are visible to every
// query (0: none beyond the causal ones).
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
  const int* kv_len;
  int heads, bidir;
  FLASH_ARGS_LSE
};

// the main segment's valid keys of row bh: T, or its row's length
// (clamped to [0, T])
__device__ __forceinline__ int valid_keys(const Args& a, int bh) {
  return a.kv_len ? min(a.T, max(0, a.kv_len[bh / a.heads])) : a.T;
}
// the main segment's end for a block of queries [q0, q0 + rows): causal,
// the block's last row or bidir, whichever lies further
__device__ __forceinline__ int main_end(const Args& a, int tn, int q0,
                                        int rows) {
  return a.causal ? min(tn, max(q0 + rows, a.bidir)) : tn;
}
// key kp visible to query qi in the main segment (kp < the row's length)
__device__ __forceinline__ bool visible(const Args& a, int kp, int qi, int tn) {
  bool ok = kp < tn;
  if (a.causal) ok = ok && (kp <= qi || kp < a.bidir);
  if (a.window) ok = ok && (qi - kp) < a.window;
  return ok;
}

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
  const int S = a.S, Tkv = valid_keys(a, blockIdx.y), pre_len = a.pre_len;
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

  const int kv_end = main_end(a, Tkv, q0, SPLIT_ROWS);
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
        const bool ok = pre ? kp < pre_len : visible(a, kp, qi, Tkv);
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
    FLASH_LSE_STORE(lane == 0, qi, m + __logf(denom))
  }
}

// ---- bf16 with fp K / V: tensor cores ------------------------------------
//
// flash_tc_kernel<D>: FA2's online softmax on Hopper's warpgroup products
// (wgmma). A block is two warpgroups of 64 query rows each, three at D =
// 128 (the 128 or 192 rows of a block share every K / V tile; one block
// an SM at D >= 128, so a third warpgroup is 12 warps an SM instead of
// 8); K / V tiles of 64 keys stream through a cp.async ring of 4 stages
// (2 at D = 256), one block barrier a tile. Q, K and V sit in shared
// memory in the 128-byte
// swizzle as 64-dim atoms of 128-byte rows (16-byte chunk c of row r at
// c ^ (r % 8)), zero-padded to 64 dims at D = 16 and 32. S = Q K^T is
// wgmma m64n64k16 with both operands read by the tensor cores from
// shared memory (K-major, as they lie: K is [keys, D]); O += P V is
// wgmma m64nDk16 with P from registers and V read MN-major (transposed by
// the instruction). The S accumulator of two adjacent 8-key blocks is,
// converted to bf16, the A fragment of P V: no trip through shared
// memory, and no fragment loads by the threads (mma.sync would read every
// B fragment through ldmatrix, 16 query rows a warp, and be bound by
// those shared-memory reads). Row max and sum go across the quad of
// threads that holds a row (__shfl_xor_sync); scores are scaled by
// log2(e) / sqrt(D) inside the exponent (ex2 of one fma); m and l are
// f32 as in the TPU body, l summed from the f32 p, and O is rescaled only
// when some row's max moved. P is rounded to bf16 before
// P V, where the TPU body multiplies f32 p by f32 v: a rounding the
// reference does not have, held to the bf16 tolerance. Tiles that no row
// of the block sees are skipped, and a warpgroup skips the products of a
// tile that none of its 64 rows sees (or that lies past S): its running
// state is unchanged there, as the TPU body's would be up to an exact
// zero; masks are applied element by element only on tiles that cross
// the diagonal, the window edge, T or pre_len. The O accumulator is D / 2
// registers a thread (128 at D = 256), S 32.
namespace tc {

// warpgroups per block: 3 at D = 128 (192 rows; 12 warps an SM where
// the registers allow one block), else 2 (128 rows)
__host__ __device__ constexpr int wgs(int d) {
  return d == 128 ? FLASH_TC_WGS_128 : 2;
}
__host__ __device__ constexpr int threads(int d) { return wgs(d) * 128; }
__host__ __device__ constexpr int bq(int d) { return wgs(d) * 64; }
// head dim as stored: at least one 64-dim atom
__host__ __device__ constexpr int dp(int d) { return d < 64 ? 64 : d; }
// stages of the K / V ring: 4 (176 KB with Q at D = 128), 2 at D = 256
// (Q and two stages take 192 KB)
__host__ __device__ constexpr int stages(int d) { return d == 256 ? 2 : 4; }
constexpr int BKV = 64;  // keys per K / V tile
__host__ __device__ constexpr int q_bytes(int d) { return dp(d) * bq(d) * 2; }
__host__ __device__ constexpr int kv_bytes(int d) { return dp(d) * BKV * 2; }
// Q, then stages x (K, V), + 1024 to align the swizzled atoms
__host__ __device__ constexpr int smem_bytes(int d) {
  return q_bytes(d) + stages(d) * 2 * kv_bytes(d) + 1024;
}
constexpr float LOG2E = 1.4426950408889634f;
#ifdef FLASH_TRAIN
// lse = (m + log2 l) ln 2, m in log2 units of the scaled scores; log2 is
// one MUFU.LG2
constexpr float LN2 = 0.6931471805599453f;
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; only src_bytes (0 or 16) are read, the rest
// is zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// cp.async's writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// 2^x, one MUFU.EX2 (subnormal results flush to 0: p that small is far
// under bf16's resolution beside the row's largest p, which is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S += Q K^T: wgmma m64n64k16, A and B K-major from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// O += P V: wgmma m64n64k16, A (P) from registers, B (V) MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O += P V: wgmma m64n128k16, A (P) from registers, B (V) MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// O += P V: wgmma m64n256k16, A (P) from registers, B (V) MN-major
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// rows [row0, row0 + ROWS) of a [*, D] bf16 tensor into the swizzled
// atoms at dst ([DP / 64][ROWS][64]); rows at or past lim and dims past D
// are zero-filled, not read
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int lim) {
  constexpr int CH = dp(D) / 8;  // 16-byte chunks per stored row
  for (int i = threadIdx.x; i < ROWS * CH; i += threads(D)) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < lim && c * 8 < D;
    cp_async16(dst + (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r & 7)) * 16),
               ok ? src + (long long)(row0 + r) * D + c * 8 : src,
               ok ? 16 : 0);
  }
}

// keep registers that an in-flight wgmma reads or writes alive and
// unmoved up to here (after its wait): the compiler does not know that
// the instruction is asynchronous
template <int N>
__device__ __forceinline__ void fence_regs(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i]));
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&v)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(v[i][e]));
}

template <int D>
__global__ void __launch_bounds__(threads(D), 1) flash_tc_kernel(const Args a) {
  using B = __nv_bfloat16;
  constexpr int DP = dp(D), STAGES = stages(D), BQ = bq(D);
  constexpr int NS = BKV / 2;  // S accumulators a thread (m64n64)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + q_bytes(D);  // stage st: K at + st * 2 * kv_bytes, V after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4;
  const int g = lane >> 2, t4 = lane & 3;
  const Rows<B, B, B, D> r(a, blockIdx.y);
  const int S = a.S, T = valid_keys(a, blockIdx.y), pre_len = a.pre_len;
  // causal: the longest query blocks first
  const int qb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BQ;

  // the tiles: prefix keys [0, pre_len), then main keys [kv_begin, kv_end)
  const int n_pre = (pre_len + BKV - 1) / BKV;
  const int kv_end = main_end(a, T, q0, BQ);
  int kv_begin = 0;
  if (a.window) {
    const int first = q0 - a.window + 1;
    kv_begin = first > 0 ? first / BKV * BKV : 0;
  }
  const int n_tiles = n_pre + max(0, (kv_end - kv_begin + BKV - 1) / BKV);

  auto load_tile = [&](int i, int st) {
    const bool pre = i < n_pre;
    const int t0 = pre ? i * BKV : kv_begin + (i - n_pre) * BKV;
    const int lim = pre ? pre_len : T;
    const uint32_t ks = kv_s + st * 2 * kv_bytes(D);
    load_rows<D, BKV>(ks, pre ? r.pk : r.k, t0, lim);
    load_rows<D, BKV>(ks + kv_bytes(D), pre ? r.pv : r.v, t0, lim);
  };
  load_rows<D, BQ>(q_s, r.q, q0, S);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {  // Q rides with tile 0
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;
  const int w0 = q0 + wg * 64;                     // the warpgroup's rows
  const int qi0 = w0 + (warp % 4) * 16 + g;        // this thread's: qi0, + 8
  const uint32_t qa = q_s + wg * 64 * 128;         // its Q rows in atom 0

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i (and, at i = 0, Q) landed
    fence_proxy_async();
    // every warpgroup is here, so done with tile i - 1: its stage takes
    // tile i + STAGES - 1
    __syncthreads();
    if (i + STAGES - 1 < n_tiles)
      load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const bool pre = i < n_pre;
    const int t0 = pre ? i * BKV : kv_begin + (i - n_pre) * BKV;
    const bool idle = w0 >= S ||
        (!pre && a.causal && t0 > w0 + 63 && t0 >= a.bidir) ||
        (!pre && a.window && t0 + BKV - 1 <= w0 - a.window);
    if (!idle) {
      const uint32_t ks = kv_s + (i % STAGES) * 2 * kv_bytes(D);
      const uint32_t vs = ks + kv_bytes(D);
      float s[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        const uint64_t da = smem_desc(qa + (j / 4) * (BQ * 128) + (j % 4) * 32, 16, 1024);
        const uint64_t db = smem_desc(ks + (j / 4) * (BKV * 128) + (j % 4) * 32, 16, 1024);
        wgmma_ss_n64(s, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // mask where the tile crosses an edge of visibility (raw scores;
      // the scale log2(e) / sqrt(D) > 0 is applied in the exponent);
      // s[4 jb + e]: key t0 + 8 jb + 2 t4 + (e & 1), row qi0 + 8 (e >> 1)
      bool edge;
      if (pre)
        edge = t0 + BKV > pre_len;
      else
        edge = t0 + BKV > T ||
               (a.causal && t0 + BKV - 1 > w0 && t0 + BKV > a.bidir) ||
               (a.window && t0 <= w0 + 63 - a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int kp = t0 + 8 * (j / 4) + 2 * t4 + (j & 1);
          const int qi = qi0 + 8 * ((j >> 1) & 1);
          const bool ok = pre ? kp < pre_len : visible(a, kp, qi, T);
          s[j] = ok ? s[j] : -INFINITY;
        }
      }

      // online softmax over this tile, rows qi0 (h = 0) and qi0 + 8 (h =
      // 1), m in scaled (log2) units. A masked score is -inf, so its p is
      // exactly 0, and m never falls below its start, NEG_INF: a tile that
      // masks a whole row leaves that row's state as it was, where the TPU
      // body adds p = 1 terms that the next visible tile scales by exactly
      // 0 (the same result)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(m[h], mx[h] * sl2);
        alpha[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      // most tiles leave every row's max where it was: no rescale then
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      }
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int h = (j >> 1) & 1;
        const float p0 = ex2(fmaf(s[j], sl2, -m[h]));
        const float p1 = ex2(fmaf(s[j + 1], sl2, -m[h]));
        l[h] += p0 + p1;
        // keys 16 kj .. + 15 are 8-key blocks 2 kj and 2 kj + 1
        pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }

      // O += P V, P rounded to bf16: 16 keys per k-step
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < BKV / 16; ++kj) {
        const uint64_t db = smem_desc(vs + kj * 16 * 128, BKV * 128, 1024);
        if constexpr (DP == 64) wgmma_rs_n64(o, pa[kj], db);
        else if constexpr (DP == 128) wgmma_rs_n128(o, pa[kj], db);
        else wgmma_rs_n256(o, pa[kj], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
  }
  cp_async_wait<0>();

  // the quad's partial sums, one normalisation, bf16 pairs out;
  // o[4 jb + 2 h + e]: dim 8 jb + 2 t4 + e of row qi0 + 8 h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    if (qi >= S) continue;
    FLASH_LSE_STORE(t4 == 0, qi, (m[h] + lg2(l[h])) * LN2)
    B* ob = r.o + (long long)qi * D + 2 * t4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(ob + jb * 8) = __floats2bfloat162_rn(
          o[4 * jb + 2 * h] / l[h], o[4 * jb + 2 * h + 1] / l[h]);
  }
}

}  // namespace tc

// ---- fp32 q, or int8 K / V, at D <= 64: tensor cores on bf16 terms ----
//
// flash_terms_kernel<T, PK, K, D>: every instance at D = 16, 32 and 64 but
// the all-bf16 one (fp32 q with fp32 K / V; the int8 body; the
// shared-prefix entry over an int8 prefix, or over an fp prefix with fp32
// q). The tiles are [64][64] at every D: dims past D are staged as zeros
// (as flash_tc_kernel pads D = 16 and 32), Q K^T takes only the D / 16
// k-steps that hold them, and only the D output dims are stored. The wgmma
// products of
// flash_tc_kernel (same swizzled tiles, S = Q K^T from shared memory, O
// += P V with P from registers, quad-shuffle online softmax, masks only
// on edge tiles) on operands split into exact bf16 terms:
//
// - an int8 value (at most 8 significant bits) is exact in bf16: each
//   int8 tile is widened once as it is staged (prmt, as quant_matmul
//   does), and the per-token f32 scales go where the products allow: score
//   column j is multiplied by k_scale[j] before the softmax, and v_scale[j]
//   is folded into p before P V (l sums the unscaled p). A bf16 q takes the
//   int8 prefix this way too, exactly, where the plain version rounds the
//   dequantised prefix to bf16 (a difference inside the bf16 tolerance);
// - an fp32 operand (q, p, and the K / V of an fp32 segment) is three bf16
//   terms hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose
//   sum is x exactly for normal values (ref.split_terms); of the products
//   of two split operands, the pairs of term indices i + j < 3 are taken
//   (the dropped ones are below 2^-24 of the product), of a split operand
//   with an exact one all three. Each product of two bf16 terms is exact
//   in fp32, so fp32 results depart from the plain version in the order of
//   the sums and in 2^-24 relative terms, with no TF32 anywhere. A bf16 q
//   rounds P to bf16 before P V, as flash_tc_kernel does.
//
// What bounds it: at the serving shapes, latency. The shared-prefix
// prefill of the paged INT8 path has one query block per (bh): 112 blocks
// of 5 tiles. So a block is two warpgroups on the same 64 query rows, each
// taking every other K / V tile with its own running (m, l, O) and its own
// staged tiles: its 128 threads load a tile into registers (all loads
// before any store; int8 and bf16 tiles during the products of the tile
// before, the first beside Q), then widen or split it into shared memory
// between two named barriers; warpgroup 1 hands its state to warpgroup
// 0 through shared memory at the end, merged in that fixed order (no
// atomics: two calls give equal bits). Shared memory: Q terms, two
// warpgroups' K and V terms (three at most), scales, the merge area: 140
// KB with fp32 operands, one block an SM.
namespace tm {

constexpr int NWG = 2;              // warpgroups a block, on the same rows
constexpr int THREADS = NWG * 128;
constexpr int TILE = 64 * 128;      // one swizzled [64][64] bf16 tile

template <typename S>
__host__ __device__ constexpr int n_terms() {
  return std::is_same<S, float>::value ? 3 : 1;
}
// the shared-memory layout of one instance
template <typename T, typename PK, typename K>
struct Geom {
  static constexpr int QT = n_terms<T>();
  static constexpr int KT = n_terms<PK>() > n_terms<K>() ? n_terms<PK>()
                                                         : n_terms<K>();
  // Q terms at 0; warpgroup w's K terms at kv + w * 2 * KT * TILE, its V
  // terms after them
  static constexpr int kv = QT * TILE;
  static constexpr int sc = kv + NWG * 2 * KT * TILE;  // [NWG][k, v][64] f32
  static constexpr int mg = sc + NWG * 2 * 64 * 4;     // [36][128] f32
  static constexpr int bytes = mg + 36 * 128 * 4 + 1024;  // + 1024: alignment
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
// byte e of the biased word u (each int8 byte xor 0x80) as an exact float
__device__ __forceinline__ float q8_float(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}
// two exact floats -> one bf16x2 (lo in the low half): their top halves
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// 8 int8 values -> 8 bf16 (exact)
__device__ __forceinline__ uint4 widen8(uint2 u) {
  const uint32_t w0 = u.x ^ 0x80808080u, w1 = u.y ^ 0x80808080u;
  return make_uint4(bf16x2_hi(q8_float(w0, 0), q8_float(w0, 1)),
                    bf16x2_hi(q8_float(w0, 2), q8_float(w0, 3)),
                    bf16x2_hi(q8_float(w1, 0), q8_float(w1, 1)),
                    bf16x2_hi(q8_float(w1, 2), q8_float(w1, 3)));
}
// (x0, x1) as N bf16x2 words: the first N of hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid) (each subtraction is exact)
template <int N>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&w)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    w[t] = *reinterpret_cast<const uint32_t*>(&v);
    if (t + 1 < N) {
      const float2 f = __bfloat1622float2(v);
      x0 -= f.x;
      x1 -= f.y;
    }
  }
}

// The 16-byte chunks of rows [row0, row0 + 64) of a [*, D] tensor
// stored as S, padded to 64 dims, that thread idx of NT takes (chunk idx +
// n NT: row i / 8, dims 8 (i % 8) ..), loaded into registers (rows at or
// past lim and dims past D are zeros, not read), then written as n_terms<S>() swizzled bf16 tiles at
// dst (term t at dst + t * TILE; 16-byte chunk c of row r at (c ^ (r %
// 8)) * 16, as flash_tc_kernel's load_rows lays them): int8 widened,
// fp32 split. A tile's loads are all issued before any store, so a
// thread waits on device memory once a tile.
template <typename S, int NT, int D>
struct Chunks {
  static constexpr int N = 64 * 8 / NT;
  // one chunk's raw bytes: 8 int8, 8 bf16 or 8 fp32
  using Raw = typename std::conditional<
      std::is_same<S, int8_t>::value, uint2,
      typename std::conditional<std::is_same<S, float>::value, float4[2],
                                uint4>::type>::type;
  Raw raw[N];

  __device__ __forceinline__ void load(const S* src, int row0, int lim,
                                       int idx) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = idx + n * NT, r = i >> 3, c = i & 7;
      const bool ok = row0 + r < lim && c * 8 < D;
      const S* p = src + (long long)(row0 + r) * D + c * 8;
      if constexpr (std::is_same<S, int8_t>::value) {
        raw[n] = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      } else if constexpr (std::is_same<S, float>::value) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        raw[n][0] = ok ? __ldg(reinterpret_cast<const float4*>(p)) : z;
        raw[n][1] = ok ? __ldg(reinterpret_cast<const float4*>(p) + 1) : z;
      } else {
        raw[n] = ok ? __ldg(reinterpret_cast<const uint4*>(p))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* dst, int idx) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = idx + n * NT, r = i >> 3, c = i & 7;
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      if constexpr (std::is_same<S, int8_t>::value) {
        *reinterpret_cast<uint4*>(dst + off) = widen8(raw[n]);
      } else if constexpr (std::is_same<S, float>::value) {
        uint32_t w[4][3];
        split2<3>(raw[n][0].x, raw[n][0].y, w[0]);
        split2<3>(raw[n][0].z, raw[n][0].w, w[1]);
        split2<3>(raw[n][1].x, raw[n][1].y, w[2]);
        split2<3>(raw[n][1].z, raw[n][1].w, w[3]);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          *reinterpret_cast<uint4*>(dst + t * TILE + off) =
              make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
      } else {
        *reinterpret_cast<uint4*>(dst + off) = raw[n];
      }
    }
  }
};

// the prefix segment's tile registers: its own pair of chunks where its
// storage differs from the main segment's, else none (it shares theirs)
template <typename PK, typename K, int D>
struct PrefixChunks {
  Chunks<PK, 128, D> k, v;
};
template <typename K, int D>
struct PrefixChunks<K, K, D> {};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One warpgroup's update from one staged tile: QT terms of q, KT of K and
// V (Q8: int8 with scales). s[4 jb + e] is key t0 + 8 jb + 2 t4 + (e & 1)
// of row qi0 + 8 (e >> 1); m is in log2 units, as in flash_tc_kernel.
template <int QT, int KT, bool Q8, int D>
__device__ __forceinline__ void tile_update(
    float (&o)[32], float (&m)[2], float (&l)[2], uint32_t q_s, uint32_t k_s,
    uint32_t v_s, const float* ksc, const float* vsc, const Args& a, bool pre,
    int t0, int q0, int qi0, int t4, float sl2, int tn) {
  constexpr int NQK = QT > KT ? QT : KT;  // term pairs i + j < NQK
  constexpr int PT = QT;                  // terms of p
  constexpr int NPV = PT > KT ? PT : KT;
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int sum = NQK - 1; sum >= 0; --sum)  // the smallest products first
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int j = sum - i;
      if (j < 0 || j >= KT) continue;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // the k-steps that hold dims < D
        tc::wgmma_ss_n64(s, tc::smem_desc(q_s + i * TILE + kk * 32, 16, 1024),
                         tc::smem_desc(k_s + j * TILE + kk * 32, 16, 1024));
    }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(s);

  if constexpr (Q8) {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] *= ksc[8 * (j / 4) + 2 * t4 + (j & 1)];
  }
  bool edge;
  if (pre)
    edge = t0 + 64 > a.pre_len;
  else
    edge = t0 + 64 > tn || (a.causal && t0 + 63 > q0 && t0 + 64 > a.bidir) ||
           (a.window && t0 <= q0 + 63 - a.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kp = t0 + 8 * (j / 4) + 2 * t4 + (j & 1);
      const int qi = qi0 + 8 * ((j >> 1) & 1);
      const bool ok = pre ? kp < a.pre_len : visible(a, kp, qi, tn);
      s[j] = ok ? s[j] : -INFINITY;
    }
  }

  // online softmax, as flash_tc_kernel's
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(m[h], mx[h] * sl2);
    alpha[h] = tc::ex2(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < 32; ++j) o[j] *= alpha[(j >> 1) & 1];
  }
  uint32_t pa[PT][4][4];
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int h = (j >> 1) & 1;
    float p0 = tc::ex2(fmaf(s[j], sl2, -m[h]));
    float p1 = tc::ex2(fmaf(s[j + 1], sl2, -m[h]));
    l[h] += p0 + p1;
    if constexpr (Q8) {
      const int kp = 8 * (j / 4) + 2 * t4;
      p0 *= vsc[kp];
      p1 *= vsc[kp + 1];
    }
    uint32_t w[PT];
    split2<PT>(p0, p1, w);
#pragma unroll
    for (int t = 0; t < PT; ++t) pa[t][j / 8][(j % 8) / 2] = w[t];
  }

  tc::wgmma_fence();
#pragma unroll
  for (int sum = NPV - 1; sum >= 0; --sum)
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int j = sum - i;
      if (j < 0 || j >= KT) continue;
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        tc::wgmma_rs_n64(o, pa[i][kj],
                         tc::smem_desc(v_s + j * TILE + kj * 16 * 128, 64 * 128, 1024));
    }
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(o);
#pragma unroll
  for (int t = 0; t < PT; ++t) tc::fence_regs(pa[t]);
}

}  // namespace tm

template <typename T, typename PK, typename K, int D>
__global__ void __launch_bounds__(tm::THREADS, 1) flash_terms_kernel(const Args a) {
  using G = tm::Geom<T, PK, K>;
  static_assert(tm::NWG == 2, "the merge below takes two warpgroups");
  constexpr int TILE = tm::TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = tc::smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t sm_s = tc::smem_u32(sm);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4, wt = tid & 127;
  const int g = lane >> 2, t4 = lane & 3;
  const Rows<T, PK, K, D> r(a, blockIdx.y);
  const int S = a.S, Tn = valid_keys(a, blockIdx.y), pre_len = a.pre_len;
  // causal: the longest query blocks first
  const int qb = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * 64;

  // the tiles: prefix keys [0, pre_len), then main keys [kv_begin, kv_end)
  const int n_pre = (pre_len + 63) / 64;
  const int kv_end = main_end(a, Tn, q0, 64);
  int kv_begin = 0;
  if (a.window) {
    const int first = q0 - a.window + 1;
    kv_begin = first > 0 ? first / 64 * 64 : 0;
  }
  const int n_tiles = n_pre + max(0, (kv_end - kv_begin + 63) / 64);

  float o[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * tc::LOG2E;
  const int qi0 = q0 + (warp % 4) * 16 + g;  // this thread's rows: qi0, + 8
  const int kv = G::kv + wg * 2 * G::KT * TILE;
  unsigned char* kbuf = sm + kv;
  unsigned char* vbuf = kbuf + G::KT * TILE;
  float* ksc = reinterpret_cast<float*>(sm + G::sc) + wg * 128;
  float* vsc = ksc + 64;

  // A tile's K / V chunks and, for int8, the one scale a thread stages
  // (thread wt: k_scale of key wt, or v_scale of key wt - 64; 0 past the
  // segment's end, where a scale is never read). Loaded into registers,
  // then stored as terms once the warpgroup's buffers are free.
  tm::Chunks<K, 128, D> kc, vc;
  tm::PrefixChunks<PK, K, D> pc;
  constexpr bool SHARED = std::is_same<PK, K>::value;
  float scv = 0.f;
  const int j64 = wt & 63;
  auto tile_t0 = [&](int i) {
    return i < n_pre ? i * 64 : kv_begin + (i - n_pre) * 64;
  };
  auto load_tile = [&](int i) {
    const int t0 = tile_t0(i);
    if (i < n_pre) {
      if constexpr (SHARED) {
        kc.load(r.pk, t0, pre_len, wt);
        vc.load(r.pv, t0, pre_len, wt);
      } else {
        pc.k.load(r.pk, t0, pre_len, wt);
        pc.v.load(r.pv, t0, pre_len, wt);
      }
      if constexpr (is_q8<PK>)
        scv = t0 + j64 < pre_len ? (wt < 64 ? r.pks : r.pvs)[t0 + j64] : 0.f;
    } else {
      kc.load(r.k, t0, Tn, wt);
      vc.load(r.v, t0, Tn, wt);
      if constexpr (is_q8<K>)
        scv = t0 + j64 < Tn ? (wt < 64 ? r.ks : r.vs)[t0 + j64] : 0.f;
    }
  };
  auto store_tile = [&](int i) {
    if (i < n_pre) {
      if constexpr (SHARED) {
        kc.store(kbuf, wt);
        vc.store(vbuf, wt);
      } else {
        pc.k.store(kbuf, wt);
        pc.v.store(vbuf, wt);
      }
      if constexpr (is_q8<PK>) (wt < 64 ? ksc : vsc)[j64] = scv;
    } else {
      kc.store(kbuf, wt);
      vc.store(vbuf, wt);
      if constexpr (is_q8<K>) (wt < 64 ? ksc : vsc)[j64] = scv;
    }
  };
  // int8 and bf16 tiles (8 or 16 registers a matrix) are loaded during the
  // products of the tile before; fp32 ones (32) after them, registers
  // being short there
  auto ahead = [&](int i) {
    return i < n_pre ? sizeof(PK) < 4 : sizeof(K) < 4;
  };

  // Q terms, loaded beside the warpgroup's first tile
  {
    tm::Chunks<T, tm::THREADS, D> qc;
    qc.load(r.q, q0, S, tid);
    if (wg < n_tiles) load_tile(wg);
    qc.store(sm, tid);
  }
  tc::fence_proxy_async();
  __syncthreads();

  // warpgroup wg takes tiles wg, wg + 2, ...
  for (int i = wg; i < n_tiles; i += tm::NWG) {
    const bool pre = i < n_pre;
    const int t0 = tile_t0(i);
    tm::wg_sync(wg);  // the warpgroup's products of its last tile are done
    store_tile(i);
    tc::fence_proxy_async();
    tm::wg_sync(wg);
    const int next = i + tm::NWG;
    if (next < n_tiles && ahead(next)) load_tile(next);
    if (pre)
      tm::tile_update<G::QT, tm::n_terms<PK>(), is_q8<PK>, D>(
          o, m, l, sm_s, sm_s + kv, sm_s + kv + G::KT * TILE, ksc, vsc, a,
          true, t0, q0, qi0, t4, sl2, Tn);
    else
      tm::tile_update<G::QT, tm::n_terms<K>(), is_q8<K>, D>(
          o, m, l, sm_s, sm_s + kv, sm_s + kv + G::KT * TILE, ksc, vsc, a,
          false, t0, q0, qi0, t4, sl2, Tn);
    if (next < n_tiles && !ahead(next)) load_tile(next);
  }

  // the quad's partial sums; warpgroup 1's state to warpgroup 0, merged
  // as (wg 0) * 2^(m0 - m) + (wg 1) * 2^(m1 - m)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* mg = reinterpret_cast<float*>(sm + G::mg);  // [36][128]
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 32; ++j) mg[j * 128 + wt] = o[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mg[(32 + h) * 128 + wt] = m[h];
      mg[(34 + h) * 128 + wt] = l[h];
    }
  }
  __syncthreads();
  if (wg != 0) return;
  float w0[2], w1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = mg[(32 + h) * 128 + wt];
    const float mm = fmaxf(m[h], m1);
    w0[h] = tc::ex2(m[h] - mm);
    w1[h] = tc::ex2(m1 - mm);
    l[h] = fmaxf(l[h] * w0[h] + mg[(34 + h) * 128 + wt] * w1[h], 1e-30f);
    FLASH_LSE_STORE(t4 == 0 && qi0 + 8 * h < S, qi0 + 8 * h,
                    (mm + tc::lg2(l[h])) * tc::LN2)
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    o[j] = o[j] * w0[(j >> 1) & 1] + mg[j * 128 + wt] * w1[(j >> 1) & 1];
  // o[4 jb + 2 h + e]: dim 8 jb + 2 t4 + e of row qi0 + 8 h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    if (qi >= S) continue;
    T* ob = r.o + (long long)qi * D + 2 * t4;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      tm::store2(ob + jb * 8, o[4 * jb + 2 * h] / l[h], o[4 * jb + 2 * h + 1] / l[h]);
  }
}

// a pointer that cp.async may copy 16 bytes from (null: not used)
bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename PK, typename K, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  using B = __nv_bfloat16;
  if constexpr (std::is_same<T, B>::value && std::is_same<PK, B>::value &&
                std::is_same<K, B>::value) {
    if (!on16(a.q) || !on16(a.k) || !on16(a.v) || !on16(a.o) ||
        !on16(a.pk) || !on16(a.pv))
      return cudaErrorMisalignedAddress;
    constexpr size_t bytes = tc::smem_bytes(D);
    static size_t allowed = 48 * 1024;
    if (bytes > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          tc::flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return e;
      allowed = bytes;
    }
    const dim3 grid((a.S + tc::bq(D) - 1) / tc::bq(D), a.BH);
    tc::flash_tc_kernel<D><<<grid, tc::threads(D), bytes, stream>>>(a);
  } else if constexpr (D <= 64) {
    if (!on16(a.q) || !on16(a.k) || !on16(a.v) || !on16(a.o) ||
        !on16(a.pk) || !on16(a.pv))
      return cudaErrorMisalignedAddress;
    constexpr int bytes = tm::Geom<T, PK, K>::bytes;
    static bool sized = false;
    if (!sized) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_terms_kernel<T, PK, K, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      sized = true;
    }
    const dim3 grid((a.S + 63) / 64, a.BH);
    flash_terms_kernel<T, PK, K, D><<<grid, tm::THREADS, bytes, stream>>>(a);
  } else {
    constexpr int TPR = D / 32;  // 8 float4 chunks of q and of acc a thread
    const dim3 grid((a.S + SPLIT_ROWS - 1) / SPLIT_ROWS, a.BH);
    flash_split_kernel<T, PK, K, D, TPR>
        <<<grid, SPLIT_ROWS * TPR, 0, stream>>>(a);
  }
  return cudaSuccess;
}

template <typename T, typename PK, typename K>
cudaError_t launch_dims(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, PK, K, 16>(a, s);
    case 32: return launch_d<T, PK, K, 32>(a, s);
    case 64: return launch_d<T, PK, K, 64>(a, s);
    case 128: return launch_d<T, PK, K, 128>(a, s);
    case 256: return launch_d<T, PK, K, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

#ifndef FLASH_TRAIN
// dtype: 0 = float32, 1 = bfloat16 (q, o and every fp segment); the
// three storage variants: fp everywhere, an int8 main segment, an int8
// prefix.
int run(const Args& a, int D, int dtype, bool q8_main, bool q8_prefix,
        void* stream) {
  if (a.BH <= 0 || a.S <= 0 || a.T <= 0 || a.pre_len < 0
      || a.pre_len > a.pre_span || a.bidir < 0 || (a.bidir && !a.causal)
      || (a.kv_len && (a.heads <= 0 || a.BH % a.heads)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    e = q8_main ? launch_dims<float, float, int8_t>(a, D, s)
        : q8_prefix ? launch_dims<float, int8_t, float>(a, D, s)
                    : launch_dims<float, float, float>(a, D, s);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    e = q8_main ? launch_dims<B, B, int8_t>(a, D, s)
        : q8_prefix ? launch_dims<B, int8_t, B>(a, D, s)
                    : launch_dims<B, B, B>(a, D, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifndef FLASH_TRAIN
// D in {16, 32, 64, 128, 256}; all tensors contiguous. Each entry returns
// the cudaError_t of its launch (0 = success).

// fp: q, k, v and o of one dtype. kv_len: null, or [BH / heads] int32
// valid keys per batch row (heads rows bh each); bidir: with causal, the
// prefix-LM's bidirectional prefix (0: none).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int S,
                                      int T_, int D, int causal, int window,
                                      const int* kv_len, int heads, int bidir,
                                      float scale, int dtype, void* stream) {
  const Args a{q, nullptr, nullptr, nullptr, nullptr, 0, 0, k, v, nullptr,
               nullptr, o, BH, S, T_, causal, window, scale, kv_len, heads,
               bidir};
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
               BH, S, T_, causal, window, scale, nullptr, 1, 0};
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
               nullptr, o, BH, S, S, 1, 0, scale, nullptr, 1, 0};
  return run(a, D, dtype, false, pks != nullptr, stream);
}

#else
// The training forward: flash_attention_launch over fp q, o [BH, S, D]
// and k, v [BH, T, D] of one dtype (0 = float32, 1 = bfloat16), causal or
// not (no window, lengths or prefix), that also writes lse [BH, S] f32,
// each row's natural log of the sum of exp(scale q k) over its visible
// keys. D = 64 or 128.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int BH, int S, int T_, int D,
                                          int causal, float scale, int dtype,
                                          void* stream) {
  if (!lse || BH <= 0 || S <= 0 || T_ <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, nullptr, nullptr, nullptr, nullptr, 0, 0, k, v, nullptr,
               nullptr, o, BH, S, T_, causal ? 1 : 0, 0, scale, nullptr, 1, 0,
               lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) e = launch_d<float, float, float, 64>(a, s);
  if (dtype == 0 && D == 128) e = launch_d<float, float, float, 128>(a, s);
  if (dtype == 1 && D == 64) e = launch_d<B, B, B, 64>(a, s);
  if (dtype == 1 && D == 128) e = launch_d<B, B, B, 128>(a, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
#endif

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
