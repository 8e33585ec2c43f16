// flash_attention_bwd: the gradient of causal fp attention,
// q, k, v, o, dO [BH, S, D] (keys at the query positions, T = S), D = 64
// or 128, from the forward's per-row log-sum-exp lse [BH, S] (natural
// log of the sum of exp(scale * q k) over the visible keys).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel,
// and jax.grad differentiates its jnp attention (repro/models/layers.py
// _attend_block). The port's forward runs flash_attention.cu on the card,
// so training there needs this kernel; it is FlashAttention-2's backward
// (Dao, 2023), recomputing P from lse instead of storing it:
//
// - bwd_prep_kernel: delta_i = sum_d dO_id O_id (f32), one warp a row;
// - dkdv kernel, one block per (key tile of 64, bh): dV_j += P^T dO_i and
//   dK_j += scale dS^T Q_i over the query tiles i from the diagonal on,
//   with P = exp(scale S - lse) and dS = P (dO V^T - delta);
// - dq kernel, one block per (query tile of 64, bh): dQ_i += scale dS K_j
//   over the key tiles up to the diagonal.
//
// Each output element is summed by one thread in a fixed order: no
// atomics, so two calls give equal bits. Masked pairs (key past the
// query, query past S) take P = 0.
//
// Two instances per head dim:
//
// - bf16 on tensor cores: mma.sync m16n8k16 from ldmatrix. A warp owns 16
//   rows of the block's tile (keys in dkdv, queries in dq); the score and
//   dP accumulators of a tile stay in registers, and P^T (dkdv) or dS (dq)
//   converted to bf16 is the A operand of the next product straight from
//   the accumulator layout. Tiles sit in shared memory as rows of D bf16
//   with 16-byte chunk c of row r at c ^ (r % 8), so each ldmatrix (eight
//   rows of one chunk column) hits eight different bank groups; Q / dO
//   (dkdv) or K / V (dq) stream through a two-stage cp.async ring. P and
//   dS are rounded to bf16 before their products, as the forward rounds P.
// - fp32 on CUDA cores (the card-vs-CPU parity path): 8 threads share a
//   row (key in dkdv, query in dq), each owning D / 8 dims as float4
//   chunks; the row's dots are summed by warp shuffles; the other side's
//   tiles of 16 rows are staged in shared memory.
//
// What bounds it on the H100: the five products of the gradient (S, dP,
// dV, dK, dQ; S and dP are computed in both kernels, 7 in all) are 2 D
// flops per visible pair each, against reading q, k, v, o, dO and lse
// once and writing dq, dk, dv. At qwen1.5-0.5b's training shape ([128,
// 512, 64] causal, bf16) that is 0.011 ms at the tensor-core peak and
// 0.020 ms of bytes: the bytes bound it. This first kernel takes mma.sync
// and a two-stage ring; wgmma and TMA are later work.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [BH, S]
  float* delta;      // [BH, S], written by bwd_prep_kernel
  void* dq;
  void* dk;
  void* dv;
  int BH, S;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_prep_kernel(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.BH * a.S) return;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* g = static_cast<const T*>(a.dout) + row * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// ---- bf16: mma.sync on tensor cores -------------------------------------
namespace tcb {

using B = __nv_bfloat16;
constexpr int ROWS = 64;      // rows of a block's own tile (4 warps x 16)
constexpr int THREADS = 128;
// rows of the streamed tiles: 64, 32 at D = 128 in dkdv (registers)
__host__ __device__ constexpr int kv_rows(int d) { return d == 128 ? 32 : 64; }
__host__ __device__ constexpr int tile_bytes(int rows, int d) { return rows * d * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a swizzled [*, D] tile
template <int D>
__device__ __forceinline__ uint32_t off(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// rows [row0, row0 + ROWS_) of a [*, D] bf16 tensor into the tile at
// dst; rows at or past lim are zero-filled, not read
template <int D, int ROWS_>
__device__ __forceinline__ void load_tile(uint32_t dst, const B* src,
                                          int row0, int lim) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS_ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < lim;
    cp_async16(dst + off<D>(r, c),
               ok ? src + (long long)(row0 + r) * D + c * 8 : src, ok ? 16 : 0);
  }
}

// acc[N / 8][4] += A [16 rows from arow0 of tile a] x B^T, B the N rows
// from row 0 of tile b (both [*, D], the contraction over D): A row-major,
// B read as [n][k] (no transpose)
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], uint32_t a,
                                        int arow0, uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + off<D>(arow0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t fb[4];
      ldsm_x4(fb, b + off<D>(nb * 16 + (lane & 7) + ((lane >> 4) << 3),
                             2 * kk + ((lane >> 3) & 1)));
      mma(acc[2 * nb], fa, fb[0], fb[1]);
      mma(acc[2 * nb + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[D / 8][4] += P [16 x K] (registers, as m16n8 accumulators p[K / 8][4]
// rounded to bf16) x V [K rows of tile b, D]: B read as [k][n] (ldmatrix
// .trans)
template <int D, int K>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[K / 8][4], uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kq = 0; kq < K / 16; ++kq) {
    const uint32_t fa[4] = {pack(p[2 * kq][0], p[2 * kq][1]),
                            pack(p[2 * kq][2], p[2 * kq][3]),
                            pack(p[2 * kq + 1][0], p[2 * kq + 1][1]),
                            pack(p[2 * kq + 1][2], p[2 * kq + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t fb[4];
      ldsm_x4_t(fb, b + off<D>(kq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                               2 * nd + (lane >> 4)));
      mma(acc[2 * nd], fa, fb[0], fb[1]);
      mma(acc[2 * nd + 1], fa, fb[2], fb[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc[D / 8][4] (rows r0 + g, r0 + g + 8 of a warp, dims 8 nt + 2 t4 + e)
// times scale, stored as bf16 pairs for rows below lim
template <int D>
__device__ __forceinline__ void store_rows(B* dst, const float (&acc)[D / 8][4],
                                           int r0, int lim, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= lim) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * D + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
  }
}

// dK, dV of 64 keys: the warp's 16 keys against every query tile of BQ
// from the diagonal on
template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_tc_kernel(const BwdArgs a) {
  constexpr int BQ = kv_rows(D);
  constexpr int KT = tile_bytes(ROWS, D), QT = tile_bytes(BQ, D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw), v_s = k_s + KT;
  const uint32_t q_s = v_s + KT;             // stage st: Q at q_s + 2 st QT, dO after it
  float* lse_s = reinterpret_cast<float*>(smem_raw + 2 * KT + 4 * QT);  // [2][BQ]
  float* del_s = lse_s + 2 * BQ;                                         // [2][BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = a.S;
  const long long base = (long long)blockIdx.y * S;
  const B* q = static_cast<const B*>(a.q) + base * D;
  const B* k = static_cast<const B*>(a.k) + base * D;
  const B* v = static_cast<const B*>(a.v) + base * D;
  const B* dout = static_cast<const B*>(a.dout) + base * D;
  const float* lse = a.lse + base;
  const float* delta = a.delta + base;
  const int k0 = blockIdx.x * ROWS;
  const int i_first = k0 / BQ, i_end = (S + BQ - 1) / BQ;
  const float sl2 = a.scale * LOG2E;

  auto prefetch = [&](int i, int st) {
    const int r0 = i * BQ;
    load_tile<D, BQ>(q_s + 2 * st * QT, q, r0, S);
    load_tile<D, BQ>(q_s + (2 * st + 1) * QT, dout, r0, S);
    for (int t = threadIdx.x; t < BQ; t += THREADS) {
      const bool ok = r0 + t < S;
      lse_s[st * BQ + t] = ok ? lse[r0 + t] * LOG2E : 0.f;
      del_s[st * BQ + t] = ok ? delta[r0 + t] : 0.f;
    }
  };
  load_tile<D, ROWS>(k_s, k, k0, S);
  load_tile<D, ROWS>(v_s, v, k0, S);
  prefetch(i_first, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const int kw = warp * 16;  // the warp's keys in the tile
  for (int i = i_first; i < i_end; ++i) {
    const int st = (i - i_first) & 1;
    if (i + 1 < i_end) prefetch(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = i * BQ;
    const uint32_t qt = q_s + 2 * st * QT, dot = qt + QT;
    // the warp's keys all lie past this tile's queries: nothing to add
    if (k0 + kw <= q0 + BQ - 1) {
      float s[BQ / 8][4], dp[BQ / 8][4];
      zero(s);
      zero(dp);
      mma_abt<D, BQ>(s, k_s, kw, qt);    // S^T = K Q^T
      mma_abt<D, BQ>(dp, v_s, kw, dot);  // dP^T = V dO^T
      // s[nt][e]: key k0 + kw + g + 8 (e >> 1), query q0 + 8 nt + 2 t4 + (e & 1)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + kw + g + 8 * (e >> 1);
          const int qc = 8 * nt + 2 * t4 + (e & 1);
          const bool ok = kp <= q0 + qc && q0 + qc < S;
          const float p = ok ? ex2(fmaf(s[nt][e], sl2, -lse_s[st * BQ + qc])) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - del_s[st * BQ + qc]);
        }
      mma_pv<D, BQ>(dv, s, dot);   // dV += P^T dO
      mma_pv<D, BQ>(dk, dp, qt);   // dK += dS^T Q
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<B*>(a.dk) + base * D, dk, k0 + kw, S, a.scale);
  store_rows<D>(static_cast<B*>(a.dv) + base * D, dv, k0 + kw, S, 1.f);
}

// dQ of 64 queries: the warp's 16 queries against every key tile up to
// the diagonal
template <int D>
__global__ void __launch_bounds__(THREADS) dq_tc_kernel(const BwdArgs a) {
  constexpr int BK = ROWS;
  constexpr int QT = tile_bytes(ROWS, D), KT = tile_bytes(BK, D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw), do_s = q_s + QT;
  const uint32_t kv_s = do_s + QT;  // stage st: K at kv_s + 2 st KT, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = a.S;
  const long long base = (long long)blockIdx.y * S;
  const B* k = static_cast<const B*>(a.k) + base * D;
  const B* v = static_cast<const B*>(a.v) + base * D;
  // the longest query tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int qw = warp * 16;
  const int j_end = min((S + BK - 1) / BK, (q0 + ROWS + BK - 1) / BK);
  const float sl2 = a.scale * LOG2E;

  load_tile<D, ROWS>(q_s, static_cast<const B*>(a.q) + base * D, q0, S);
  load_tile<D, ROWS>(do_s, static_cast<const B*>(a.dout) + base * D, q0, S);
  load_tile<D, BK>(kv_s, k, 0, S);
  load_tile<D, BK>(kv_s + KT, v, 0, S);
  cp_async_commit();
  // this thread's rows: q0 + qw + g (h = 0) and + 8 (h = 1)
  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + qw + g + 8 * h;
    lse2[h] = r < S ? a.lse[base + r] * LOG2E : 0.f;
    del[h] = r < S ? a.delta[base + r] : 0.f;
  }

  float dq[D / 8][4];
  zero(dq);
  for (int j = 0; j < j_end; ++j) {
    const int st = j & 1;
    if (j + 1 < j_end) {
      load_tile<D, BK>(kv_s + 2 * (st ^ 1) * KT, k, (j + 1) * BK, S);
      load_tile<D, BK>(kv_s + (2 * (st ^ 1) + 1) * KT, v, (j + 1) * BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = j * BK;
    const uint32_t kt = kv_s + 2 * st * KT, vt = kt + KT;
    if (t0 <= q0 + qw + 15) {  // some key of the tile is visible to the warp
      float s[BK / 8][4], dp[BK / 8][4];
      zero(s);
      zero(dp);
      mma_abt<D, BK>(s, q_s, qw, kt);    // S = Q K^T
      mma_abt<D, BK>(dp, do_s, qw, vt);  // dP = dO V^T
      // s[nt][e]: query q0 + qw + g + 8 (e >> 1), key t0 + 8 nt + 2 t4 + (e & 1)
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = q0 + qw + g + 8 * h;
          const int kp = t0 + 8 * nt + 2 * t4 + (e & 1);
          const bool ok = kp <= qi && qi < S;
          const float p = ok ? ex2(fmaf(s[nt][e], sl2, -lse2[h])) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - del[h]);
        }
      mma_pv<D, BK>(dq, dp, kt);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(static_cast<B*>(a.dq) + base * D, dq, q0 + qw, S, a.scale);
}

template <int D>
int dkdv_smem() {
  return 2 * tile_bytes(ROWS, D) + 4 * tile_bytes(kv_rows(D), D) +
         4 * kv_rows(D) * 4;
}
template <int D>
int dq_smem() {
  return 2 * tile_bytes(ROWS, D) + 4 * tile_bytes(ROWS, D);
}

}  // namespace tcb

// ---- fp32: CUDA cores ----------------------------------------------------
namespace fpb {

constexpr int TPR = 8;      // threads a row
constexpr int RB = 16;      // rows a block (128 threads)
constexpr int OT = 16;      // rows of the other side's staged tile
constexpr int THREADS = RB * TPR;

// the D / (4 TPR) float4 chunks of row r that thread `lane` of the row
// owns: chunk c is dims 4 (c TPR + lane) .. + 3
template <int D>
__device__ __forceinline__ void load_row(float4 (&x)[D / 4 / TPR],
                                         const float* src, int lane, bool ok) {
#pragma unroll
  for (int c = 0; c < D / 4 / TPR; ++c)
    x[c] = ok ? reinterpret_cast<const float4*>(src)[c * TPR + lane]
              : make_float4(0.f, 0.f, 0.f, 0.f);
}
template <int D>
__device__ __forceinline__ float dot_row(const float4 (&x)[D / 4 / TPR],
                                         const float* row, int lane) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4 / TPR; ++c) {
    const float4 y = reinterpret_cast<const float4*>(row)[c * TPR + lane];
    s = fmaf(x[c].x, y.x, s);
    s = fmaf(x[c].y, y.y, s);
    s = fmaf(x[c].z, y.z, s);
    s = fmaf(x[c].w, y.w, s);
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}
template <int D>
__device__ __forceinline__ void axpy_row(float4 (&acc)[D / 4 / TPR], float w,
                                         const float* row, int lane) {
#pragma unroll
  for (int c = 0; c < D / 4 / TPR; ++c) {
    const float4 y = reinterpret_cast<const float4*>(row)[c * TPR + lane];
    acc[c].x = fmaf(w, y.x, acc[c].x);
    acc[c].y = fmaf(w, y.y, acc[c].y);
    acc[c].z = fmaf(w, y.z, acc[c].z);
    acc[c].w = fmaf(w, y.w, acc[c].w);
  }
}
template <int D>
__device__ __forceinline__ void store_row(float* dst,
                                          const float4 (&acc)[D / 4 / TPR],
                                          int lane, float scale) {
#pragma unroll
  for (int c = 0; c < D / 4 / TPR; ++c)
    reinterpret_cast<float4*>(dst)[c * TPR + lane] =
        make_float4(acc[c].x * scale, acc[c].y * scale, acc[c].z * scale,
                    acc[c].w * scale);
}
// rows [r0, r0 + OT) of two [*, D] tensors into shared memory (zeros past lim)
template <int D>
__device__ __forceinline__ void stage(float (*xs)[D], float (*ys)[D],
                                      const float* x, const float* y, int r0,
                                      int lim) {
  for (int i = threadIdx.x; i < OT * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = i % (D / 4);
    const bool ok = r0 + r < lim;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(xs[r])[c] =
        ok ? reinterpret_cast<const float4*>(x + (long long)(r0 + r) * D)[c] : z;
    reinterpret_cast<float4*>(ys[r])[c] =
        ok ? reinterpret_cast<const float4*>(y + (long long)(r0 + r) * D)[c] : z;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_fp_kernel(const BwdArgs a) {
  constexpr int C = D / 4 / TPR;
  __shared__ __align__(16) float qs[OT][D];
  __shared__ __align__(16) float gs[OT][D];
  __shared__ float ls[OT], ds[OT];
  const int S = a.S;
  const long long base = (long long)blockIdx.y * S;
  const float* q = static_cast<const float*>(a.q) + base * D;
  const float* dout = static_cast<const float*>(a.dout) + base * D;
  const int lane = threadIdx.x % TPR;
  const int k0 = blockIdx.x * RB;
  const int kp = k0 + threadIdx.x / TPR;  // this thread's key
  const bool row_ok = kp < S;
  float4 kr[C], vr[C], dk[C], dv[C];
  load_row<D>(kr, static_cast<const float*>(a.k) + (base + kp) * D, lane, row_ok);
  load_row<D>(vr, static_cast<const float*>(a.v) + (base + kp) * D, lane, row_ok);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[c] = dk[c];
  }
  for (int q0 = k0 / OT * OT; q0 < S; q0 += OT) {
    stage<D>(qs, gs, q, dout, q0, S);
    for (int t = threadIdx.x; t < OT; t += THREADS) {
      const bool ok = q0 + t < S;
      ls[t] = ok ? a.lse[base + q0 + t] : 0.f;
      ds[t] = ok ? a.delta[base + q0 + t] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < OT; ++r) {
      const float s = dot_row<D>(kr, qs[r], lane);
      const float dp = dot_row<D>(vr, gs[r], lane);
      const int qi = q0 + r;
      const float p = kp <= qi && qi < S ? expf(s * a.scale - ls[r]) : 0.f;
      axpy_row<D>(dv, p, gs[r], lane);
      axpy_row<D>(dk, p * (dp - ds[r]), qs[r], lane);
    }
    __syncthreads();
  }
  if (row_ok) {
    store_row<D>(static_cast<float*>(a.dk) + (base + kp) * D, dk, lane, a.scale);
    store_row<D>(static_cast<float*>(a.dv) + (base + kp) * D, dv, lane, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_fp_kernel(const BwdArgs a) {
  constexpr int C = D / 4 / TPR;
  __shared__ __align__(16) float ks[OT][D];
  __shared__ __align__(16) float vs[OT][D];
  const int S = a.S;
  const long long base = (long long)blockIdx.y * S;
  const float* k = static_cast<const float*>(a.k) + base * D;
  const float* v = static_cast<const float*>(a.v) + base * D;
  const int lane = threadIdx.x % TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * RB;  // the longest first
  const int qi = q0 + threadIdx.x / TPR;
  const bool row_ok = qi < S;
  float4 qr[C], gr[C], dq[C];
  load_row<D>(qr, static_cast<const float*>(a.q) + (base + qi) * D, lane, row_ok);
  load_row<D>(gr, static_cast<const float*>(a.dout) + (base + qi) * D, lane, row_ok);
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = row_ok ? a.lse[base + qi] : 0.f;
  const float del = row_ok ? a.delta[base + qi] : 0.f;
  const int t_end = min(S, q0 + RB);
  for (int t0 = 0; t0 < t_end; t0 += OT) {
    stage<D>(ks, vs, k, v, t0, S);
    __syncthreads();
    for (int r = 0; r < OT; ++r) {
      const float s = dot_row<D>(qr, ks[r], lane);
      const float dp = dot_row<D>(gr, vs[r], lane);
      const int kp = t0 + r;
      const float p = kp <= qi && row_ok ? expf(s * a.scale - lse) : 0.f;
      axpy_row<D>(dq, p * (dp - del), ks[r], lane);
    }
    __syncthreads();
  }
  if (row_ok)
    store_row<D>(static_cast<float*>(a.dq) + (base + qi) * D, dq, lane, a.scale);
}

}  // namespace fpb

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int D>
cudaError_t launch_d(const BwdArgs& a, int dtype, cudaStream_t s) {
  const long long rows = (long long)a.BH * a.S;
  const dim3 prep((unsigned)((rows + 7) / 8));
  if (dtype == 1) {
    using B = __nv_bfloat16;
    bwd_prep_kernel<B, D><<<prep, 256, 0, s>>>(a);
    static bool sized[2] = {false, false};
    const int b1 = tcb::dkdv_smem<D>(), b2 = tcb::dq_smem<D>();
    cudaError_t e = allow_smem(tcb::dkdv_tc_kernel<D>, b1, sized[0]);
    if (e != cudaSuccess) return e;
    e = allow_smem(tcb::dq_tc_kernel<D>, b2, sized[1]);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.S + tcb::ROWS - 1) / tcb::ROWS, a.BH);
    tcb::dkdv_tc_kernel<D><<<grid, tcb::THREADS, b1, s>>>(a);
    tcb::dq_tc_kernel<D><<<grid, tcb::THREADS, b2, s>>>(a);
  } else {
    bwd_prep_kernel<float, D><<<prep, 256, 0, s>>>(a);
    const dim3 grid((a.S + fpb::RB - 1) / fpb::RB, a.BH);
    fpb::dkdv_fp_kernel<D><<<grid, fpb::THREADS, 0, s>>>(a);
    fpb::dq_fp_kernel<D><<<grid, fpb::THREADS, 0, s>>>(a);
  }
  return cudaSuccess;
}

}  // namespace

// The causal backward: q, k, v, o, dout, dq, dk, dv [BH, S, D] of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned; lse
// [BH, S] f32 from flash_attention_lse_launch; delta [BH, S] f32
// scratch. D = 64 or 128. Launches three kernels in order on `stream`;
// returns the cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk,
                                          void* dv, int BH, int S, int D,
                                          float scale, int dtype,
                                          void* stream) {
  if (BH <= 0 || S <= 0 || (dtype != 0 && dtype != 1) || !lse || !delta)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!on16(p)) return (int)cudaErrorMisalignedAddress;
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64) e = launch_d<64>(a, dtype, s);
  else if (D == 128) e = launch_d<128>(a, dtype, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
