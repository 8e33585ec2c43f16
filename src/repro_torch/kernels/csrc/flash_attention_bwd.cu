// flash_attention_bwd: the gradient of fp attention, q, o, dO [BH, S, D]
// over k, v [BH, T, D], D = 64 or 128, from the forward's per-row
// log-sum-exp lse [BH, S] (natural log of the sum of exp(scale * q k)
// over the visible keys). causal: key kp visible to query qi when kp <=
// qi (positions from 0 on both sides; the decoder's and the dense
// family's self-attention, T = S); else every key (the encoder's
// bidirectional attention, T = S, and the decoder's cross-attention over
// T encoder positions).
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel,
// and jax.grad differentiates its jnp attention (repro/models/layers.py
// _attend_block). The port's forward runs flash_attention.cu on the card,
// so training there needs this kernel; it is FlashAttention-2's backward
// (Dao, 2023), recomputing P from lse instead of storing it:
//
// - bwd_prep_kernel: delta_i = sum_d dO_id O_id (f32), 16-byte loads,
//   D / 8 (bf16) or D / 4 (fp32) lanes a row;
// - dkdv kernel, one block per (key tile, bh): dV_j += P^T dO_i and
//   dK_j += scale dS^T Q_i over the query tiles i from the diagonal on
//   (causal) or over all of them, with P = exp(scale S - lse) and dS = P
//   (dO V^T - delta);
// - dq kernel, one block per (query tile, bh): dQ_i += scale dS K_j
//   over the key tiles up to the diagonal (causal) or over all T.
//
// Each output element is summed by one thread in a fixed order: no
// atomics, so two calls give equal bits. Masked pairs (key past the
// query where causal, query past S, key past T) take P = 0; tiles that
// cross S or T are masked element by element.
//
// Two instances per head dim:
//
// - bf16 on Hopper's warpgroup products (wgmma). A block is two consumer
//   warpgroups of 64 rows each (128 keys in dkdv, 128 queries in dq) and
//   one producer warpgroup, whose first warp loads every tile by TMA
//   (3-d tensor maps, rows past S read as zeros) into a ring of 4 stages
//   of 64-row tiles (Q and dO in dkdv, K and V in dq) on full / empty
//   mbarriers; blocks are persistent, one an SM, and at D = 64 load the
//   next item's own tiles while this one runs; the producer gives up its registers (setmaxnreg 24) so
//   that the consumers hold 240 each: at D = 128 a consumer keeps dK and
//   dV of its 64 keys (128 f32 a thread) beside S^T and dP^T (64). Tiles
//   lie in the 128-byte swizzle as 64-dim atoms of 128-byte rows. In
//   dkdv, S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major
//   from shared memory) put keys on the accumulator's rows, so P^T and
//   dS^T, rounded to bf16, are the register A operand of dV += P^T dO
//   and dK += dS^T Q (m64nDk16, dO and Q read MN-major); in dq, S = Q K^T
//   and dP = dO V^T make dS the A operand of dQ += dS K. P and dS are
//   rounded to bf16 before their products, as the forward rounds P.
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
// 0.020 ms of bytes: the bytes bound it. The 128-row own tiles halve the
// re-reads of the streamed side against 64-row ones, yet over the causal
// triangle each kernel still reads it 2.5 times (about 59 MB a kernel at
// that shape), and that traffic, not the products, sets most of the time
// (scripts/bwd_ablate.py times the kernels with their work taken out).
#include <cstdint>
#include <cuda.h>
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
  int BH, S, T;  // q, o, dO, dq: S rows a head; k, v, dk, dv: T rows
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// delta of 256 / L rows a block: L = D / V lanes a row read 16 bytes (V
// elements) of o and dO at a time, and sum across the row's lanes
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_prep_kernel(const BwdArgs a) {
  constexpr int V = 16 / sizeof(T), L = D / V <= 32 ? D / V : 32;
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / L;
  const int part = threadIdx.x % L;
  float s = 0.f;
  if (row < (long long)a.BH * a.S) {
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + row * D);
    const uint4* g = reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + row * D);
#pragma unroll
    for (int c = part; c < D / V; c += L) {
      const uint4 ou = o[c], gu = g[c];
      const uint32_t ow[4] = {ou.x, ou.y, ou.z, ou.w}, gw[4] = {gu.x, gu.y, gu.z, gu.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          s = fmaf(__uint_as_float(ow[i]), __uint_as_float(gw[i]), s);
        } else {
          s = fmaf(__uint_as_float(ow[i] << 16), __uint_as_float(gw[i] << 16), s);
          s = fmaf(__uint_as_float(ow[i] & 0xffff0000u),
                   __uint_as_float(gw[i] & 0xffff0000u), s);
        }
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0 && row < (long long)a.BH * a.S) a.delta[row] = s;
}

// ---- bf16: warpgroup products (wgmma), TMA ring, producer warpgroup ----
namespace wgb {

using B = __nv_bfloat16;
constexpr int CWG = 2;                  // consumer warpgroups a block
constexpr int THREADS = (CWG + 1) * 128;  // and one producer warpgroup
constexpr int OWN = CWG * 64;           // a block's own rows: 64 a consumer
constexpr int TILE = 64;                // rows of a streamed tile
constexpr int STAGES = 4;               // tiles in the ring
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// bytes of a [rows][D] bf16 tile: D / 64 swizzled atoms of rows x 128
__host__ __device__ constexpr int tile_bytes(int rows, int d) { return rows * d * 2; }
// the four [BH, S, D] inputs as TMA tensor maps (3-d: D, S, BH), boxes
// of 64 dims x 64 rows in the 128-byte swizzle; rows past S read as 0
struct alignas(64) Maps {
  CUtensorMap q, k, v, g;  // g: dO
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
      ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               ::"r"(bar) : "memory");
}
// until the phase of `parity` has completed (a fresh barrier's phase of
// parity 1 counts as completed: a producer's first wait on an empty
// stage passes)
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// one 64-dim x 64-row box of `map` at (d0, row, bh) into dst (1024-aligned)
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int d0, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
        "r"(row), "r"(bh) : "memory");
}
// rows [row0, row0 + ROWS) of head bh into the tile at dst: atom a (dims
// 64 a ..) at dst + a ROWS 128, 64 rows a box
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int at = 0; at < D / 64; ++at)
#pragma unroll
    for (int h = 0; h < ROWS / 64; ++h)
      tma_box(dst + at * ROWS * 128 + h * 64 * 128, map, bar, at * 64,
              row0 + h * 64, bh);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// a shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand at row block `rows0` (bytes into atom 0) of a tile of
// `rows` rows, k16 step j: atom j / 4, 32 bytes a step inside it
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int j) {
  return desc(tile + (j / 4) * (rows * 128) + (j % 4) * 32, 16, 1024);
}
// MN-major B operand (the contraction over the tile's rows), k16 step kj
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int rows, int kj) {
  return desc(tile + kj * 16 * 128, rows * 128, 1024);
}

// D += A B^T, m64n64k16, A and B K-major from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}
// D += A B, m64n64k16, A from registers, B MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// the same, m64n128k16
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// keep registers that an in-flight wgmma reads or writes alive and
// unmoved up to here (after its wait)
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
template <int N>
__device__ __forceinline__ void zero(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
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
// S [64 x 64] = A B^T over D (two K-major tiles: A rows at a in a tile of
// arows rows, B the brows-row tile b)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, int arows,
                                       uint32_t b, int brows) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wgmma_ss_n64(s, kdesc(a, arows, j), kdesc(b, brows, j));
}
// acc [64 x D] += P [64 x 64] (A fragments from registers) x the 64-row
// tile b (MN-major: the contraction over its rows)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) wgmma_rs(acc, pa[kj], mndesc(b, TILE, kj));
}
// the accumulator of rows r0 + g (+ 8) of a warp, dims 8 jb + 2 t4 + e,
// times scale, as bf16 pairs for rows below lim
template <int D>
__device__ __forceinline__ void store_rows(B* dst, const float (&acc)[D / 2],
                                           int r0, int lim, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= lim) continue;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * D + jb * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * jb + 2 * h] * scale,
                                acc[4 * jb + 2 * h + 1] * scale);
  }
}

// Persistent blocks: the items (head, block of OWN own rows) sorted from
// the most tiles to the fewest (item i: head i % BH, block i / BH), block
// b takes items b, 2 G - 1 - b, 2 G + b, ... (G blocks; the order turns
// each round so that long and short items pair up). Its own tiles sit in
// own_bufs(D) buffers, so that the next item's load while this one runs
// where two fit; the ring runs on across items.
__host__ __device__ constexpr int own_bufs(int d) { return d == 64 ? 2 : 1; }
__device__ __forceinline__ int item_of(int round) {
  return round * gridDim.x +
         (round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
// dkdv: the own buffers of K, V, the ring of Q, dO, lse and delta of
// each stage; dq: the own buffers of Q, dO, the ring of K, V; then the
// barriers; + 1024 to align
__host__ __device__ constexpr int smem_bytes(int d, bool dkdv) {
  return 1024 + own_bufs(d) * 2 * tile_bytes(OWN, d) +
         STAGES * 2 * tile_bytes(TILE, d) +
         (dkdv ? STAGES * 2 * TILE * 4 : 0) + 8 * (2 * STAGES + 2 * own_bufs(d));
}

// dK, dV of OWN keys (64 a consumer warpgroup) against every query tile
// from the diagonal on. S^T = K Q^T and dP^T = V dO^T put keys on the
// accumulator's rows, so P^T and dS^T, rounded to bf16, are the A
// fragments of dV += P^T dO and dK += dS^T Q as they lie. Item i: key
// block i / BH from the first keys.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wg_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  constexpr int KB = tile_bytes(OWN, D), QB = tile_bytes(TILE, D);
  constexpr int OB = own_bufs(D);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t own_s = (raw + 1023) & ~1023u;  // buffer b: K at + 2 b KB, V after
  const uint32_t ring = own_s + OB * 2 * KB;  // stage st: Q at ring + 2 st QB, dO after it
  const uint32_t stat_s = ring + STAGES * 2 * QB;  // [STAGES][lse * log2 e, delta][TILE]
  const uint32_t bars = stat_s + STAGES * 2 * TILE * 4;
  float* stat = reinterpret_cast<float*>(smem_raw + (stat_s - raw));
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  auto own_full = [&](int b) { return bars + 8 * (2 * STAGES + b); };
  auto own_empty = [&](int b) { return bars + 8 * (2 * STAGES + OB + b); };

  const int S = a.S, T = a.T, tiles = (S + TILE - 1) / TILE;
  const bool causal = a.causal;
  const int items = a.BH * ((T + OWN - 1) / OWN);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), 32);
      bar_init(empty(st), CWG * 128);
    }
    for (int b = 0; b < OB; ++b) {
      bar_init(own_full(b), 1);
      bar_init(own_empty(b), CWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {  // producer: one warp loads, the other three leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x & 31;
    int c = 0, j = 0;  // ring tiles and items so far
    for (int round = 0; round * (int)gridDim.x < items; ++round) {
      const int it = item_of(round);
      if (it >= items) continue;
      const int bh = it % a.BH, k0 = it / a.BH * OWN;
      // the query tiles from the diagonal (causal; none for keys past S)
      const int i_first = causal ? k0 / TILE : 0;
      const int n = max(tiles - i_first, 0);
      const long long rb = (long long)bh * S;
      // K, V into a buffer the consumers are done with: at once while a
      // free one is left, else after the ring's first tiles of the item
      auto load_own = [&]() {
        const int b = j % OB;
        bar_wait(own_empty(b), ((j / OB) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t ks = own_s + 2 * b * KB;
          bar_expect(own_full(b), 2 * KB);
          tma_tile<D, OWN>(ks, &maps.k, own_full(b), k0, bh);
          tma_tile<D, OWN>(ks + KB, &maps.v, own_full(b), k0, bh);
        }
      };
      const int early = OB > 1 || j == 0 ? 0 : min(n, STAGES - 1);
      for (int t = 0; t < n; ++t, ++c) {
        if (t == early) load_own();
        const int st = c % STAGES, q0 = (i_first + t) * TILE;
        bar_wait(empty(st), ((c / STAGES) & 1) ^ 1);
        float* ls = stat + st * 2 * TILE;
        for (int r = lane; r < TILE; r += 32) {
          const bool ok = q0 + r < S;
          ls[r] = ok ? a.lse[rb + q0 + r] * LOG2E : 0.f;
          ls[TILE + r] = ok ? a.delta[rb + q0 + r] : 0.f;
        }
        if (lane == 0) {
          bar_expect(full(st), 2 * QB);
          tma_tile<D, TILE>(ring + 2 * st * QB, &maps.q, full(st), q0, bh);
          tma_tile<D, TILE>(ring + (2 * st + 1) * QB, &maps.g, full(st), q0, bh);
        } else {
          bar_arrive(full(st));
        }
      }
      if (early == n) load_own();
      ++j;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int lane = threadIdx.x & 31, wq = (threadIdx.x / 32) % 4;
  const int t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  int c = 0, j = 0;
  for (int round = 0; round * (int)gridDim.x < items; ++round) {
    const int it = item_of(round);
    if (it >= items) continue;
    const int bh = it % a.BH, k0 = it / a.BH * OWN;
    const int i_first = causal ? k0 / TILE : 0;
    const int n = max(tiles - i_first, 0);
    const int kw0 = k0 + wg * 64;                 // the warpgroup's keys
    const int key = kw0 + wq * 16 + (lane >> 2);  // this thread's: key, key + 8
    const int b = j % OB;
    const uint32_t ka = own_s + 2 * b * KB + wg * 64 * 128, va = ka + KB;
    float dk[D / 2], dv[D / 2];
    zero(dk);
    zero(dv);
    bar_wait(own_full(b), (j / OB) & 1);
    for (int t = 0; t < n; ++t, ++c) {
      const int st = c % STAGES, q0 = (i_first + t) * TILE;
      bar_wait(full(st), (c / STAGES) & 1);
      // the warpgroup's keys all lie past this tile's queries, or past T
      if ((!causal || kw0 <= q0 + TILE - 1) && kw0 < T) {
        const uint32_t qs = ring + 2 * st * QB, gs = qs + QB;
        float s[32], dp[32];
        zero(s);
        zero(dp);
        wgmma_fence();
        scores<D>(s, ka, OWN, qs, TILE);   // S^T = K Q^T
        scores<D>(dp, va, OWN, gs, TILE);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // s[4 jb + e]: key `key` + 8 ((e >> 1) & 1), query q0 + 8 jb + 2
        // t4 + (e & 1); P^T and dS^T into A fragments (16 queries a k-step)
        const float* ls = stat + st * 2 * TILE;
        const bool edge = (causal && kw0 + 63 > q0) || q0 + TILE > S;
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int jj = 0; jj < 32; jj += 2) {
          const int qc = 8 * (jj / 4) + 2 * t4, kp = key + 8 * ((jj >> 1) & 1);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
          const float2 dl = *reinterpret_cast<const float2*>(ls + TILE + qc);
          float p0 = ex2(fmaf(s[jj], sl2, -l2.x));
          float p1 = ex2(fmaf(s[jj + 1], sl2, -l2.y));
          if (edge) {  // keys past T are never stored
            if (!((!causal || kp <= q0 + qc) && q0 + qc < S)) p0 = 0.f;
            if (!((!causal || kp <= q0 + qc + 1) && q0 + qc + 1 < S)) p1 = 0.f;
          }
          pa[jj / 8][(jj % 8) / 2] = pack(p0, p1);
          da[jj / 8][(jj % 8) / 2] =
              pack(p0 * (dp[jj] - dl.x), p1 * (dp[jj + 1] - dl.y));
        }
        wgmma_fence();
        accumulate<D>(dv, pa, gs);  // dV += P^T dO
        accumulate<D>(dk, da, qs);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
      }
      bar_arrive(empty(st));
    }
    bar_arrive(own_empty(b));  // every product that read K and V has waited
    const long long base = (long long)bh * T * D;
    store_rows<D>(static_cast<B*>(a.dk) + base, dk, kw0 + wq * 16, T, a.scale);
    store_rows<D>(static_cast<B*>(a.dv) + base, dv, kw0 + wq * 16, T, 1.f);
    ++j;
  }
}

// dQ of OWN queries (64 a consumer warpgroup) against every key tile up
// to the diagonal. S = Q K^T and dP = dO V^T put queries on the
// accumulator's rows, so dS is the A fragment of dQ += dS K as it lies.
// Item i: query block i / BH from the last queries.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_wg_kernel(const __grid_constant__ Maps maps, const BwdArgs a) {
  constexpr int QB = tile_bytes(OWN, D), KB = tile_bytes(TILE, D);
  constexpr int OB = own_bufs(D);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t own_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // buffer b: Q at + 2 b QB, dO after
  const uint32_t ring = own_s + OB * 2 * QB;  // stage st: K at ring + 2 st KB, V after it
  const uint32_t bars = ring + STAGES * 2 * KB;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  auto own_full = [&](int b) { return bars + 8 * (2 * STAGES + b); };
  auto own_empty = [&](int b) { return bars + 8 * (2 * STAGES + OB + b); };

  const int S = a.S, T = a.T, tiles = (T + TILE - 1) / TILE;
  const int blocks = (S + OWN - 1) / OWN;
  const bool causal = a.causal;
  const int items = a.BH * blocks;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), 1);
      bar_init(empty(st), CWG * 128);
    }
    for (int b = 0; b < OB; ++b) {
      bar_init(own_full(b), 1);
      bar_init(own_empty(b), CWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {  // producer: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128 != 0) return;
    int c = 0, j = 0;  // ring tiles and items so far
    for (int round = 0; round * (int)gridDim.x < items; ++round) {
      const int it = item_of(round);
      if (it >= items) continue;
      const int bh = it % a.BH, q0 = (blocks - 1 - it / a.BH) * OWN;
      const int n = causal ? min(tiles, (q0 + OWN + TILE - 1) / TILE) : tiles;
      auto load_own = [&]() {  // Q, dO into a buffer the consumers are done with
        const int b = j % OB;
        const uint32_t qs = own_s + 2 * b * QB;
        bar_wait(own_empty(b), ((j / OB) & 1) ^ 1);
        bar_expect(own_full(b), 2 * QB);
        tma_tile<D, OWN>(qs, &maps.q, own_full(b), q0, bh);
        tma_tile<D, OWN>(qs + QB, &maps.g, own_full(b), q0, bh);
      };
      const int early = OB > 1 || j == 0 ? 0 : min(n, STAGES - 1);
      for (int t = 0; t < n; ++t, ++c) {
        if (t == early) load_own();
        const int st = c % STAGES;
        bar_wait(empty(st), ((c / STAGES) & 1) ^ 1);
        bar_expect(full(st), 2 * KB);
        tma_tile<D, TILE>(ring + 2 * st * KB, &maps.k, full(st), t * TILE, bh);
        tma_tile<D, TILE>(ring + (2 * st + 1) * KB, &maps.v, full(st), t * TILE, bh);
      }
      if (early == n) load_own();
      ++j;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int lane = threadIdx.x & 31, wq = (threadIdx.x / 32) % 4;
  const int t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  int c = 0, j = 0;
  for (int round = 0; round * (int)gridDim.x < items; ++round) {
    const int it = item_of(round);
    if (it >= items) continue;
    const int bh = it % a.BH, q0 = (blocks - 1 - it / a.BH) * OWN;
    const int n = causal ? min(tiles, (q0 + OWN + TILE - 1) / TILE) : tiles;
    const int qw0 = q0 + wg * 64;                // the warpgroup's queries
    const int qi = qw0 + wq * 16 + (lane >> 2);  // this thread's: qi, qi + 8
    const long long rb = (long long)bh * S;
    const int b = j % OB;
    const uint32_t qa = own_s + 2 * b * QB + wg * 64 * 128, ga = qa + QB;
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qi + 8 * h;
      lse2[h] = r < S ? a.lse[rb + r] * LOG2E : 0.f;
      del[h] = r < S ? a.delta[rb + r] : 0.f;
    }
    float dq[D / 2];
    zero(dq);
    bar_wait(own_full(b), (j / OB) & 1);
    for (int t = 0; t < n; ++t, ++c) {
      const int st = c % STAGES, t0 = t * TILE;
      bar_wait(full(st), (c / STAGES) & 1);
      // some key of the tile is visible to the warpgroup
      if ((!causal || t0 <= qw0 + 63) && qw0 < S) {
        const uint32_t ks = ring + 2 * st * KB, vs = ks + KB;
        float s[32], dp[32];
        zero(s);
        zero(dp);
        wgmma_fence();
        scores<D>(s, qa, OWN, ks, TILE);   // S = Q K^T
        scores<D>(dp, ga, OWN, vs, TILE);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // s[4 jb + e]: query qi + 8 ((e >> 1) & 1), key t0 + 8 jb + 2 t4
        // + (e & 1)
        const bool edge = (causal && t0 + TILE - 1 > qw0) || t0 + TILE > T ||
                          qw0 + 64 > S;
        uint32_t da[4][4];
#pragma unroll
        for (int jj = 0; jj < 32; jj += 2) {
          const int h = (jj >> 1) & 1, r = qi + 8 * h;
          const int kp = t0 + 8 * (jj / 4) + 2 * t4;
          float p0 = ex2(fmaf(s[jj], sl2, -lse2[h]));
          float p1 = ex2(fmaf(s[jj + 1], sl2, -lse2[h]));
          if (edge) {
            if (!((!causal || kp <= r) && r < S && kp < T)) p0 = 0.f;
            if (!((!causal || kp + 1 <= r) && r < S && kp + 1 < T)) p1 = 0.f;
          }
          da[jj / 8][(jj % 8) / 2] =
              pack(p0 * (dp[jj] - del[h]), p1 * (dp[jj + 1] - del[h]));
        }
        wgmma_fence();
        accumulate<D>(dq, da, ks);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
      }
      bar_arrive(empty(st));
    }
    bar_arrive(own_empty(b));  // every product that read Q and dO has waited
    store_rows<D>(static_cast<B*>(a.dq) + rb * D, dq, qw0 + wq * 16, S, a.scale);
    ++j;
  }
}

}  // namespace wgb

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
  const int S = a.S, T = a.T;
  const bool causal = a.causal;
  const long long base = (long long)blockIdx.y * S;   // query rows
  const long long kbase = (long long)blockIdx.y * T;  // key rows
  const float* q = static_cast<const float*>(a.q) + base * D;
  const float* dout = static_cast<const float*>(a.dout) + base * D;
  const int lane = threadIdx.x % TPR;
  const int k0 = blockIdx.x * RB;
  const int kp = k0 + threadIdx.x / TPR;  // this thread's key
  const bool row_ok = kp < T;
  float4 kr[C], vr[C], dk[C], dv[C];
  load_row<D>(kr, static_cast<const float*>(a.k) + (kbase + kp) * D, lane, row_ok);
  load_row<D>(vr, static_cast<const float*>(a.v) + (kbase + kp) * D, lane, row_ok);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dk[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[c] = dk[c];
  }
  for (int q0 = causal ? k0 / OT * OT : 0; q0 < S; q0 += OT) {
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
      const float p =
          (!causal || kp <= qi) && qi < S ? expf(s * a.scale - ls[r]) : 0.f;
      axpy_row<D>(dv, p, gs[r], lane);
      axpy_row<D>(dk, p * (dp - ds[r]), qs[r], lane);
    }
    __syncthreads();
  }
  if (row_ok) {
    store_row<D>(static_cast<float*>(a.dk) + (kbase + kp) * D, dk, lane, a.scale);
    store_row<D>(static_cast<float*>(a.dv) + (kbase + kp) * D, dv, lane, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_fp_kernel(const BwdArgs a) {
  constexpr int C = D / 4 / TPR;
  __shared__ __align__(16) float ks[OT][D];
  __shared__ __align__(16) float vs[OT][D];
  const int S = a.S, T = a.T;
  const bool causal = a.causal;
  const long long base = (long long)blockIdx.y * S;
  const float* k = static_cast<const float*>(a.k) + (long long)blockIdx.y * T * D;
  const float* v = static_cast<const float*>(a.v) + (long long)blockIdx.y * T * D;
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
  // the row's last visible key (-1: none); one bound keeps the loop's
  // mask to one compare
  const int kmax = !row_ok ? -1 : causal ? min(qi, T - 1) : T - 1;
  const int t_end = causal ? min(T, q0 + RB) : T;
  for (int t0 = 0; t0 < t_end; t0 += OT) {
    stage<D>(ks, vs, k, v, t0, T);
    __syncthreads();
    for (int r = 0; r < OT; ++r) {
      const float s = dot_row<D>(qr, ks[r], lane);
      const float dp = dot_row<D>(gr, vs[r], lane);
      const float p = t0 + r <= kmax ? expf(s * a.scale - lse) : 0.f;
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

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH, S, D] bf16 as a 3-d map (D, S, BH), boxes of 64 dims x 64 rows in
// the 128-byte swizzle; reads past S are zeros
bool bf16_map(CUtensorMap* m, const void* base, int BH, int S, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)wgb::TILE, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_d(const BwdArgs& a, int dtype, cudaStream_t s) {
  const long long rows = (long long)a.BH * a.S;
  // rows a prep block: 256 threads, D / V of them a row (V = 16 bytes)
  const int per = 256 / (D / (dtype == 1 ? 8 : 4) < 32 ? D / (dtype == 1 ? 8 : 4) : 32);
  const dim3 prep((unsigned)((rows + per - 1) / per));
  if (dtype == 1) {
    using B = __nv_bfloat16;
    wgb::Maps maps;
    if (!bf16_map(&maps.q, a.q, a.BH, a.S, D) ||
        !bf16_map(&maps.k, a.k, a.BH, a.T, D) ||
        !bf16_map(&maps.v, a.v, a.BH, a.T, D) ||
        !bf16_map(&maps.g, a.dout, a.BH, a.S, D))
      return cudaErrorNotSupported;
    bwd_prep_kernel<B, D><<<prep, 256, 0, s>>>(a);
    static bool sized[2] = {false, false};
    const int b1 = wgb::smem_bytes(D, true), b2 = wgb::smem_bytes(D, false);
    cudaError_t e = allow_smem(wgb::dkdv_wg_kernel<D>, b1, sized[0]);
    if (e != cudaSuccess) return e;
    e = allow_smem(wgb::dq_wg_kernel<D>, b2, sized[1]);
    if (e != cudaSuccess) return e;
    // persistent: one block an SM, at most one an item
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    // items: (head, 128 keys) in dkdv, (head, 128 queries) in dq
    const long long kv_items = (long long)a.BH * ((a.T + wgb::OWN - 1) / wgb::OWN);
    const long long q_items = (long long)a.BH * ((a.S + wgb::OWN - 1) / wgb::OWN);
    const dim3 kv_grid((unsigned)(kv_items < sms ? kv_items : sms));
    const dim3 q_grid((unsigned)(q_items < sms ? q_items : sms));
    wgb::dkdv_wg_kernel<D><<<kv_grid, wgb::THREADS, b1, s>>>(maps, a);
    wgb::dq_wg_kernel<D><<<q_grid, wgb::THREADS, b2, s>>>(maps, a);
  } else {
    bwd_prep_kernel<float, D><<<prep, 256, 0, s>>>(a);
    const dim3 kv_grid((a.T + fpb::RB - 1) / fpb::RB, a.BH);
    const dim3 q_grid((a.S + fpb::RB - 1) / fpb::RB, a.BH);
    fpb::dkdv_fp_kernel<D><<<kv_grid, fpb::THREADS, 0, s>>>(a);
    fpb::dq_fp_kernel<D><<<q_grid, fpb::THREADS, 0, s>>>(a);
  }
  return cudaSuccess;
}

}  // namespace

// The backward: q, o, dout, dq [BH, S, D] and k, v, dk, dv [BH, T, D] of
// one dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned;
// lse [BH, S] f32 from flash_attention_lse_launch with the same causal;
// delta [BH, S] f32 scratch. D = 64 or 128. causal: key kp visible to
// query qi when kp <= qi; 0: every key. Launches three kernels in order
// on `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk,
                                          void* dv, int BH, int S, int T,
                                          int D, int causal, float scale,
                                          int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || T <= 0 || (dtype != 0 && dtype != 1) || !lse ||
      !delta)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (!on16(p)) return (int)cudaErrorMisalignedAddress;
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, BH, S, T,
                  causal ? 1 : 0, scale};
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
