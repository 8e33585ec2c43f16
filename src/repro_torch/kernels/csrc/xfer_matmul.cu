// xfer_matmul: out[R, M] = x[R, N] @ w[N, M], fp32 accumulator, one
// rounding to x's dtype at the end.
// quant_matmul: the same with an int8 w and one f32 scale per output
// column, out[R, M] = (x[R, N] @ w_q[N, M]) * scale[M].
//
// xfer_matmul replaces the TPU kernel repro/kernels/xfer_matmul.py:
// xfer_matmul / _matmul_kernel (the paper's <Tr, Tm, Tn>-tiled core);
// quant_matmul replaces repro/kernels/quant_matmul.py: quant_matmul /
// _quant_matmul_kernel (the INT8 serving path's dequant-fused matmul).
// The TPU grid's sequential contraction axis, with its VMEM accumulator
// carried across grid steps, becomes a loop over N inside a block that
// keeps the accumulator in registers.
//
// What bounds it on the H100. At decode R is the slot count (8): 2R
// operations per two weight bytes in bf16, far below the card's ~295
// operations per byte, so the bound is reading w once (3.35 TB/s). At
// prefill R is a group's token count (2048): above the ridge, so the
// bound is the tensor cores' 989 TFLOP/s. One C entry takes six
// kernels; the wrapper's route (xfer_matmul.py: route) picks one from the
// shape, the dtype and w's strides:
//
// - stream_mma (bf16, R <= 16, row-major w[N, M] with rows on 4 bytes:
//   every bf16 projection at decode). The split-K weight streaming below
//   with the products on tensor cores: w^T is the mma.sync A operand, so
//   R = 8 rows of FMAs per weight element do not bound it (see the kernel).
// - stream_rows (R <= 16, the other row-major w: fp32, rows of odd stride).
//   Weight streaming: 8 lanes side by side read one 128-byte line of a w row
//   (16-byte vectors of 8 bf16 or 4 fp32 columns), so a warp reads 4 rows
//   and a block of 8 warps 32 rows per pass, 4 passes in flight, over a
//   64-column (bf16) tile; the R rows of x for the block's K range sit in
//   shared memory and each thread keeps R x 8 fp32 accumulators. Rows of
//   an odd stride are read element by element. N is split across blocks
//   (split-K) so that even a 1024x1024 weight is read by >= 132 blocks,
//   one per SM. The warp's row groups are summed by a shuffle
//   reduce-scatter, the warps in order through shared memory. The splits
//   are reduced inside the same launch: each block writes its f32 partial
//   to a workspace, the block that arrives last at its column tile's
//   counter (atomicAdd after a fence) sums the partials in split order
//   (threads split the work in a fixed grouping where the tile has few
//   outputs), rounds once and resets the counter to 0 for the next call.
//   No float atomics: the result is bit-stable run to run, and one wrapper
//   call is one launch.
// - stream_cols (R <= 16, w given K-major as embed.T, stride_n == 1: the
//   tied unembedding). A warp owns 4 output columns at a time and reads
//   each column's contiguous N with 16-byte loads, the next vector in
//   flight while the current one is multiplied; the 4 x R sums are
//   reduce-scattered over the lanes (31 shuffles for 32 sums).
//   50,304-256,000 columns are enough to fill the card without a split.
//   x [R, N] sits in shared memory as fp32; the blocks are persistent (two
//   per SM) so that it is staged once per block.
// - wgmma (bf16, R > 16, 2^20 outputs and more, rows on 16 bytes): the
//   Hopper warpgroup product. Two warpgroups per block each issue wgmma
//   m64n128k16 (or m64n256k16 on the widest outputs) from shared tiles in
//   the 128-byte swizzle, described by matrix descriptors; a row-major w
//   is transposed by the instruction, the K-major embed.T is not. A
//   cp.async ring keeps tiles ahead while one wgmma group is in flight.
// - tc (bf16, R > 16, the other shapes with N % 8 == 0): mma.sync
//   m16n8k16 from ldmatrix fragments, block tile 128x128x64, 4 warps of
//   64x64, a 3-stage cp.async ring in padded (conflict-free) shared
//   memory; rows off 16 bytes ride 8- or 4-byte cp.async (or element-wise
//   copies). Small outputs (xlstm-350m's 2048x4 gates, 2560x256) split K
//   across blocks and merge in the same launch, as stream_rows does.
//   Ragged edges are zero-filled by cp.async's src-size and masked.
// - tile (fp32 at R > 16, misaligned or odd-strided shapes, and
//   quant_matmul at R > 16): the CUDA-core template matmul_kernel<T, W,
//   BM>, fp32 FMA through a padded shared tile, BM = 16 or 64 rows,
//   ragged edges masked. fp32 never goes to tensor cores (no TF32).
//
// quant_matmul takes the same plan struct through its own entry and its
// own route (quant_matmul.py: route). At decode its bound is the int8
// bytes of w, half of bf16's:
// - stream_mma_q8 (R <= 16, row-major w_q with rows on 16 bytes: every
//   INT8 projection): stream_mma's split-K streaming and in-launch merge
//   over an int8 cp.async ring, each weight widened exactly to bf16 in
//   registers (byte permutes and one subtract) as the mma A operand;
// - stream_cols_q8 (R <= 16, K-major w_q: the tied unembedding's q.T):
//   q's rows read straight into registers as the A operand;
// - tile for the rest (R = 2048 prefill, misaligned shapes).
// Both streams run fp32 x as three exact bf16 terms (hi, mid, lo) into
// one fp32 accumulator, so that the result differs from fp32 only in
// summation order (see stage_terms). As in the TPU quant_matmul,
// per-column symmetric scaling commutes with the contraction, (x @ q) *
// s == x @ (q * s), so the scale multiplies each output once, at the
// merge or the store.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // contraction depth per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The expert axis of xfer_matmul_experts (x [E, R, N] @ w [E, N, M]): the
// block of expert e (blockIdx.z; tc: blockIdx.z / splits) reads x, w and
// writes out, the split-K workspace and the tile counters advanced by e
// times these element strides. All zero (and one expert) for xfer_matmul.
struct Group {
  long long sx, sw, so, sws;
  int scnt;
};

// T: x and out; W: w (T, or int8_t with one f32 scale per column)
template <typename T, typename W, int BM>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out, int R,
              int N, int M, long long swn, long long swm, Group grp) {
  constexpr bool Q8 = std::is_same<W, int8_t>::value;
  {
    const long long e = blockIdx.z;
    x += e * grp.sx;
    w += e * grp.sw;
    out += e * grp.so;
  }
  constexpr int TM = BM / 16;  // rows per thread
  constexpr int TN = BN / 16;  // columns per thread
  // +1 padding: the transposing stores below hit distinct banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const bool w_kmajor = (swn == 1 && swm != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    // x tile [BM, BK]: consecutive threads read consecutive k
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = r0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < R && gk < N) ? to_f32(x[(long long)gr * N + gk]) : 0.f;
    }
    // w tile [BK, BN]: consecutive threads walk w's contiguous axis
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      int kk, c;
      if (w_kmajor) {
        kk = idx % BK;
        c = idx / BK;
      } else {
        kk = idx / BN;
        c = idx % BN;
      }
      const int gk = k0 + kk, gc = c0 + c;
      ws[kk][c] = (gk < N && gc < M) ? to_f32(w[gk * swn + gc * swm]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // flush: the int8 kernel's per-column scale, once per output element
  float s[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = c0 + tx + 16 * j;
    s[j] = (Q8 && gc < M) ? scale[gc] : 1.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty + 16 * i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = c0 + tx + 16 * j;
      if (gc < M)
        store(out + (long long)gr * M + gc, Q8 ? acc[i][j] * s[j] : acc[i][j]);
    }
  }
}

// ---- PTX: cp.async, ldmatrix, mma.sync -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// CB bytes global -> shared (CB = 16, 8 or 4); only src_bytes are read,
// the rest is zeroed
template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(CB), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- decode: weight streaming -------------------------------------------

namespace stream {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int XS_FLOATS = 24576;  // x stage of stream_rows: R x kc <= this
constexpr int CW = 4;        // stream_cols: output columns per warp

// one 16-byte vector of T (8 bf16 or 4 fp32) widened to fp32
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4 u, float (&f)[8]) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// the first `valid` elements of the vector at p (the rest zero); a full
// vector on 16 bytes is one load, a partial one (the ragged column edge)
// or one off 16 bytes (rows of odd stride) is read element by element
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int valid, bool vec_ok) {
  constexpr int V = 16 / sizeof(T);
  if (vec_ok && valid >= V) return __ldg(reinterpret_cast<const uint4*>(p));
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                         uint16_t>::type;
  union {
    uint4 u;
    Bits b[V];
  } r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  const Bits* pb = reinterpret_cast<const Bits*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i < valid) r.b[i] = pb[i];
  return r.u;
}

// Sum NV per-lane values over the lanes that differ only in the lane
// bits OFF, OFF / 2, ..., STOP (xor shuffles), halving the values a lane
// keeps at each step (a reduce-scatter): about NV shuffles instead of NV
// per step. Afterwards v[i] holds the total of value first + i, for
// i < max(1, NV / lanes summed); first depends on the lane.
template <int N, int OFF, int STOP, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane,
                                               int& first) {
  if constexpr (OFF >= STOP) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) first += H;
      reduce_scatter<H, OFF / 2, STOP, NV>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2, STOP, NV>(v, lane, first);
    }
  }
}

// The block's partials red [WARPS][RB][TILE] (f32, written by every
// warp) for output columns [tile * TILE, +TILE): the warps are summed in
// order; with one split that is the output, else it goes to the
// workspace ws [splits][R][M] and the block that arrives last at the
// tile's counter (atomicAdd after a fence) sums the splits in order: GS
// groups of threads per output, each over every GS-th split, then the
// groups in order. It resets the counter to 0 for the next call. A
// non-null scale (quant_matmul's per-column f32 scale) multiplies each
// output once, as it is stored.
template <typename T, int RB, int TILE>
__device__ __forceinline__ void finish_tile(float* red, T* out, float* ws,
                                            int* counters, int R, int M,
                                            int tile, int split, int splits,
                                            const float* scale = nullptr) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  __syncthreads();
  for (int o = tid; o < R * TILE; o += THREADS) {
    const int r = o / TILE, c = o % TILE, gc = tile * TILE + c;
    float s = 0.f;
#pragma unroll
    for (int wp2 = 0; wp2 < WARPS; ++wp2) s += red[(wp2 * RB + r) * TILE + c];
    if (gc < M) {
      if (splits == 1)
        store(out + (long long)r * M + gc, scale ? s * scale[gc] : s);
      else
        ws[((long long)split * R + r) * M + gc] = s;
    }
  }
  if (splits == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // outputs in vectors of VW columns (4 where the tile's columns and rows
  // allow 16-byte loads), gs thread groups per vector
  const int cols = min(TILE, M - tile * TILE);
  const int vw = (cols % 4 == 0 && M % 4 == 0) ? 4 : 1;
  const int vouts = R * cols / vw;
  const int gs = vouts >= THREADS ? 1 : THREADS / vouts;
  for (int t = tid; t < gs * vouts; t += THREADS) {
    const int o = t % vouts, sg = t / vouts;
    const int r = o / (cols / vw), gc = tile * TILE + o % (cols / vw) * vw;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (vw == 4) {
#pragma unroll 8
      for (int sp = sg; sp < splits; sp += gs) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            ws + ((long long)sp * R + r) * M + gc));
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
    } else {
#pragma unroll 8
      for (int sp = sg; sp < splits; sp += gs)
        s[0] += __ldcg(ws + ((long long)sp * R + r) * M + gc);
    }
    for (int e = 0; e < vw; ++e) {
      if (gs == 1)
        store(out + (long long)r * M + gc + e,
              scale ? s[e] * scale[gc + e] : s[e]);
      else
        red[(sg * vouts + o) * vw + e] = s[e];
    }
  }
  if (gs > 1) {
    __syncthreads();
    for (int o = tid; o < vouts * vw; o += THREADS) {
      const int r = o / cols, gc = tile * TILE + o % cols;
      float s = 0.f;
      for (int sg = 0; sg < gs; ++sg) s += red[sg * vouts * vw + o];
      store(out + (long long)r * M + gc, scale ? s * scale[gc] : s);
    }
  }
  if (tid == 0) counters[tile] = 0;
}

// Row-major w: block (column tile, split) covers TILE = 8 x V columns
// and the rows [split * kc, min(N, (split + 1) * kc)). A warp reads 4
// rows at a time (8 lanes x 16 bytes each: one 128-byte line per row).
// RB >= R rows of registers.
template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
stream_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int R, int N, int M,
                   long long swn, int kc, int splits, Group grp) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LPR = 8;               // lanes per row
  constexpr int TILE = LPR * V;        // columns per block
  constexpr int RPP = WARPS * 32 / LPR;  // rows per block pass
  constexpr int U = 4;                 // passes in flight
  constexpr int NV = RB * V;           // accumulators per thread
  constexpr int NF = NV / 4;           // kept after the 4-group scatter
  // x stage [R][kc], then the warps' partials [WARPS][RB][TILE]
  extern __shared__ __align__(16) float buf[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / LPR, cl = lane % LPR;
  const int tile = blockIdx.x, split = blockIdx.y;
  {
    const long long e = blockIdx.z;
    x += e * grp.sx;
    w += e * grp.sw;
    out += e * grp.so;
    ws += e * grp.sws;
    counters += e * grp.scnt;
  }
  const int c0 = tile * TILE + cl * V;
  const int k0 = split * kc;
  const int klen = min(N, k0 + kc) - k0;

  const int valid = M - c0;
  const bool vec_ok =
      swn % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const T* wp = w + (long long)k0 * swn + c0;
  // U passes of this thread's rows, rows past the range read as zero
  auto load_pass = [&](uint4 (&u)[U], int kb) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int k = kb + j * RPP;
      u[j] = k < klen ? load_vec(wp + (long long)k * swn, valid, vec_ok)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 cur[U], nxt[U] = {};
  int kb = warp * 4 + rg;
  load_pass(cur, kb);  // in flight while x is staged

  for (int i = tid; i < R * klen; i += THREADS) {
    const int r = i / klen, k = i % klen;
    buf[r * kc + k] = to_f32(x[(long long)r * N + k0 + k]);
  }
  __syncthreads();

  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;

  for (; kb < klen; kb += U * RPP) {
    if (kb + U * RPP < klen) load_pass(nxt, kb + U * RPP);  // the next passes
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int k = kb + j * RPP;
      if (k >= klen) break;
      float wv[V];
      unpack(cur[j], wv);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xr = r < R ? buf[r * kc + k] : 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r * V + v] = fmaf(xr, wv[v], acc[r * V + v]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) cur[j] = nxt[j];
  }

  // the warp's 4 row groups, then the 8 warps in order
  int first = 0;
  reduce_scatter<NV, 16, 8, NV>(acc, lane, first);  // the 4 row groups
  __syncthreads();  // the x stage is free
  float* red = buf;  // [WARPS][RB][TILE]
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int j = first + i, r = j / V, v = j % V;
    red[(warp * RB + r) * TILE + cl * V + v] = acc[i];
  }
  finish_tile<T, RB, TILE>(red, out, ws, counters, R, M, tile, split,
                           splits);
}

// bf16, row-major w with rows on 4 bytes: the same split-K streaming,
// the products on tensor cores. out^T [M, R] = w^T [M, N] x^T [N, R]: a
// 64-column tile of w is the A operand (four m16 tiles, ldmatrix.trans
// from the staged rows), the block's R <= RB rows of x the B operand (one
// n8 tile per 8 rows, from x staged in shared memory), mma.sync m16n8k16
// with f32 accumulators. w streams through a 4-stage cp.async ring of
// 128-row stages (one k16 step per warp per stage), 16-byte copies where
// w's rows allow (8 or 4 bytes otherwise); x is staged while the
// first stages are in flight. The mma leaves the SM's FMA pipes free, so
// the kernel is bound by the bytes of w at R = 8 where the CUDA-core loop
// (R x 8 FMAs per 16 bytes) is not.
constexpr int MT = 64;              // output columns per block
constexpr int MBK = WARPS * 16;     // rows of w per stage
constexpr int MLD = MT + 8;         // padded stage row: ldmatrix conflict-free
constexpr int MSTAGES = 4;

__host__ __device__ constexpr int mma_x_ld(int kc) {
  return (kc + MBK - 1) / MBK * MBK + 8;  // x stage row: b loads conflict-free
}

template <int RB, int CB>
__global__ void __launch_bounds__(THREADS)
stream_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters, int R, int N, int M,
                  long long ldw, int kc, int splits, Group grp) {
  constexpr int NI = RB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y;
  {
    const long long e = blockIdx.z;
    x += e * grp.sx;
    w += e * grp.sw;
    out += e * grp.so;
    ws += e * grp.sws;
    counters += e * grp.scnt;
  }
  const int c0 = tile * MT;
  const int k0 = split * kc;
  const int klen = min(N, k0 + kc) - k0;
  const int KT = (klen + MBK - 1) / MBK;
  const int xld = mma_x_ld(kc);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [RB][xld]
  __nv_bfloat16* wst = xs + RB * xld;  // [MSTAGES][MBK][MLD]

  constexpr int EC = CB / 2;  // columns per cp.async
  auto load_stage = [&](int st, int kt) {
    __nv_bfloat16* d = wst + st * MBK * MLD;
#pragma unroll
    for (int i = tid; i < MBK * (MT / EC); i += THREADS) {
      const int row = i / (MT / EC), ch = i % (MT / EC);
      const int k = kt * MBK + row, gc = c0 + ch * EC;
      const bool ok = k < klen && gc < M;
      const __nv_bfloat16* src = ok ? w + (long long)(k0 + k) * ldw + gc : w;
      cp_async<CB>(smem_u32(d + row * MLD + ch * EC), src,
                   ok ? min(CB, (M - gc) * 2) : 0);
    }
  };

  // x rows [R][k0, k0 + klen) as bf16, zero past R and klen: 16-byte
  // copies in the first stage's group where x's rows allow
  if (N % 8 == 0 && k0 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    for (int i = tid; i < RB * (xld / 8); i += THREADS) {
      const int r = i / (xld / 8), k = i % (xld / 8) * 8;
      const bool ok = r < R && k < klen;
      cp_async<16>(smem_u32(xs + r * xld + k),
                   ok ? x + (long long)r * N + k0 + k : x,
                   ok ? min(16, (klen - k) * 2) : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < RB * xld; i += THREADS) {
      const int r = i / xld, k = i % xld;
      xs[i] = (r < R && k < klen) ? x[(long long)r * N + k0 + k] : zero;
    }
  }
#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  float acc[4][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int g = lane / 4, t4 = lane % 4;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<MSTAGES - 2>();
    __syncthreads();  // stage kt (and, at kt = 0, the x stage) visible
    const int pre = kt + MSTAGES - 1;
    if (pre < KT) load_stage(pre % MSTAGES, pre);
    cp_async_commit();

    const __nv_bfloat16* d = wst + (kt % MSTAGES) * MBK * MLD + warp * 16 * MLD;
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4_t(a[mi], smem_u32(d + ((lane % 8) + (lane / 16) * 8) * MLD +
                                mi * 16 + ((lane / 8) % 2) * 8));
    const int kx = kt * MBK + warp * 16 + 2 * t4;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const __nv_bfloat16* xr = xs + (ni * 8 + g) * xld + kx;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free

  // D = out^T: acc[mi][ni] holds columns mi * 16 + g (+ 8), rows
  // ni * 8 + 2 * t4 (+ 1)
  float* red = reinterpret_cast<float*>(wst);  // [WARPS][RB][MT]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int m = mi * 16 + g, r = ni * 8 + 2 * t4;
      red[(warp * RB + r) * MT + m] = acc[mi][ni][0];
      red[(warp * RB + r + 1) * MT + m] = acc[mi][ni][1];
      red[(warp * RB + r) * MT + m + 8] = acc[mi][ni][2];
      red[(warp * RB + r + 1) * MT + m + 8] = acc[mi][ni][3];
    }
  finish_tile<__nv_bfloat16, RB, MT>(red, out, ws, counters, R, M, tile,
                                     split, splits);
}

// K-major w (w[n, m] at w + n + m * swm): warps own CW columns at a time,
// grid-stride over the columns; x [R, N] staged once per block as fp32.
template <typename T, int RB>
__global__ void __launch_bounds__(THREADS, 1)
stream_cols_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int R, int N, int M, long long swm) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = CW * RB;
  extern __shared__ __align__(16) float xs_dyn[];  // [R][N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid * V; i < R * N; i += THREADS * V) {
    float f[V];
    unpack(__ldg(reinterpret_cast<const uint4*>(x + i)), f);
#pragma unroll
    for (int v = 0; v < V; v += 4)
      *reinterpret_cast<float4*>(xs_dyn + i + v) =
          make_float4(f[v], f[v + 1], f[v + 2], f[v + 3]);
  }
  __syncthreads();

  const int nw = gridDim.x * WARPS;
  for (int c0 = (blockIdx.x * WARPS + warp) * CW; c0 < M; c0 += nw * CW) {
    float acc[NV];  // [CW][RB]
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = 0.f;
    const T* col[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c)
      col[c] = w + (long long)min(c0 + c, M - 1) * swm;  // clamped: masked at the store

    uint4 cur[CW], nxt[CW] = {};
    int n0 = lane * V;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      cur[c] = n0 < N ? __ldg(reinterpret_cast<const uint4*>(col[c] + n0))
                      : make_uint4(0u, 0u, 0u, 0u);
    for (; n0 < N; n0 += 32 * V) {
      const int n1 = n0 + 32 * V;
      if (n1 < N) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          nxt[c] = __ldg(reinterpret_cast<const uint4*>(col[c] + n1));
      }
      float wv[CW][V];
#pragma unroll
      for (int c = 0; c < CW; ++c) unpack(cur[c], wv[c]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= R) break;
        float xv[V];
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          const float4 t = *reinterpret_cast<const float4*>(
              xs_dyn + (long long)r * N + n0 + v);
          xv[v] = t.x;
          xv[v + 1] = t.y;
          xv[v + 2] = t.z;
          xv[v + 3] = t.w;
        }
#pragma unroll
        for (int c = 0; c < CW; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[c * RB + r] = fmaf(xv[v], wv[c][v], acc[c * RB + r]);
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) cur[c] = nxt[c];
    }
    int first = 0;
    reduce_scatter<NV, 16, 1, NV>(acc, lane, first);
#pragma unroll
    for (int i = 0; i < (NV >= 32 ? NV / 32 : 1); ++i) {
      const int j = first + i, c = j / RB, r = j % RB;
      if (r < R && c0 + c < M) store(out + (long long)r * M + c0 + c, acc[i]);
    }
  }
}

// ---- quant_matmul at decode: int8 weight streaming on tensor cores ------
//
// x is staged as TERMS bf16 terms: one for bf16 x; three for fp32 x, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x
// exactly for normal values (8 + 8 + 8 significant bits). An int8 weight
// is exact in bf16, so each product of a term and a weight is exact in
// fp32, and the result differs from the fp32 reference only in the order
// of the sums, with no TF32 anywhere. R = 8 rows fill the n = 8 columns
// of one B tile per term, so the extra terms' products cost issue slots,
// not bytes.

// v as TERMS bf16 terms at xs[i], xs[i + ts], xs[i + 2 ts]
template <int TERMS>
__device__ __forceinline__ void put_terms(__nv_bfloat16* xs, int i, int ts,
                                          float v) {
  const __nv_bfloat16 hi = __float2bfloat16(v);
  xs[i] = hi;
  if constexpr (TERMS == 3) {
    const float rest = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16(rest);
    xs[i + ts] = mid;
    xs[i + 2 * ts] = __float2bfloat16(rest - __bfloat162float(mid));
  }
}

// x [R, N] rows [0, R) x [k0, k0 + klen) as TERMS bf16 terms into
// xs [TERMS][RB][xld], zero past R and klen: four elements a thread at a
// time where x's rows and k0 allow 16-byte (fp32) or 8-byte (bf16) loads
template <typename T, int RB, int TERMS>
__device__ __forceinline__ void stage_terms(__nv_bfloat16* xs, const T* x,
                                            int R, int N, int k0, int klen,
                                            int xld) {
  const int ts = RB * xld;  // elements per term
  const bool vec = N % 4 == 0 && k0 % 4 == 0 && klen % 4 == 0 &&
                   xld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  if (vec) {
    const int x4 = xld / 4;
    for (int i = threadIdx.x; i < RB * x4; i += THREADS) {
      const int r = i / x4, k = 4 * (i % x4);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < R && k < klen) {
        const T* src = x + (long long)r * N + k0 + k;
        if constexpr (sizeof(T) == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
          v[0] = __uint_as_float(u.x << 16);
          v[1] = __uint_as_float(u.x & 0xffff0000u);
          v[2] = __uint_as_float(u.y << 16);
          v[3] = __uint_as_float(u.y & 0xffff0000u);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) put_terms<TERMS>(xs, i * 4 + e, ts, v[e]);
    }
    return;
  }
  for (int i = threadIdx.x; i < RB * xld; i += THREADS) {
    const int r = i / xld, k = i % xld;
    const float v = (r < R && k < klen)
                        ? to_f32(x[(long long)r * N + k0 + k]) : 0.f;
    put_terms<TERMS>(xs, i, ts, v);
  }
}

// Byte e of the biased word u (each int8 byte xor 0x80, so 0..255) as an
// exact float: 0x4B0000uu is 2^23 + u, minus 2^23 + 128.
__device__ __forceinline__ float q8_float(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
}
// two exact floats -> one bf16x2 (lo in the low half): their top halves
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Row-major int8 w [N, M] with rows on 16 bytes: stream_mma_kernel's
// split-K streaming, the 64-column tile of w^T the A operand, staged as
// int8 (4-stage cp.async ring, rows padded to 80 bytes) and widened in
// registers. The output columns of a warp's four m16 tiles are permuted so
// that one 8-byte shared load per w row gives a thread every element it
// needs: fragment row g of tile mi is column 8 g + 2 mi, row g + 8 column
// 8 g + 2 mi + 1. The scale multiplies each output once in the merge.
constexpr int QLD = MT + 16;  // bytes per staged row of int8 w

template <int RB, int TERMS>
__host__ __device__ constexpr int q8_smem(int kc) {
  return TERMS * RB * mma_x_ld(kc) * 2 + MSTAGES * MBK * QLD;
}

template <typename T, int RB, int TERMS>
__global__ void __launch_bounds__(THREADS)
stream_mma_q8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, T* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ counters,
                     int R, int N, int M, long long ldw, int kc, int splits) {
  constexpr int NI = RB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int c0 = tile * MT;
  const int k0 = split * kc;
  const int klen = min(N, k0 + kc) - k0;
  const int KT = (klen + MBK - 1) / MBK;
  const int xld = mma_x_ld(kc);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TERMS][RB][xld]
  int8_t* wst = reinterpret_cast<int8_t*>(xs + TERMS * RB * xld);  // [MSTAGES][MBK][QLD]

  auto load_stage = [&](int st, int kt) {
    int8_t* d = wst + st * MBK * QLD;
#pragma unroll
    for (int i = tid; i < MBK * (MT / 16); i += THREADS) {
      const int row = i / (MT / 16), ch = i % (MT / 16);
      const int k = kt * MBK + row, gc = c0 + ch * 16;
      const bool ok = k < klen && gc < M;
      cp_async<16>(smem_u32(d + row * QLD + ch * 16),
                   ok ? w + (long long)(k0 + k) * ldw + gc : w,
                   ok ? min(16, M - gc) : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  stage_terms<T, RB, TERMS>(xs, x, R, N, k0, klen, xld);

  float acc[4][NI][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int g = lane / 4, t4 = lane % 4;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<MSTAGES - 2>();
    __syncthreads();  // stage kt (and, at kt = 0, the x terms) visible
    const int pre = kt + MSTAGES - 1;
    if (pre < KT) load_stage(pre % MSTAGES, pre);
    cp_async_commit();

    // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the warp's 16, bytes
    // 8 g .. 8 g + 7 of each, biased to unsigned
    const int8_t* d = wst + (kt % MSTAGES) * MBK * QLD + warp * 16 * QLD + 8 * g;
    uint2 wr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wr[j] = *reinterpret_cast<const uint2*>(d + (2 * t4 + (j & 1) + 8 * (j >> 1)) * QLD);
      wr[j].x ^= 0x80808080u;
      wr[j].y ^= 0x80808080u;
    }
    uint32_t a[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int e = 2 * (mi % 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // k rows 2 t4 (+1), then 2 t4 + 8 (+9)
        const uint32_t u0 = mi < 2 ? wr[2 * h].x : wr[2 * h].y;
        const uint32_t u1 = mi < 2 ? wr[2 * h + 1].x : wr[2 * h + 1].y;
        a[mi][2 * h] = bf16x2_hi(q8_float(u0, e), q8_float(u1, e));
        a[mi][2 * h + 1] = bf16x2_hi(q8_float(u0, e + 1), q8_float(u1, e + 1));
      }
    }
    const int kx = kt * MBK + warp * 16 + 2 * t4;
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const __nv_bfloat16* xr = xs + (term * RB + ni * 8 + g) * xld + kx;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free

  // D = out^T: acc[mi][ni] holds columns 8 g + 2 mi (e 0, 1) and
  // 8 g + 2 mi + 1 (e 2, 3), rows ni * 8 + 2 t4 (+ 1)
  float* red = reinterpret_cast<float*>(wst);  // [WARPS][RB][MT]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int m = 8 * g + 2 * mi, r = ni * 8 + 2 * t4;
      red[(warp * RB + r) * MT + m] = acc[mi][ni][0];
      red[(warp * RB + r + 1) * MT + m] = acc[mi][ni][1];
      red[(warp * RB + r) * MT + m + 1] = acc[mi][ni][2];
      red[(warp * RB + r + 1) * MT + m + 1] = acc[mi][ni][3];
    }
  finish_tile<T, RB, MT>(red, out, ws, counters, R, M, tile, split, splits,
                         scale);
}

// K-major int8 w (w[n, m] at w + n + m * swm: the tied unembedding's
// q.T, q [M, N] row-major with rows on 16 bytes, N % 64 == 0): q's rows
// are the A operand as they lie. A warp owns 16 output columns at a time
// (grid-stride, persistent blocks) and walks N in chunks of 64: each
// thread reads 16 bytes of each of its two q rows per chunk straight into
// registers, the next QU chunks (of this task or the next) in flight
// while the current ones are multiplied. The contraction index is
// permuted so that those 16 bytes are four k16 steps of the thread:
// fragment k 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of step s is byte
// 16 t4 + 4 s + 0 .. 3 of the chunk, and x's B fragments follow the same
// order (one 8-byte shared load per term and step). x's
// terms sit in shared memory once per block, rows padded by 4 so that
// those loads are conflict-free. No split: M of 50,304-256,000 fills the
// card; the scale multiplies each output at the store.
constexpr int QCOLS = 16;  // output columns per warp
constexpr int QU = 4;      // 64-wide chunks per load group

template <int RB, int TERMS>
__host__ __device__ constexpr size_t q8_cols_smem(int n) {
  return (size_t)TERMS * RB * (n + 4) * 2;
}

template <typename T, int RB, int TERMS>
__global__ void __launch_bounds__(THREADS)
stream_cols_q8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int R, int N, int M, long long swm) {
  constexpr int NI = RB / 8;
  constexpr int GK = QU * 64;  // k per load group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TERMS][RB][N + 4]
  const int xld = N + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / 4, t4 = lane % 4;
  const int nw = gridDim.x * WARPS;
  const int ngroups = (N + GK - 1) / GK;

  // group gi of the warp's task at columns c .. c + 15: rows c + g and
  // c + g + 8 of q (clamped: masked at the store), 16 bytes of each per
  // 64-wide chunk
  auto load_group = [&](uint4 (&u)[QU][2], int c, int gi) {
    const int8_t* q0 = w + (long long)min(c + g, M - 1) * swm + 16 * t4;
    const int8_t* q1 = w + (long long)min(c + g + 8, M - 1) * swm + 16 * t4;
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int n = gi * GK + j * 64;
      u[j][0] = n < N ? __ldg(reinterpret_cast<const uint4*>(q0 + n))
                      : make_uint4(0u, 0u, 0u, 0u);
      u[j][1] = n < N ? __ldg(reinterpret_cast<const uint4*>(q1 + n))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  int c0 = (blockIdx.x * WARPS + warp) * QCOLS, gi = 0;
  uint4 cur[QU][2], nxt[QU][2] = {};
  if (c0 < M) load_group(cur, c0, 0);  // in flight while x is staged
  stage_terms<T, RB, TERMS>(xs, x, R, N, 0, N, xld);
  __syncthreads();
  if (c0 >= M) return;

  float acc[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  // one stream of (task, group) pairs: the next pair's loads, the next
  // task's too, are in flight while the current group is multiplied
  for (;;) {
    int c1 = c0, g1 = gi + 1;
    if (g1 == ngroups) {
      g1 = 0;
      c1 = c0 + nw * QCOLS;
    }
    const bool more = c1 < M;
    if (more) load_group(nxt, c1, g1);
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      const int n = gi * GK + j * 64;
      if (n >= N) break;
      const uint32_t r0[4] = {cur[j][0].x ^ 0x80808080u, cur[j][0].y ^ 0x80808080u,
                              cur[j][0].z ^ 0x80808080u, cur[j][0].w ^ 0x80808080u};
      const uint32_t r1[4] = {cur[j][1].x ^ 0x80808080u, cur[j][1].y ^ 0x80808080u,
                              cur[j][1].z ^ 0x80808080u, cur[j][1].w ^ 0x80808080u};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t a[4];
        a[0] = bf16x2_hi(q8_float(r0[st], 0), q8_float(r0[st], 1));
        a[1] = bf16x2_hi(q8_float(r1[st], 0), q8_float(r1[st], 1));
        a[2] = bf16x2_hi(q8_float(r0[st], 2), q8_float(r0[st], 3));
        a[3] = bf16x2_hi(q8_float(r1[st], 2), q8_float(r1[st], 3));
        const int k = n + 16 * t4 + 4 * st;
#pragma unroll
        for (int term = 0; term < TERMS; ++term)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                xs + (term * RB + ni * 8 + g) * xld + k);
            mma_bf16(acc[ni], a, b.x, b.y);
          }
      }
    }
    if (gi == ngroups - 1) {
      // acc[ni]: columns c0 + g (e 0, 1) and c0 + g + 8 (e 2, 3), rows
      // ni * 8 + 2 t4 (+ 1)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ni * 8 + 2 * t4 + (e & 1), gc = c0 + g + 8 * (e >> 1);
          if (r < R && gc < M)
            store(out + (long long)r * M + gc, acc[ni][e] * scale[gc]);
          acc[ni][e] = 0.f;
        }
    }
    if (!more) break;
#pragma unroll
    for (int j = 0; j < QU; ++j) {
      cur[j][0] = nxt[j][0];
      cur[j][1] = nxt[j][1];
    }
    c0 = c1;
    gi = g1;
  }
}
}  // namespace stream

// ---- prefill, bf16: tensor cores -----------------------------------------

namespace tc {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int THREADS = 128;  // 4 warps: 2 along M x 2 along N, 64x64 each
constexpr int A_LD = BK + 8;  // padded rows: ldmatrix hits 8 distinct banks
constexpr int BR_LD = BN + 8; // row-major w tile [BK][BN + 8]
constexpr int BK_LD = BK + 8; // K-major w tile [BN][BK + 8]
constexpr int A_ELEMS = BM * A_LD;

template <bool KMAJ>
__host__ __device__ constexpr int b_elems() { return KMAJ ? BN * BK_LD : BK * BR_LD; }
template <bool KMAJ>
__host__ __device__ constexpr int smem_bytes() { return STAGES * (A_ELEMS + b_elems<KMAJ>()) * 2; }

// bytes of a CB-byte chunk that lie before the edge (elems_left elements)
template <int CB>
__device__ __forceinline__ int clamp_bytes(int elems_left) {
  return elems_left >= CB / 2 ? CB : (elems_left > 0 ? elems_left * 2 : 0);
}

// x [R, N] row-major (N % 8 == 0, on 16 bytes); w row-major (KMAJ false:
// w[n, m] at w + n * ldw + m) or K-major (KMAJ true: at w + n + m * ldw).
// CB: the widest cp.async (16, 8 or 4 bytes) that w's base and rows
// allow; 2 stages w element by element (rows of odd stride).
template <bool KMAJ, int CB>
__global__ void __launch_bounds__(THREADS)
tc_kernel(const __nv_bfloat16* __restrict__ x,
          const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
          float* __restrict__ ws, int* __restrict__ counters, int R, int N,
          int M, long long ldw, int kt_per_split, int splits, Group grp) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* As = smem;                       // [STAGES][BM][A_LD]
  __nv_bfloat16* Bs = smem + STAGES * A_ELEMS;    // [STAGES][b_elems]
  constexpr int B_ELEMS = b_elems<KMAJ>();
  constexpr int EC = CB / 2;  // elements per w chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 2, wn = warp % 2;
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z % splits;
  {
    const long long e = blockIdx.z / splits;
    x += e * grp.sx;
    w += e * grp.sw;
    out += e * grp.so;
    ws += e * grp.sws;
    counters += e * grp.scnt;
  }
  // this block's k-tiles: [kt0, kt0 + KT) of the (N + BK - 1) / BK
  const int kt0 = split * kt_per_split;
  const int KT = min((N + BK - 1) / BK - kt0, kt_per_split);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = (kt0 + kt) * BK;
    __nv_bfloat16* as = As + stage * A_ELEMS;
    __nv_bfloat16* bs = Bs + stage * B_ELEMS;
    // A: 128 rows x 4 chunks of 8
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int row = i / (BK / 8), ch = i % (BK / 8);
      const int gr = r0 + row, gk = k0 + ch * 8;
      const bool ok = gr < R;
      const __nv_bfloat16* src = ok ? x + (long long)gr * N + gk : x;
      cp_async<16>(smem_u32(as + row * A_LD + ch * 8), src,
                   ok ? clamp_bytes<16>(N - gk) : 0);
    }
    if constexpr (CB == 2) {
      // element by element, zero past the edges
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = KMAJ ? i % BK : i / BN, col = KMAJ ? i / BK : i % BN;
        const int gk = k0 + kk, gc = n0 + col;
        __nv_bfloat16 v = __float2bfloat16(0.f);
        if (gk < N && gc < M)
          v = KMAJ ? w[(long long)gc * ldw + gk] : w[(long long)gk * ldw + gc];
        if (KMAJ)
          bs[col * BK_LD + kk] = v;
        else
          bs[kk * BR_LD + col] = v;
      }
    } else if constexpr (KMAJ) {
      // [BN][BK]: 128 columns x BK / EC chunks along K
#pragma unroll
      for (int i = tid; i < BN * (BK / EC); i += THREADS) {
        const int col = i / (BK / EC), ch = i % (BK / EC);
        const int gc = n0 + col, gk = k0 + ch * EC;
        const bool ok = gc < M;
        const __nv_bfloat16* src = ok ? w + (long long)gc * ldw + gk : w;
        cp_async<CB>(smem_u32(bs + col * BK_LD + ch * EC), src,
                     ok ? clamp_bytes<CB>(N - gk) : 0);
      }
    } else {
      // [BK][BN]: 32 rows x BN / EC chunks along M
#pragma unroll
      for (int i = tid; i < BK * (BN / EC); i += THREADS) {
        const int row = i / (BN / EC), ch = i % (BN / EC);
        const int gk = k0 + row, gc = n0 + ch * EC;
        const bool ok = gk < N;
        const __nv_bfloat16* src = ok ? w + (long long)gk * ldw + gc : w;
        cp_async<CB>(smem_u32(bs + row * BR_LD + ch * EC), src,
                     ok ? clamp_bytes<CB>(M - gc) : 0);
      }
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < KT) load_stage(pre % STAGES, pre);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * A_ELEMS;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane % 16);
        ldsm_x4(a[mi], smem_u32(as + row * A_LD + kk + (lane / 16) * 8));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {  // two n8 tiles per ldmatrix.x4
        uint32_t t[4];
        const int nb = wn * 64 + nj * 16;
        if constexpr (KMAJ) {
          const int col = nb + (lane % 8) + (lane / 16) * 8;
          const int k = kk + ((lane / 8) % 2) * 8;
          ldsm_x4(t, smem_u32(bs + col * BK_LD + k));
        } else {
          const int k = kk + (lane % 8) + ((lane / 8) % 2) * 8;
          const int col = nb + (lane / 16) * 8;
          ldsm_x4_t(t, smem_u32(bs + k * BR_LD + col));
        }
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // acc[mi][ni]: rows g and g + 8, columns 2 (lane % 4) and + 1
  const int g = lane / 4, cq = 2 * (lane % 4);
  if (splits == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gr = r0 + wm * 64 + mi * 16 + g + half * 8;
        if (gr >= R) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int gc = n0 + wn * 64 + ni * 8 + cq;
          __nv_bfloat16* o = out + (long long)gr * M + gc;
          const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
          if (gc + 1 < M && (((long long)gr * M + gc) % 2 == 0)) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (gc < M) *o = __float2bfloat16(v0);
            if (gc + 1 < M) o[1] = __float2bfloat16(v1);
          }
        }
      }
    return;
  }

  // split-K (grids of fewer tiles than the card holds): the f32 partial
  // tile to ws [splits][R][M]; the last block of the tile to arrive sums
  // the splits in order, rounds once and resets the tile's counter
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = r0 + wm * 64 + mi * 16 + g + half * 8;
      if (gr >= R) continue;
      float* o = ws + ((long long)split * R + gr) * M;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int gc = n0 + wn * 64 + ni * 8 + cq;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (gc + 1 < M && M % 2 == 0) {
          *reinterpret_cast<float2*>(o + gc) = make_float2(v0, v1);
        } else {
          if (gc < M) o[gc] = v0;
          if (gc + 1 < M) o[gc + 1] = v1;
        }
      }
    }
  __shared__ int is_last;
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int rows = min(BM, R - r0), cols = min(BN, M - n0);
  if (cols % 4 == 0 && M % 4 == 0) {  // 4 columns per thread, 16-byte loads
    const int vc = cols / 4;
#pragma unroll 4
    for (int o = tid; o < rows * vc; o += THREADS) {
      const int gr = r0 + o / vc, gc = n0 + o % vc * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(
            ws + ((long long)sp * R + gr) * M + gc));
        v.x += t.x;
        v.y += t.y;
        v.z += t.z;
        v.w += t.w;
      }
      __nv_bfloat162* d =
          reinterpret_cast<__nv_bfloat162*>(out + (long long)gr * M + gc);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
#pragma unroll 4
    for (int o = tid; o < rows * cols; o += THREADS) {
      const int gr = r0 + o / cols, gc = n0 + o % cols;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        v += __ldcg(ws + ((long long)sp * R + gr) * M + gc);
      out[(long long)gr * M + gc] = __float2bfloat16(v);
    }
  }
  if (tid == 0) *counter = 0;
}

}  // namespace tc

// ---- prefill, bf16: wgmma --------------------------------------------------

namespace wg {

// one wgmma m64n128k16 (bf16 in, f32 accumulate into d), A and B from
// shared memory through descriptors; TRANS_B: B is MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %66;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, %130;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TRANS_B));
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
// generic-proxy writes (cp.async) visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

constexpr int WBM = 128, WBK = 64;
// stages of the ring: 3 for 128-column tiles (96 KB: two blocks per SM),
// 4 for 256 (one block per SM either way); all but two loaded ahead, one
// wgmma group in flight
__host__ __device__ constexpr int w_stages(int bn) { return bn == 256 ? 4 : 3; }
constexpr int WTHREADS = 256;  // 2 warpgroups, 64 rows each
constexpr int W_A_BYTES = WBM * 128;  // 128 rows of 128 B
// a stage: A, then B (BN rows, or BN / 64 column groups, of 128 B)
__host__ __device__ constexpr int w_stage_bytes(int bn) {
  return W_A_BYTES + bn * 128;
}
__host__ __device__ constexpr int w_smem(int bn) {
  return w_stages(bn) * w_stage_bytes(bn) + 1024;  // + alignment
}

// x [R, N] row-major, N % 8 == 0; w K-major (KMAJ: w[n, m] at
// w + n + m * ldw) or row-major (at w + n * ldw + m), ldw % 8 == 0, x and
// w on 16 bytes. Block tile 128 x BN x 64: two warpgroups of 64 rows, one
// wgmma m64nBNk16 per 16 of depth (B transposed by the instruction for a
// row-major w), a cp.async ring (w_stages) with all but two stages loaded
// ahead and one wgmma group in flight. Tiles are stored with the 128-byte swizzle: A and
// a K-major B as rows of 64 k (128 bytes; 16-byte chunk c of row r at
// c ^ (r % 8)), a row-major B as 64-column groups [64 k][64 n] (8 KB each).
template <bool KMAJ, int BN>
__global__ void __launch_bounds__(WTHREADS)
wg_kernel(const __nv_bfloat16* __restrict__ x,
          const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
          int R, int N, int M, long long ldw) {
  extern __shared__ __align__(1024) unsigned char wsmem_raw[];
  const uint32_t base =
      (smem_u32(wsmem_raw) + 1023) & ~1023u;  // 1024-byte aligned stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4;
  constexpr int STAGE = w_stage_bytes(BN);
  constexpr int WSTAGES = w_stages(BN), WAHEAD = WSTAGES - 2;
  const int r0 = blockIdx.y * WBM, n0 = blockIdx.x * BN;
  const int KT = (N + WBK - 1) / WBK;

  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * WBK;
    const uint32_t a_s = base + st * STAGE;
    const uint32_t b_s = a_s + W_A_BYTES;
#pragma unroll
    for (int i = tid; i < 128 * 8; i += WTHREADS) {  // A: 128 rows x 8 chunks
      const int r = i / 8, c = i % 8;
      const int gr = r0 + r, gk = k0 + c * 8;
      const bool ok = gr < R && gk < N;
      cp_async<16>(a_s + r * 128 + ((c ^ (r & 7)) * 16),
                   ok ? x + (long long)gr * N + gk : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BN * 8; i += WTHREADS) {
      if constexpr (KMAJ) {  // B: BN columns x 8 chunks along K
        const int n = i / 8, c = i % 8;
        const int gn = n0 + n, gk = k0 + c * 8;
        const bool ok = gn < M && gk < N;
        cp_async<16>(b_s + n * 128 + ((c ^ (n & 7)) * 16),
                     ok ? w + (long long)gn * ldw + gk : w, ok ? 16 : 0);
      } else {  // B: 64 k rows x BN / 8 chunks along M, 64-column groups
        const int k = i / (BN / 8), cn = i % (BN / 8), half = cn / 8,
                  c = cn % 8;
        const int gk = k0 + k, gc = n0 + cn * 8;
        const bool ok = gk < N && gc < M;
        cp_async<16>(b_s + half * (64 * 128) + k * 128 + ((c ^ (k & 7)) * 16),
                     ok ? w + (long long)gk * ldw + gc : w,
                     ok ? min(16, (M - gc) * 2) : 0);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // the stage a prefetch overwrites was read by the wgmma group before
  // the one left in flight, which wgmma_wait<1> has retired
#pragma unroll
  for (int s = 0; s < WAHEAD; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<WAHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int pre = kt + WAHEAD;
    if (pre < KT) load_stage(pre % WSTAGES, pre);
    cp_async_commit();

    const uint32_t a_s = base + (kt % WSTAGES) * STAGE + wg * 64 * 128;
    const uint32_t b_s = base + (kt % WSTAGES) * STAGE + W_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < WBK / 16; ++j) {
      const uint64_t da = smem_desc(a_s + j * 32, 16, 1024);
      // K-major B: like A; row-major B: 8 KB between 64-column groups
      // (leading), 1 KB between 8-row groups of k (stride)
      const uint64_t db = KMAJ ? smem_desc(b_s + j * 32, 16, 1024)
                               : smem_desc(b_s + j * 16 * 128, 8192, 1024);
      if constexpr (BN == 256)
        wgmma_m64n256k16<KMAJ ? 0 : 1>(acc, da, db);
      else
        wgmma_m64n128k16<KMAJ ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // acc: warp (warp % 4) of the warpgroup owns rows 16 (warp % 4) + g and
  // + 8; n8 block jb holds columns 8 jb + 2 (lane % 4) and + 1
  const int g = lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gr = r0 + wg * 64 + (warp % 4) * 16 + g + half * 8;
    if (gr >= R) continue;
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      const int gc = n0 + jb * 8 + cq;
      __nv_bfloat16* o = out + (long long)gr * M + gc;
      const float v0 = acc[4 * jb + 2 * half], v1 = acc[4 * jb + 2 * half + 1];
      if (gc + 1 < M && (((long long)gr * M + gc) % 2 == 0)) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (gc < M) *o = __float2bfloat16(v0);
        if (gc + 1 < M) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

}  // namespace wg


template <typename T, typename W>
void launch_tile(const void* x, const void* w, const float* scale, void* out,
                 int R, int N, int M, long long swn, long long swm, int bm,
                 cudaStream_t stream, const Group& g = Group{}, int E = 1) {
  const dim3 grid((M + BN - 1) / BN, (R + bm - 1) / bm, E);
  if (bm == 16) {
    matmul_kernel<T, W, 16><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scale,
        static_cast<T*>(out), R, N, M, swn, swm, g);
  } else {
    matmul_kernel<T, W, 64><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scale,
        static_cast<T*>(out), R, N, M, swn, swm, g);
  }
}

// raise a kernel's dynamic shared memory limit to `bytes` when a call
// needs more than it allows (`allowed`: the limit set so far)
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T, int RB>
cudaError_t launch_stream(int kernel, const void* x, const void* w, void* out,
                          int R, int N, int M, long long swn, long long swm,
                          int p0, int p1, void* ws, void* counters,
                          cudaStream_t stream, const Group& g, int E) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (kernel == 1) {  // stream_rows: p0 = rows per split, p1 = splits
    constexpr int TILE = 8 * (16 / sizeof(T));  // stream_rows_kernel's
    if (p0 <= 0 || (long long)R * p0 > stream::XS_FLOATS || p1 <= 0 ||
        (long long)p0 * (p1 - 1) >= N || (long long)p0 * p1 < N ||
        (p1 > 1 && (ws == nullptr || counters == nullptr)))
      return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    const size_t bytes = sizeof(float) * (R * p0 > stream::WARPS * RB * TILE
                                              ? R * p0
                                              : stream::WARPS * RB * TILE);
    const cudaError_t e =
        allow_smem(stream::stream_rows_kernel<T, RB>, bytes, allowed);
    if (e != cudaSuccess) return e;
    const dim3 grid((M + TILE - 1) / TILE, p1, E);
    stream::stream_rows_kernel<T, RB><<<grid, stream::THREADS, bytes, stream>>>(
        xt, wt, ot, static_cast<float*>(ws), static_cast<int*>(counters), R,
        N, M, swn, p0, p1, g);
  } else {  // stream_cols: p0 = blocks
    if (E != 1) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    const size_t bytes = (size_t)R * N * sizeof(float);
    const cudaError_t e =
        allow_smem(stream::stream_cols_kernel<T, RB>, bytes, allowed);
    if (e != cudaSuccess) return e;
    if (p0 <= 0) return cudaErrorInvalidValue;
    stream::stream_cols_kernel<T, RB>
        <<<p0, stream::THREADS, bytes, stream>>>(
            xt, wt, ot, R, N, M, swm);
  }
  return cudaSuccess;
}

template <int RB, int CB>
cudaError_t launch_stream_mma(const void* x, const void* w, void* out, int R,
                              int N, int M, long long ldw, int kc, int splits,
                              void* ws, void* counters, cudaStream_t stream,
                              const Group& g, int E) {
  if (kc <= 0 || splits <= 0 || (long long)kc * (splits - 1) >= N ||
      (long long)kc * splits < N ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)RB * stream::mma_x_ld(kc) * 2 +
      (size_t)stream::MSTAGES * stream::MBK * stream::MLD * 2;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const cudaError_t e =
      allow_smem(stream::stream_mma_kernel<RB, CB>, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + stream::MT - 1) / stream::MT, splits, E);
  stream::stream_mma_kernel<RB, CB><<<grid, stream::THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), R, N, M, ldw, kc,
      splits, g);
  return cudaSuccess;
}

// the widest cp.async (16, 8 or 4 bytes) that w's base and row stride
// allow; rows off 4 bytes are refused (the route sends them to
// stream_rows)
template <int RB>
cudaError_t launch_stream_mma_any(const void* x, const void* w, void* out,
                                  int R, int N, int M, long long ldw, int kc,
                                  int splits, void* ws, void* counters,
                                  cudaStream_t s, const Group& g, int E) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w) | (uintptr_t)(ldw * 2) |
                      (uintptr_t)(g.sw * 2);
  if (a % 16 == 0)
    return launch_stream_mma<RB, 16>(x, w, out, R, N, M, ldw, kc, splits, ws,
                                     counters, s, g, E);
  if (a % 8 == 0)
    return launch_stream_mma<RB, 8>(x, w, out, R, N, M, ldw, kc, splits, ws,
                                    counters, s, g, E);
  if (a % 4 == 0)
    return launch_stream_mma<RB, 4>(x, w, out, R, N, M, ldw, kc, splits, ws,
                                    counters, s, g, E);
  return cudaErrorInvalidValue;
}

template <bool KMAJ, int CB>
cudaError_t launch_tc(const void* x, const void* w, void* out, int R, int N,
                      int M, long long ldw, int splits, void* ws,
                      void* counters, cudaStream_t stream, const Group& g,
                      int E) {
  static size_t allowed = 48 * 1024;
  constexpr size_t bytes = tc::smem_bytes<KMAJ>();
  const cudaError_t e = allow_smem(tc::tc_kernel<KMAJ, CB>, bytes, allowed);
  if (e != cudaSuccess) return e;
  const int kts = (N + tc::BK - 1) / tc::BK;
  const int per = (kts + splits - 1) / splits;
  if (splits <= 0 || kts < 1 || (long long)per * (splits - 1) >= kts ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((M + tc::BN - 1) / tc::BN, (R + tc::BM - 1) / tc::BM,
                  splits * E);
  tc::tc_kernel<KMAJ, CB><<<grid, tc::THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), R, N, M, ldw,
      per, splits, g);
  return cudaSuccess;
}

// the widest cp.async that w's base and row stride allow
template <bool KMAJ>
cudaError_t launch_tc_any(const void* x, const void* w, void* out, int R,
                          int N, int M, long long ldw, int splits, void* ws,
                          void* counters, cudaStream_t stream,
                          const Group& g, int E) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(w) | (uintptr_t)(ldw * 2) |
                      (uintptr_t)(g.sw * 2);
  if (a % 16 == 0)
    return launch_tc<KMAJ, 16>(x, w, out, R, N, M, ldw, splits, ws, counters,
                               stream, g, E);
  if (a % 8 == 0)
    return launch_tc<KMAJ, 8>(x, w, out, R, N, M, ldw, splits, ws, counters,
                              stream, g, E);
  if (a % 4 == 0)
    return launch_tc<KMAJ, 4>(x, w, out, R, N, M, ldw, splits, ws, counters,
                              stream, g, E);
  return launch_tc<KMAJ, 2>(x, w, out, R, N, M, ldw, splits, ws, counters,
                            stream, g, E);
}

template <bool KMAJ, int BN>
cudaError_t launch_wg(const void* x, const void* w, void* out, int R, int N,
                      int M, long long ldw, cudaStream_t stream) {
  if (N % 8 != 0 || ldw % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  constexpr size_t bytes = wg::w_smem(BN);
  const cudaError_t e = allow_smem(wg::wg_kernel<KMAJ, BN>, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BN - 1) / BN, (R + wg::WBM - 1) / wg::WBM);
  wg::wg_kernel<KMAJ, BN><<<grid, wg::WTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      R, N, M, ldw);
  return cudaSuccess;
}

template <typename T, int RB, int TERMS>
cudaError_t launch_q8_mma(const void* x, const void* w, const float* scale,
                          void* out, int R, int N, int M, long long ldw,
                          int kc, int splits, void* ws, void* counters,
                          cudaStream_t stream) {
  if (kc <= 0 || splits <= 0 || (long long)kc * (splits - 1) >= N ||
      (long long)kc * splits < N || ldw % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const size_t bytes = stream::q8_smem<RB, TERMS>(kc);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const cudaError_t e =
      allow_smem(stream::stream_mma_q8_kernel<T, RB, TERMS>, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + stream::MT - 1) / stream::MT, splits);
  stream::stream_mma_q8_kernel<T, RB, TERMS>
      <<<grid, stream::THREADS, bytes, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
          static_cast<T*>(out), static_cast<float*>(ws),
          static_cast<int*>(counters), R, N, M, ldw, kc, splits);
  return cudaSuccess;
}

template <typename T, int RB, int TERMS>
cudaError_t launch_q8_cols(const void* x, const void* w, const float* scale,
                           void* out, int R, int N, int M, long long swm,
                           int blocks, cudaStream_t stream) {
  if (blocks <= 0 || N % 64 != 0 || swm % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t bytes = stream::q8_cols_smem<RB, TERMS>(N);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;
  const cudaError_t e =
      allow_smem(stream::stream_cols_q8_kernel<T, RB, TERMS>, bytes, allowed);
  if (e != cudaSuccess) return e;
  stream::stream_cols_q8_kernel<T, RB, TERMS>
      <<<blocks, stream::THREADS, bytes, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
          static_cast<T*>(out), R, N, M, swm);
  return cudaSuccess;
}

// quant_matmul: the int8 routes (xfer_matmul's kernel codes: 0 = tile,
// 2 = stream_cols on tensor cores for a K-major w, 4 = stream_mma); x as
// three bf16 terms when fp32 (TERMS = 3), one when bf16
template <typename T>
cudaError_t dispatch_q8(const void* x, const void* w, const float* scale,
                        void* out, int R, int N, int M, long long swn,
                        long long swm, int kernel, int p0, int p1, void* ws,
                        void* counters, cudaStream_t s) {
  constexpr int TERMS = std::is_same<T, float>::value ? 3 : 1;
  switch (kernel) {
    case 0:
      if (p0 != 16 && p0 != 64) return cudaErrorInvalidValue;
      launch_tile<T, int8_t>(x, w, scale, out, R, N, M, swn, swm, p0, s);
      return cudaSuccess;
    case 2:
      if (R > 16 || swn != 1) return cudaErrorInvalidValue;
      return R <= 8 ? launch_q8_cols<T, 8, TERMS>(x, w, scale, out, R, N, M,
                                                  swm, p0, s)
                    : launch_q8_cols<T, 16, TERMS>(x, w, scale, out, R, N, M,
                                                   swm, p0, s);
    case 4:
      if (R > 16 || swm != 1) return cudaErrorInvalidValue;
      return R <= 8 ? launch_q8_mma<T, 8, TERMS>(x, w, scale, out, R, N, M,
                                                 swn, p0, p1, ws, counters, s)
                    : launch_q8_mma<T, 16, TERMS>(x, w, scale, out, R, N, M,
                                                  swn, p0, p1, ws, counters, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_fp(const void* x, const void* w, void* out, int R, int N,
                        int M, long long swn, long long swm, int kernel,
                        int p0, int p1, void* ws, void* counters,
                        cudaStream_t s, const Group& g, int E) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  switch (kernel) {
    case 0:
      if (p0 != 16 && p0 != 64) return cudaErrorInvalidValue;
      launch_tile<T, T>(x, w, nullptr, out, R, N, M, swn, swm, p0, s, g, E);
      return cudaSuccess;
    case 1:
    case 2:
      if (R > 16) return cudaErrorInvalidValue;
      return R <= 8 ? launch_stream<T, 8>(kernel, x, w, out, R, N, M, swn,
                                          swm, p0, p1, ws, counters, s, g, E)
                    : launch_stream<T, 16>(kernel, x, w, out, R, N, M, swn,
                                           swm, p0, p1, ws, counters, s, g, E);
    case 4:
      if (!BF16 || R > 16 || swm != 1) return cudaErrorInvalidValue;
      return R <= 8 ? launch_stream_mma_any<8>(x, w, out, R, N, M, swn, p0, p1,
                                               ws, counters, s, g, E)
                    : launch_stream_mma_any<16>(x, w, out, R, N, M, swn, p0, p1,
                                                ws, counters, s, g, E);
    case 5:
      if (!BF16 || E != 1) return cudaErrorInvalidValue;
      if (p1 != 128 && p1 != 256) return cudaErrorInvalidValue;
      if (swn == 1)
        return p1 == 256 ? launch_wg<true, 256>(x, w, out, R, N, M, swm, s)
                         : launch_wg<true, 128>(x, w, out, R, N, M, swm, s);
      if (swm == 1)
        return p1 == 256 ? launch_wg<false, 256>(x, w, out, R, N, M, swn, s)
                         : launch_wg<false, 128>(x, w, out, R, N, M, swn, s);
      return cudaErrorInvalidValue;
    case 3:
      if (!BF16 || N % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return cudaErrorInvalidValue;
      if (swm == 1)
        return launch_tc_any<false>(x, w, out, R, N, M, swn, p1, ws, counters,
                                    s, g, E);
      if (swn == 1)
        return launch_tc_any<true>(x, w, out, R, N, M, swm, p1, ws, counters,
                                   s, g, E);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan of one xfer_matmul shape, built once by the wrapper
// (xfer_matmul.py: _Plan, the same layout) and passed by address, so that
// a call crosses into C with five arguments. dtype (of x and out): 0 =
// float32, 1 = bfloat16. w[n, m] lives at w + n * swn + m * swm (element
// strides). kernel (xfer_matmul.py: route): 0 = tile (p0 = 16 or 64 rows
// per block), 1 = stream_rows (p0 = rows of N per split, p1 = splits; ws
// holds p1 * R * M floats and counters one zeroed int per 8 x (16 /
// element size) columns when p1 > 1), 2 = stream_cols (p0 = blocks), 3 =
// tc (bf16; p1 = splits of the k-tiles, ws holds p1 * R * M floats and
// counters one zeroed int per 128 x 128 output tile when p1 > 1), 4 =
// stream_mma (bf16, p0 and p1 as for stream_rows, w's rows on 4 bytes,
// a counter per 64 columns), 5 = wgmma (bf16, p1 = 128 or 256 columns per
// block, rows on 16 bytes). experts > 1 (xfer_matmul_experts, kernels 0,
// 1, 3 and 4): one launch over that many products, expert e at x + e *
// sx, w + e * sw, out + e * so, its split-K workspace at ws + e * sws
// floats and its counters at counters + e * scnt (Group); 0 or 1: one
// product.
struct XferPlan {
  int R, N, M, dtype;
  long long swn, swm;
  int kernel, p0, p1, pad;
  void* ws;
  void* counters;
  int experts, scnt;
  long long sx, sw, so, sws;
};

// Returns the cudaError_t of the launch (0 = success).
extern "C" int xfer_matmul_launch(const void* x, const void* w, void* out,
                                  const XferPlan* p, void* stream) {
  if (p->R <= 0 || p->M <= 0 || p->N < 0 || p->experts > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = p->experts > 1 ? p->experts : 1;
  const Group g{p->sx, p->sw, p->so, p->sws, p->scnt};
  cudaError_t e;
  if (p->dtype == 0) {
    e = dispatch_fp<float>(x, w, out, p->R, p->N, p->M, p->swn, p->swm,
                           p->kernel, p->p0, p->p1, p->ws, p->counters, s, g,
                           E);
  } else if (p->dtype == 1) {
    e = dispatch_fp<__nv_bfloat16>(x, w, out, p->R, p->N, p->M, p->swn,
                                   p->swm, p->kernel, p->p0, p->p1, p->ws,
                                   p->counters, s, g, E);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// quant_matmul: the same plan (its route in quant_matmul.py), w int8,
// scale M contiguous floats; kernel 0 = tile (p0 = 16 or 64 rows per
// block), 2 = stream_cols (K-major w on tensor cores, p0 = blocks), 4 =
// stream_mma (int8, p0 and p1 as for stream_rows, rows on 16 bytes, a
// counter per 64 columns).
extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* scale, void* out,
                                   const XferPlan* p, void* stream) {
  if (p->R <= 0 || p->M <= 0 || p->N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  cudaError_t e;
  if (p->dtype == 0) {
    e = dispatch_q8<float>(x, w, sc, out, p->R, p->N, p->M, p->swn, p->swm,
                           p->kernel, p->p0, p->p1, p->ws, p->counters, s);
  } else if (p->dtype == 1) {
    e = dispatch_q8<__nv_bfloat16>(x, w, sc, out, p->R, p->N, p->M, p->swn,
                                   p->swm, p->kernel, p->p0, p->p1, p->ws,
                                   p->counters, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
