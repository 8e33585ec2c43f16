// paged_attention: single-token decode attention through a page table.
// q [B, H, D]; kp, vp [P, ps, G, D] page pools; page_table [B, M] int32;
// lengths [B] int32 valid kv count per row. Head h reads kv group
// h / (H / G). Returns o [B, H, D].
//
// The fp body (paged_attention_launch, paged_split_kernel) replaces the
// TPU kernel repro/kernels/paged_attention.py: paged_attention /
// _paged_kernel (body _paged_body). What bounds it on the H100: reading
// the valid K and V rows once, 4*D flops per 2*2*D bytes (bf16) for each
// query head of a group, far below the card's operations-per-byte ridge,
// so the bound is device-memory bytes. The design:
//
// - One block per (row, kv group, chunk of a fixed number of positions,
//   the wrapper's CHUNK). All H / G query heads of the group are computed
//   from each K/V tile it loads, as _paged_body computes every head of a
//   page from one load ("grd,pgd->grp"): 10 heads per load for
//   recurrentgemma-2b's MQA, 1 for qwen1.5-0.5b. The old port ran one
//   block per (row, head), so ten blocks read the same K/V rows.
// - K/V tiles are staged through the page table (one lookup per position)
//   into shared memory with 16-byte cp.async loads, double-buffered (the
//   next tile in flight while this one is used). q.k runs with lanes
//   across D, each warp's positions held in registers against 4 heads at
//   a time, the 4 x positions dots reduce-scattered over the lanes; p.v
//   runs with threads across D (two dims each) and position stripes, four
//   heads per pass over a V row.
// - A row's positions are split into chunks (flash-decoding), so a long
//   row runs on many SMs. The chunk count comes from the table width M *
//   ps, which the host knows without reading `lengths`; chunks past a
//   row's length exit at once. A row of one chunk writes o directly; a
//   longer row leaves each chunk's (m, l, acc) in an f32 workspace, and
//   the chunk that arrives last at the row's counter (atomicAdd after a
//   fence) merges chunks 0..nc-1 in order, weight exp(m_c - max m) each,
//   normalises once by max(l, 1e-30) and resets the counter to 0. One
//   launch per call, no float atomics: bit-stable run to run. Chunks and
//   tiles are counted in positions, not pages, so the dense slot grid
//   (one page of max_len per row) and a pool of 64-token pages sum the
//   same values in the same order.
//
// A row's length must lie in [1, M * ps] and its table entries in
// [0, P): the kernel traps otherwise (for the dense slot grid that is the
// serving engine's `positions < max_len`), so the launch fails with an
// error instead of reading out of bounds. __trap() is no function call,
// so unlike assert() it costs the kernel no stack frame and no spills.
//
// The int8 body (paged_attention_q8_launch, paged_kernel<T, THREADS>)
// replaces _paged_kernel_q8 of the same TPU file: kp/vp hold
// int8 and two f32 scale pools ks/vs [P, ps, G, 1] ride the same
// page-table indirection (one scale per token per kv group). One block
// per (row, head) walks the row's positions THREADS at a time (128 for D
// <= 128, 256 for D = 256), each thread one position, dequantising each
// element in registers in f32 before its dot (k * ks) or its
// accumulation (v * vs), as the TPU body rehydrates a page in VMEM; the
// fp extent never exists in device memory. Its bound is the int8 rows
// plus their scales: 2*(D+4) bytes per position per group instead of
// 2*2*D in bf16. It keeps that simple design: grouping and splitting it
// as the fp body does is later work.
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

// The int8 body. T: q and o; the pools are int8 with the f32 scale pools
// ks/vs; THREADS: threads_for(D).
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const int8_t* __restrict__ kp,
             const int8_t* __restrict__ vp, const float* __restrict__ ks,
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
      const int8_t* krow = kp + row * D;
      const float sk = ks[row];
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
      const float sv = vs[row];
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

// ---- the fp body: grouped heads, split positions --------------------------

namespace split {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HG = 4;  // heads per pass (q.k scatter, p.v)

// positions per shared-memory tile: 16 KB of K (and of V) per stage,
// 16 to 64 positions, and at least one position per lane group of every
// warp (head dims under 32 put 32 / D positions on a warp at once)
template <typename T, int D>
__host__ __device__ constexpr int tile_positions() {
  constexpr int by_bytes = 16384 / (D * (int)sizeof(T));
  constexpr int t = by_bytes < 16 ? 16 : (by_bytes > 64 ? 64 : by_bytes);
  constexpr int need = WARPS * (32 / (D < 32 ? D : 32));
  return t > need ? t : need;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// E consecutive elements of T in shared memory as fp32, 16 bytes a load
// where they fill whole 16-byte vectors
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float (&f)[E]) {
  if constexpr (sizeof(T) == 2 && E % 8 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + e);
      const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[e + 2 * i] = __uint_as_float(v[i] << 16);
        f[e + 2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
      }
    }
  } else if constexpr (sizeof(T) == 2 && E == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xffff0000u);
  } else if constexpr (sizeof(T) == 4 && E == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x;
    f[1] = u.y;
  } else if constexpr (sizeof(T) == 4 && E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + e);
      f[e] = u.x;
      f[e + 1] = u.y;
      f[e + 2] = u.z;
      f[e + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = to_f32(p[e]);
  }
}

// Sum NV per-lane values over the lanes that differ only in the lane
// bits OFF, OFF / 2, ..., 1 (xor shuffles), halving the values a lane
// keeps at each step (a reduce-scatter). Afterwards v[i] holds the total
// of value first + i, for i < max(1, NV / lanes summed).
template <int N, int OFF, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane,
                                               int& first) {
  if constexpr (OFF >= 1) {
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
      reduce_scatter<H, OFF / 2, NV>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2, NV>(v, lane, first);
    }
  }
}

// floats of shared memory ahead of the K/V stages (rounded to 16 bytes)
__host__ __device__ inline int head_floats(int rep, int D, int tp) {
  const int rep4 = (rep + HG - 1) / HG * HG;
  return (tp * rep4 + rep4 * D + rep * 2 * THREADS + 3 * rep + 2 * tp + 3) / 4 * 4;
}

// Block (chunk c, kv group g, row b): the positions [c * chunk,
// min(len, (c + 1) * chunk)) of row b for the rep = H / G query heads of
// group g. Single-chunk rows write o directly; longer rows leave (m, l,
// acc) per chunk in ws and the last chunk to arrive merges them in chunk
// order.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ o,
                   float* __restrict__ ws, int* __restrict__ counters, int H,
                   int G, int ps, int M, int P, int chunk, float scale) {
  constexpr int TP = tile_positions<T, D>();
  constexpr int LP = D < 32 ? D : 32;      // lanes per position (q.k)
  constexpr int E = D / LP;                // dims per lane (q.k)
  constexpr int PPW = 32 / LP;             // positions per warp pass
  constexpr int NPW = TP / (WARPS * PPW);  // positions per lane per tile
  constexpr int NV = HG * NPW;             // dots per lane per head pass
  constexpr int DPT = D >= 2 ? 2 : 1;      // p.v: dims per thread
  constexpr int STRIPES = THREADS * DPT / D;  // p.v: position stripes
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  static_assert(NPW >= 1 && TP % (WARPS * PPW) == 0, "tile geometry");
  static_assert(D <= THREADS && THREADS % D == 0, "head dim");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, g = blockIdx.y;
  const long long b = blockIdx.z;
  const int NC = gridDim.x;
  const int rep = H / G;
  const int rep4 = (rep + HG - 1) / HG * HG;
  const int len = lengths[b];
  if (len < 1 || len > M * ps) __trap();
  const int nc = (len + chunk - 1) / chunk;
  if (c >= nc) return;  // past the row's length: nothing to read
  const int t_begin = c * chunk, t_end = min(len, t_begin + chunk);
  const int* trow = table + b * M;

  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                  // [TP][rep4]: scores, then p
  float* q_s = s_s + TP * rep4;       // [rep4][D], scaled (zero past rep)
  float* acc_s = q_s + rep4 * D;      // [rep][STRIPES][D]
  float* m_s = acc_s + rep * 2 * THREADS;
  float* l_s = m_s + rep;
  float* al_s = l_s + rep;
  long long* rows_s = reinterpret_cast<long long*>(
      smem + (TP * rep4 + rep4 * D + rep * 2 * THREADS + 3 * rep + 1) / 2 * 2);
  T* kv = reinterpret_cast<T*>(smem + head_floats(rep, D, TP));
  // stage st: K at kv + st * 2 * TP * D, V right after it

  for (int i = tid; i < rep4 * D; i += THREADS)
    q_s[i] = i < rep * D
                 ? to_f32(q[(b * H + (long long)g * rep) * D + i]) * scale
                 : 0.f;
  for (int i = tid; i < TP * rep4; i += THREADS) s_s[i] = 0.f;
  for (int i = tid; i < rep * STRIPES * D; i += THREADS) acc_s[i] = 0.f;
  for (int r = tid; r < rep; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // K and V rows of the tile starting at t0 (n valid positions) through
  // the page table into stage st: one table lookup per position, then
  // 16-byte copies
  auto stage = [&](int st, int t0, int n) {
    for (int p = tid; p < n; p += THREADS) {
      const int t = t0 + p;
      const int page = trow[t / ps];
      if (page < 0 || page >= P) __trap();
      rows_s[p] = (((long long)page * ps + t % ps) * G + g) * D;
    }
    __syncthreads();
    T* ks = kv + st * 2 * TP * D;
    T* vs = ks + TP * D;
    if constexpr (CPR >= 1) {
      constexpr int EV = 16 / sizeof(T);
      for (int i = tid; i < 2 * n * CPR; i += THREADS) {
        const int which = i / (n * CPR), j = i % (n * CPR);
        const int p = j / CPR, ch = j % CPR;
        const T* src = (which ? vp : kp) + rows_s[p] + ch * EV;
        cp_async16(smem_u32((which ? vs : ks) + p * D + ch * EV), src);
      }
    } else {  // rows under 16 bytes: element by element
      for (int i = tid; i < 2 * n * D; i += THREADS) {
        const int which = i / (n * D), j = i % (n * D);
        const int p = j / D, d = j % D;
        (which ? vs : ks)[p * D + d] = (which ? vp : kp)[rows_s[p] + d];
      }
    }
  };

  const int ntiles = (t_end - t_begin + TP - 1) / TP;
  stage(0, t_begin, min(TP, t_end - t_begin));
  cp_async_commit();
  const int pp = lane / LP, li = lane % LP;
  const int stripe = tid / (D / DPT), dim = tid % (D / DPT) * DPT;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      __syncthreads();  // rows_s is rewritten by the next stage call
      const int t1 = t_begin + (it + 1) * TP;
      stage((it + 1) & 1, t1, min(TP, t_end - t1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(TP, t_end - (t_begin + it * TP));
    const T* ks = kv + (it & 1) * 2 * TP * D;
    const T* vs = ks + TP * D;

    // scores: lanes across D, the warp's positions in registers, every
    // head of the group against each K row loaded once; HG heads x NPW
    // positions reduce-scattered over the LP lanes of a position
    float kf[NPW][E];
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int p = (j * WARPS + warp) * PPW + pp;
      if (p < n) {
        load_row<T, E>(ks + p * D + li * E, kf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[j][e] = 0.f;
      }
    }
    for (int r0 = 0; r0 < rep; r0 += HG) {
      float dots[NV];  // [HG][NPW]
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        float qf[E];
        load_row<float, E>(q_s + (r0 + hh) * D + li * E, qf);
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kf[j][e], dot);
          dots[hh * NPW + j] = dot;
        }
      }
      int first = 0;
      reduce_scatter<NV, LP / 2, NV>(dots, li, first);
#pragma unroll
      for (int i = 0; i < (NV > LP ? NV / LP : 1); ++i) {
        const int jj = first + i, hh = jj / NPW, j = jj % NPW;
        const int p = (j * WARPS + warp) * PPW + pp;
        if (r0 + hh < rep) s_s[p * rep4 + r0 + hh] = p < n ? dots[i] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int r = warp; r < rep; r += WARPS) {
      float tmax = NEG_INF;
      for (int p = lane; p < n; p += 32) tmax = fmaxf(tmax, s_s[p * rep4 + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);  // n >= 1: a real score
      float sum = 0.f;
      for (int p = lane; p < TP; p += 32) {
        const float e = p < n ? expf(s_s[p * rep4 + r] - m_new) : 0.f;
        s_s[p * rep4 + r] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // p.v: thread (stripe, DPT dims), HG heads per pass over its positions
    for (int r0 = 0; r0 < rep; r0 += HG) {
      float t[HG][DPT];
#pragma unroll
      for (int i = 0; i < HG; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) t[i][e] = 0.f;
      for (int p = stripe; p < n; p += STRIPES) {
        float v[DPT];
        load_row<T, DPT>(vs + p * D + dim, v);
        const float4 pr = *reinterpret_cast<const float4*>(s_s + p * rep4 + r0);
        const float pv[HG] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int i = 0; i < HG; ++i)
#pragma unroll
          for (int e = 0; e < DPT; ++e) t[i][e] = fmaf(pv[i], v[e], t[i][e]);
      }
#pragma unroll
      for (int i = 0; i < HG; ++i) {
        if (r0 + i >= rep) break;
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          float* a = acc_s + ((r0 + i) * STRIPES + stripe) * D + dim + e;
          *a = *a * al_s[r0 + i] + t[i][e];
        }
      }
    }
  }

  // this chunk's (m, l, acc), stripes summed in order; the workspace holds
  // acc [B][G][NC][rep][D], then (m, l) [B][G][NC][rep][2]
  constexpr int VO = D % 4 == 0 ? 4 : 1;  // dims per thread below
  __syncthreads();
  const long long slot = (b * G + g) * NC + c;  // this chunk's workspace row
  float* ws_ml = ws + (long long)gridDim.z * G * NC * rep * D;
  for (int i = tid; i < rep * D / VO; i += THREADS) {
    const int r = i / (D / VO), d = i % (D / VO) * VO;
    float a[VO];
#pragma unroll
    for (int e = 0; e < VO; ++e) {
      a[e] = 0.f;
      for (int st = 0; st < STRIPES; ++st)
        a[e] += acc_s[(r * STRIPES + st) * D + d + e];
    }
    if (nc == 1) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < VO; ++e)
        store(o + (b * H + (long long)g * rep + r) * D + d + e, a[e] / l);
    } else {
#pragma unroll
      for (int e = 0; e < VO; ++e) ws[(slot * rep + r) * D + d + e] = a[e];
    }
  }
  if (nc == 1) return;
  for (int r = tid; r < rep; r += THREADS) {
    ws_ml[(slot * rep + r) * 2] = m_s[r];
    ws_ml[(slot * rep + r) * 2 + 1] = l_s[r];
  }

  // the last chunk of the row to arrive merges chunks 0..nc-1 in order:
  // per head the chunk weights exp(m_c - max m) and the merged l, then
  // every output as the weighted sum of the chunks' acc
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b * G + g, 1) == nc - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long row0 = (b * G + g) * NC;
  float* wm_s = reinterpret_cast<float*>(kv + 4 * TP * D);  // [rep][nc], l [rep]
  for (int r = tid; r < rep; r += THREADS) {
    float mx = NEG_INF;
    for (int cc = 0; cc < nc; ++cc)
      mx = fmaxf(mx, __ldcg(ws_ml + ((row0 + cc) * rep + r) * 2));
    float l = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const float* e = ws_ml + ((row0 + cc) * rep + r) * 2;
      const float wgt = expf(__ldcg(e) - mx);
      wm_s[r * nc + cc] = wgt;
      l = fmaf(wgt, __ldcg(e + 1), l);
    }
    wm_s[rep * nc + r] = l;
  }
  __syncthreads();
  constexpr int BATCH = 8;  // chunk loads in flight per output vector
  for (int i = tid; i < rep * D / VO; i += THREADS) {
    const int r = i / (D / VO), d = i % (D / VO) * VO;
    float a[VO];
#pragma unroll
    for (int e = 0; e < VO; ++e) a[e] = 0.f;
    for (int c0 = 0; c0 < nc; c0 += BATCH) {
      float v[BATCH][VO];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const float* src = ws + ((row0 + c0 + j) * rep + r) * D + d;
        if (c0 + j >= nc) {
#pragma unroll
          for (int e = 0; e < VO; ++e) v[j][e] = 0.f;
        } else if constexpr (VO == 4) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(src));
          v[j][0] = t.x;
          v[j][1] = t.y;
          v[j][2] = t.z;
          v[j][3] = t.w;
        } else {
          v[j][0] = __ldcg(src);
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (c0 + j >= nc) break;
        const float wgt = wm_s[r * nc + c0 + j];
#pragma unroll
        for (int e = 0; e < VO; ++e) a[e] = fmaf(wgt, v[j][e], a[e]);
      }
    }
    const float l = fmaxf(wm_s[rep * nc + r], 1e-30f);
#pragma unroll
    for (int e = 0; e < VO; ++e)
      store(o + (b * H + (long long)g * rep + r) * D + d + e, a[e] / l);
  }
  if (tid == 0) counters[b * G + g] = 0;
}

}  // namespace split

bool bad_geometry(int B, int H, int G, int D, int ps, int M, int P) {
  return B <= 0 || H <= 0 || G <= 0 || H % G != 0 || D <= 0 || D > 256 ||
         threads_for(D) % D != 0 || ps <= 0 || M <= 0 || P <= 0;
}

template <typename T, int THREADS>
void launch_nt(const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const void* table, const void* lengths,
               void* o, int B, int H, int G, int D, int ps, int M, int P,
               float scale, cudaStream_t stream) {
  paged_kernel<T, THREADS><<<dim3(H, B), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o), H, G, D, ps, M,
      P, scale);
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const void* ks,
            const void* vs, const void* table, const void* lengths, void* o,
            int B, int H, int G, int D, int ps, int M, int P, float scale,
            cudaStream_t stream) {
  if (threads_for(D) == 128) {
    launch_nt<T, 128>(q, kp, vp, ks, vs, table, lengths, o, B, H, G, D, ps,
                      M, P, scale, stream);
  } else {
    launch_nt<T, 256>(q, kp, vp, ks, vs, table, lengths, o, B, H, G, D, ps,
                      M, P, scale, stream);
  }
}

template <typename T, int D>
cudaError_t launch_split_d(const void* q, const void* kp, const void* vp,
                           const void* table, const void* lengths, void* o,
                           void* ws, void* counters, int B, int H, int G,
                           int ps, int M, int P, int chunk, float scale,
                           cudaStream_t stream) {
  constexpr int TP = split::tile_positions<T, D>();
  const int rep = H / G;
  if (chunk <= 0) return cudaErrorInvalidValue;
  const int nc = (M * ps + chunk - 1) / chunk;
  // head, the two K/V stages, then the merge's chunk weights
  const size_t bytes = split::head_floats(rep, D, TP) * sizeof(float) +
                       (size_t)2 * 2 * TP * D * sizeof(T) +
                       (size_t)rep * (nc + 1) * sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static size_t allowed = 48 * 1024;  // raised as larger calls come
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        split::paged_split_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  split::paged_split_kernel<T, D>
      <<<dim3(nc, G, B), split::THREADS, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<T*>(o),
          static_cast<float*>(ws), static_cast<int*>(counters), H, G, ps, M,
          P, chunk, scale);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths, void* o,
                         void* ws, void* counters, int B, int H, int G, int D,
                         int ps, int M, int P, int chunk, float scale,
                         cudaStream_t s) {
#define PA_SPLIT_D(DD)                                                     \
  case DD:                                                                 \
    return launch_split_d<T, DD>(q, kp, vp, table, lengths, o, ws, counters, \
                                 B, H, G, ps, M, P, chunk, scale, s);
  switch (D) {
    PA_SPLIT_D(1)
    PA_SPLIT_D(2)
    PA_SPLIT_D(4)
    PA_SPLIT_D(8)
    PA_SPLIT_D(16)
    PA_SPLIT_D(32)
    PA_SPLIT_D(64)
    PA_SPLIT_D(128)
    PA_SPLIT_D(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_SPLIT_D
}

}  // namespace

// The fp body. dtype: 0 = float32, 1 = bfloat16; D divides 128, or D =
// 256; H a multiple of G; all tensors contiguous. scale = 1/sqrt(D);
// chunk: positions per block. ws holds B * G * ceil(M * ps / chunk) *
// (H / G) * (D + 2) floats and counters B * G ints, zero at the first call
// (the kernel leaves them at zero).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* table,
                                      const void* lengths, void* o, void* ws,
                                      void* counters, int B, int H, int G,
                                      int D, int ps, int M, int P, int chunk,
                                      float scale, int dtype, void* stream) {
  if (bad_geometry(B, H, G, D, ps, M, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_split<float>(q, kp, vp, table, lengths, o, ws, counters, B, H,
                            G, D, ps, M, P, chunk, scale, s);
  } else if (dtype == 1) {
    e = launch_split<__nv_bfloat16>(q, kp, vp, table, lengths, o, ws,
                                    counters, B, H, G, D, ps, M, P, chunk,
                                    scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
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
    launch<float>(q, kp, vp, ks, vs, table, lengths, o, B, H, G, D, ps, M, P,
                  scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, kp, vp, ks, vs, table, lengths, o, B, H, G, D,
                          ps, M, P, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
