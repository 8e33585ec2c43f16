// mlstm_chunkwise: the chunkwise mLSTM (xLSTM matrix memory) over q, k, v
// [BH, S, D] (float32 or bfloat16; k pre-scaled by 1/sqrt(D)) with f32
// input gates `it` and log-forget gates `lf` [BH, S], from an f32 state
// (C0 [BH, D, D], n0 [BH, D], m0 [BH]). Writes the output h [BH, S, D] in
// q's dtype and the final state (C, n, m) in f32.
//
// Replaces the TPU kernel repro/kernels/mlstm_kernel.py: mlstm_chunkwise /
// _mlstm_kernel. The TPU grid walks (BH, S / bq) with the chunk axis
// sequential, holding (C, n, m) in VMEM scratch from zeros and dropping it
// at the end. Per chunk of bq steps, with F the cumulative log-forget:
//   D_ij = F_i - F_j + it_j (j <= i),  m_i = max(max_j D_ij, F_i + m, -1e30)
//   h_i  = ((q k^T * exp(D - m_i)) v + exp(F_i + m - m_i) q C)
//          / max(|rowsum + exp(F_i + m - m_i) q.n|, exp(-m_i))
// then folds the chunk into (C, n, m). Three things the model path needs
// and the TPU kernel lacks are part of this one: the gate is the log-forget
// (a padded step is (lf, it) = (0, -1e30), which a pre-activation can only
// say as +inf), the state starts from (C0, n0, m0), and the final state is
// written out.
//
// Design. At D = 512 one head's C is 1 MiB of f32, far above the 227 KB a
// block may hold, but the v-columns of C and of h are independent: only the
// denominator needs all of n. So a block owns one (bh, v-tile of TV
// columns) and walks every chunk of BQ = 16 steps in order, recomputing the
// chunk's [BQ, BQ] scores and its q.n itself; every block keeps all of n,
// and only the block of v-tile 0 writes n and m. A chunk past S is masked:
// its steps get identity gates and zero q, k, v, so S need not divide by BQ.
//
// What bounds it on the H100: bytes, barely. At the serving shape [32,
// 2048, 512] the work is ~4 BH S D^2 = 68.7 GFLOP (q C and the rank-BQ
// fold: 0.069 ms on the bf16 tensor cores) against ~302 MB of q/k/v/h and
// state (0.090 ms). The chunks of one (bh, v-tile) are a serial chain, so
// what a block can overlap is one chunk's loads with the previous chunk's
// products; the floor above the bound is 128 serial chunks times one
// chunk's latency, on two waves of 256 blocks.
//
// bf16 q, k, v (mlstm_tc_kernel, the serving path): tensor cores, the
// state in registers. The block's slice of C is held transposed, C^T [TV,
// D], as fp32 mma.sync m16n8k16 accumulators, split across the 8 warps by
// rows of C: a warp owns KS k-steps of 16 (64 rows at D = 512, 4 m-tiles x
// 8 n-tiles, 128 registers a thread). Per chunk each warp computes, over
// its slice of D only: the scores q k^T [16, 16] (q, k bf16 from shared
// memory by ldmatrix); h^T = C^T q^T [TV, 16], the A operand taken
// straight from the accumulators (two neighbouring m16n8 tiles are one
// m16k16 A fragment, FA2's trick for P); and q.n on the CUDA cores (n in
// shared memory, the warp's slice). One reduction across warps through
// shared memory (partials summed in warp order) gives the scores, h^T and
// q.n; the decayed scores times v stay on the CUDA cores (16 x 16 x TV
// FMAs, a small share of the chunk). Then the fold C^T <- carry C^T +
// v^T (w * k) accumulates into the same registers: one k-step of depth 16
// (the chunk's steps), v^T by ldmatrix.trans. C and w * k are f32: they
// enter the tensor cores as three bf16 terms (hi, mid, lo, as
// ref.split_terms), exact for normal values, so only the order of
// summation departs from f32; ref.mlstm_chunkwise_ref(split=True) is the
// plain mirror of that arithmetic. The gate scalars (cumulative
// log-forget, row maxima, fold weights and carry) come from warp shuffles,
// every warp computing them alike. The next chunk's q, k, v and gates are
// staged with cp.async (16 bytes; 4 for the gates, whose rows need not be
// aligned), double-buffered, while this chunk computes. Three block
// barriers a chunk: data landed, partials written, denominators ready.
// BQ stays 16: it is the fold's k-step and the scores' tile, and a larger
// chunk would grow the h^T partials (registers, shared memory) and the
// scores' causal waste quadratically while halving only the serial steps.
// What bounds this form: the 192 mma.sync a warp runs per chunk (96 for
// h^T, 96 for the fold) and the splitting of C into terms, on one block of
// 8 warps an SM (234-250 registers a thread); neither a third stage that
// let the output phase overlap the next chunk's products nor two blocks
// an SM at TV = 32 was faster in development timing.
//
// fp32 q, k, v (mlstm_kernel): the CUDA cores in f32, C[:, v0:v0+TV]
// (D x TV f32, 128 KiB at TV = 64) and all of n in shared memory, one
// block per SM (204 KB). No TF32: this form keeps the reference's f32
// products, and it is what the fp32 card-vs-CPU checks run.
//
// "Never" is -1e30, not -inf, as in the TPU kernel and the reference: the
// initial m and a padded step's it. A row whose m stays -1e30 has
// exp(-m) = +inf in its denominator and an output of 0. Masked scores
// (j > i) are 0. No atomics: two calls give bit-equal results.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 16;  // steps per chunk; THREADS == BQ * BQ score pairs
constexpr float NEG = -1e30f;
constexpr int MAX_D = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory in floats: C tile, n, q and k chunks (rows padded to D + 1
// against bank conflicts), v tile, scores, 7 per-step vectors, 4 scalars
__host__ __device__ constexpr int smem_floats(int D, int TV) {
  return D * TV + D + 2 * BQ * (D + 1) + BQ * TV + BQ * BQ + 7 * BQ + 4;
}

// fp32 q, k, v (the bf16 ones run tc::mlstm_tc_kernel below)
template <int TV>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ it,
             const float* __restrict__ lf, const float* __restrict__ C0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ o, float* __restrict__ Cout,
             float* __restrict__ nout, float* __restrict__ mout, int S, int D) {
  constexpr int RSTEP = THREADS / TV;  // rows apart of a thread's outputs
  constexpr int ROWS = BQ / RSTEP;     // outputs per thread per chunk
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* Cs = sm;              // [D][TV]
  float* ns = Cs + D * TV;     // [D]
  float* qs = ns + D;          // [BQ][DP]
  float* ks = qs + BQ * DP;    // [BQ][DP]
  float* vs = ks + BQ * DP;    // [BQ][TV]
  float* Ss = vs + BQ * TV;    // [BQ][BQ] decayed scores
  float* Fs = Ss + BQ * BQ;    // cumulative log-forget
  float* ms = Fs + BQ;         // row stabiliser m_i
  float* sc = ms + BQ;         // exp(F_i + m - m_i), the carried state's weight
  float* dn = sc + BQ;         // q.n, then the denominator
  float* ws = dn + BQ;         // w_log, then the fold weights
  float* its = ws + BQ;
  float* lfs = its + BQ;
  float* scal = lfs + BQ;      // [0] m carried, [1] carry, [2] m after the fold

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * TV;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  float* ob = o + bh * S * D;
  const float* itb = it + bh * S;
  const float* lfb = lf + bh * S;
  const int c = tid % TV, r0 = tid / TV;  // this thread's column and first row

  for (int e = tid; e < D * TV; e += THREADS) {
    const int kk = e / TV;
    Cs[e] = C0[(bh * D + kk) * D + v0 + (e - kk * TV)];
  }
  for (int e = tid; e < D; e += THREADS) ns[e] = n0[bh * D + e];
  if (tid == 0) scal[0] = m0[bh];
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += BQ) {
    const int nv = min(BQ, S - t0);  // steps of this chunk inside S
    for (int e = tid; e < BQ * D; e += THREADS) {
      const int i = e / D, d = e - i * D;
      float qv = 0.f, kv = 0.f;
      if (i < nv) {
        const long long g = (long long)(t0 + i) * D + d;
        qv = qb[g];
        kv = kb[g];
      }
      qs[i * DP + d] = qv;
      ks[i * DP + d] = kv;
    }
    for (int e = tid; e < BQ * TV; e += THREADS) {
      const int i = e / TV;
      vs[e] = i < nv ? vb[(long long)(t0 + i) * D + v0 + (e - i * TV)] : 0.f;
    }
    if (tid < BQ) {
      its[tid] = tid < nv ? itb[t0 + tid] : NEG;
      lfs[tid] = tid < nv ? lfb[t0 + tid] : 0.f;
    }
    __syncthreads();

    // gate scalars of the chunk: warp 0, lane i for step i
    if (warp == 0) {
      const float mc = scal[0];
      if (lane < BQ) {
        float F = 0.f;
        for (int j = 0; j <= lane; ++j) F += lfs[j];
        Fs[lane] = F;
      }
      __syncwarp();
      if (lane < BQ) {
        const float F = Fs[lane];
        float mx = (F - Fs[0]) + its[0];
        for (int j = 1; j <= lane; ++j) mx = fmaxf(mx, (F - Fs[j]) + its[j]);
        const float w_state = F + mc;
        const float mi = fmaxf(fmaxf(mx, w_state), NEG);
        ms[lane] = mi;
        sc[lane] = expf(w_state - mi);
        ws[lane] = (Fs[BQ - 1] - F) + its[lane];  // w_log
      }
      __syncwarp();
      if (lane == 0) {
        const float fe = Fs[BQ - 1] + mc;
        float mn = ws[0];
        for (int j = 1; j < BQ; ++j) mn = fmaxf(mn, ws[j]);
        mn = fmaxf(mn, fe);
        scal[2] = mn;
        scal[1] = expf(fe - mn);
      }
      __syncwarp();
      if (lane < BQ) ws[lane] = expf(ws[lane] - scal[2]);
    }
    __syncthreads();

    // decayed scores, one (i, j) pair per thread; q.n, one warp per row
    {
      const int i = tid / BQ, j = tid % BQ;
      float s = 0.f;
      if (j <= i) {
        const float* qi = qs + i * DP;
        const float* kj = ks + j * DP;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
        s = acc * expf(((Fs[i] - Fs[j]) + its[j]) - ms[i]);
      }
      Ss[tid] = s;
    }
    for (int i = warp; i < BQ; i += THREADS / 32) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = fmaf(qs[i * DP + d], ns[d], acc);
      acc = warp_sum(acc);
      if (lane == 0) dn[i] = acc;
    }
    __syncthreads();
    if (tid < BQ) {
      float rs = 0.f;
      for (int j = 0; j < BQ; ++j) rs += Ss[tid * BQ + j];
      dn[tid] = fmaxf(fabsf(rs + sc[tid] * dn[tid]), expf(-ms[tid]));
    }
    __syncthreads();

    // h = (scores v + sc * q C) / den over this block's columns
    {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        const float cv = Cs[kk * TV + c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = fmaf(qs[(r0 + r * RSTEP) * DP + kk], cv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = r0 + r * RSTEP;
        float sv = 0.f;
        for (int j = 0; j <= i; ++j) sv = fmaf(Ss[i * BQ + j], vs[j * TV + c], sv);
        if (i < nv)
          ob[(long long)(t0 + i) * D + v0 + c] = (sv + sc[i] * acc[r]) / dn[i];
      }
    }
    __syncthreads();  // every read of this chunk's C and n is done

    // fold the chunk: C = carry C + (k * w)^T v, n = carry n + sum_j k_j w_j
    {
      const float carry = scal[1];
      float vr[BQ], wr[BQ];
#pragma unroll
      for (int j = 0; j < BQ; ++j) {
        vr[j] = vs[j * TV + c];
        wr[j] = ws[j];
      }
      for (int kk = r0; kk < D; kk += RSTEP) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < BQ; ++j) a = fmaf(ks[j * DP + kk] * wr[j], vr[j], a);
        Cs[kk * TV + c] = carry * Cs[kk * TV + c] + a;
      }
      for (int kk = tid; kk < D; kk += THREADS) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < BQ; ++j) a += ks[j * DP + kk] * wr[j];
        ns[kk] = carry * ns[kk] + a;
      }
    }
    __syncthreads();
    if (tid == 0) scal[0] = scal[2];
    // the next chunk's loads touch none of scal; its gate phase reads
    // scal[0] only after the __syncthreads that follows them
  }

  for (int e = tid; e < D * TV; e += THREADS) {
    const int kk = e / TV;
    Cout[(bh * D + kk) * D + v0 + (e - kk * TV)] = Cs[e];
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < D; e += THREADS) nout[bh * D + e] = ns[e];
    if (tid == 0) mout[bh] = scal[0];
  }
}

template <int TV>
int launch(const void* q, const void* k, const void* v, const float* it,
           const float* lf, const float* C0, const float* n0, const float* m0,
           void* o, float* C, float* n, float* m, int BH, int S, int D,
           cudaStream_t stream) {
  const int bytes = smem_floats(D, TV) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / TV, BH);
  mlstm_kernel<TV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), it, lf, C0, n0, m0, static_cast<float*>(o),
      C, n, m, S, D);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor-core chunk products, the state in registers -----------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// CB bytes global -> shared; only src_bytes are read, the rest is zeroed
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(CB), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// the two bf16 of a packed pair as floats (low half first)
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
// (x, y) f32 as three packed bf16 pairs hi + mid + lo, their sum (x, y)
// exactly for normal values (ref.split_terms)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// shared memory, in bytes: two stages of (q, k [BQ][D + 8] bf16, v
// [BQ][TV + 8] bf16, lf, it [BQ] f32), the warps' h^T partials [WARPS][BQ]
// [TV + 4] f32, their score partials [WARPS][BQ][BQ] and q.n partials
// [WARPS][BQ], the decayed scores [BQ][BQ], den and sc [BQ], n [D]. The
// row paddings put the 8 rows of an ldmatrix, and the lanes of the h^T
// stores, on distinct banks.
__host__ __device__ constexpr int stage_bytes(int D, int TV) {
  return 2 * BQ * (D + 8) * 2 + BQ * (TV + 8) * 2 + 2 * BQ * 4;
}
__host__ __device__ constexpr int smem_bytes(int D, int TV) {
  return 2 * stage_bytes(D, TV) +
         4 * (WARPS * BQ * (TV + 4) + WARPS * BQ * BQ + WARPS * BQ + BQ * BQ +
              2 * BQ + D);
}

// Block (v-tile blockIdx.x of TV = 16 MT columns, head blockIdx.y); warp w
// owns the k-steps [w KS, w KS + KS) of D / 16 (fewer, or none, at the
// end; EVEN: D = 128 KS, every warp owns KS, and no guard is compiled).
// D is a multiple of 32 (of 64 where MT = 4), at most 128 KS.
template <int KS, int MT, bool EVEN>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ it,
                const float* __restrict__ lf, const float* __restrict__ C0,
                const float* __restrict__ n0, const float* __restrict__ m0,
                bf16* __restrict__ o, float* __restrict__ Cout,
                float* __restrict__ nout, float* __restrict__ mout, int S,
                int D) {
  constexpr int TV = 16 * MT;
  constexpr int NT = 2 * KS;         // n-tiles (8 rows of C) of a warp
  constexpr int VP = TV + 8;         // bf16 per staged v row
  constexpr int HP = TV + 4;         // floats per h^T partial row
  constexpr int RSTEP = THREADS / TV, ROWS = BQ / RSTEP;  // output phase
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = D + 8;  // bf16 per staged q / k row
  const int SB = stage_bytes(D, TV);
  float* hpart = reinterpret_cast<float*>(smem + 2 * SB);  // [WARPS][BQ][HP]
  float* spart = hpart + WARPS * BQ * HP;                  // [WARPS][BQ][BQ]
  float* qnp = spart + WARPS * BQ * BQ;                    // [WARPS][BQ]
  float* sd = qnp + WARPS * BQ;                            // [BQ][BQ]
  float* den = sd + BQ * BQ;
  float* scs = den + BQ;
  float* ns = scs + BQ;                                    // [D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // fragment row, column pair
  const int v0 = blockIdx.x * TV;
  const long long bh = blockIdx.y;
  const bf16* qb = q + bh * S * D;
  const bf16* kb = k + bh * S * D;
  const bf16* vb = v + bh * S * D;
  bf16* ob = o + bh * S * D;
  const float* itb = it + bh * S;
  const float* lfb = lf + bh * S;
  const int ksteps = D / 16;
  const int kw0 = warp * KS;                           // first k-step
  const int kn = EVEN ? KS : max(0, min(KS, ksteps - kw0));  // k-steps owned
  const int nwa = EVEN ? WARPS : (ksteps + KS - 1) / KS;     // warps owning any
  // ldmatrix.x4 row addresses: matrices (rows 0-7, cols 0-7), (8-15,
  // 0-7), (0-7, 8-15), (8-15, 8-15)
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;

  // C^T [TV, 16 KS rows of C]: accumulator (mt, nt) holds C^T rows
  // 16 mt + g (+ 8), columns 16 kw0 + 8 nt + c2 (+ 1)
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int kk = kw0 * 16 + nt * 8 + c2, vv = v0 + mt * 16 + g;
      const bool mine = nt / 2 < kn;
      const float* c = C0 + (bh * D + kk) * D + vv;
      acc[mt][nt][0] = mine ? c[0] : 0.f;
      acc[mt][nt][1] = mine ? c[D] : 0.f;
      acc[mt][nt][2] = mine ? c[8] : 0.f;
      acc[mt][nt][3] = mine ? c[D + 8] : 0.f;
    }
  for (int e = tid; e < D; e += THREADS) ns[e] = n0[bh * D + e];
  float m_c = m0[bh];  // the carried stabiliser, alike in every thread

  // chunk t0 (nv steps inside S) into stage st, zero-filled past S
  auto load_chunk = [&](int st, int t0) {
    unsigned char* base = smem + st * SB;
    bf16* qs = reinterpret_cast<bf16*>(base);
    bf16* ks = qs + BQ * DP;
    bf16* vs = ks + BQ * DP;
    float* lfs = reinterpret_cast<float*>(vs + BQ * VP);
    float* its = lfs + BQ;
    const int nv = min(BQ, S - t0);
    const int cpr = D / 8;  // 16-byte vectors per q / k row
    for (int e = tid; e < 2 * BQ * cpr; e += THREADS) {
      const int which = e / (BQ * cpr), r = e / cpr % BQ, c = e % cpr;
      const long long src = (long long)(t0 + min(r, nv - 1)) * D + c * 8;
      cp_async<16>((which ? ks : qs) + r * DP + c * 8,
                   (which ? kb : qb) + src, r < nv ? 16 : 0);
    }
    for (int e = tid; e < BQ * (TV / 8); e += THREADS) {
      const int r = e / (TV / 8), c = e % (TV / 8);
      cp_async<16>(vs + r * VP + c * 8,
                   vb + (long long)(t0 + min(r, nv - 1)) * D + v0 + c * 8,
                   r < nv ? 16 : 0);
    }
    if (tid < 2 * BQ) {
      const int j = tid % BQ;
      cp_async<4>((tid < BQ ? lfs : its) + j,
                  (tid < BQ ? lfb : itb) + t0 + min(j, nv - 1),
                  j < nv ? 4 : 0);
    }
  };

  load_chunk(0, 0);
  cp_async_commit();
  for (int t0 = 0, st = 0; t0 < S; t0 += BQ, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this chunk landed; the last one's reads are done
    if (t0 + BQ < S) load_chunk(st ^ 1, t0 + BQ);
    cp_async_commit();
    const bf16* qs = reinterpret_cast<const bf16*>(smem + st * SB);
    const bf16* ks = qs + BQ * DP;
    const bf16* vs = ks + BQ * DP;
    const float* lfs = reinterpret_cast<const float*>(vs + BQ * VP);
    const float* its = lfs + BQ;
    const int nv = min(BQ, S - t0);

    // gate scalars, every warp alike: lane holds step j = lane % 16
    const int j = lane & 15;
    const float itj = j < nv ? its[j] : NEG;  // a padded step: identity
    float F = lfs[j];                         // (zero-filled: log f = 0)
#pragma unroll
    for (int off = 1; off < BQ; off <<= 1) {
      const float up = __shfl_up_sync(FULL, F, off, BQ);
      if (j >= off) F += up;
    }
    const float Fe = __shfl_sync(FULL, F, BQ - 1);
    const float wlog = (Fe - F) + itj;
    float mx = wlog;
#pragma unroll
    for (int off = BQ / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(mx, Fe + m_c);
    const float wj = expf(wlog - m_new);
    const float carry = expf((Fe + m_c) - m_new);
    // fold weights of this lane's fragment rows c2, c2 + 1, c2 + 8, c2 + 9
    const float w0 = __shfl_sync(FULL, wj, c2), w1 = __shfl_sync(FULL, wj, c2 + 1);
    const float w8 = __shfl_sync(FULL, wj, c2 + 8), w9 = __shfl_sync(FULL, wj, c2 + 9);

    // q fragments of this warp's k-steps, and the partial scores q k^T
    uint32_t qa[KS][4];
    {
      float sacc[2][4] = {};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < kn) {
          const int d0 = (kw0 + s) * 16 + lc;
          uint32_t kf[4];
          ldsm_x4(qa[s], qs + lr * DP + d0);
          ldsm_x4(kf, ks + lr * DP + d0);
          mma_bf16(sacc[0], qa[s], kf[0], kf[2]);
          mma_bf16(sacc[1], qa[s], kf[1], kf[3]);
        }
      }
      if (kn > 0) {
        float* sp = spart + warp * BQ * BQ;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          *reinterpret_cast<float2*>(sp + g * BQ + nt * 8 + c2) =
              make_float2(sacc[nt][0], sacc[nt][1]);
          *reinterpret_cast<float2*>(sp + (g + 8) * BQ + nt * 8 + c2) =
              make_float2(sacc[nt][2], sacc[nt][3]);
        }
      }
    }

    // partial h^T = C^T q^T [TV, BQ]: A from the accumulators as three
    // bf16 terms, B = q^T from the q fragments; the 2 MT accumulator
    // chains interleaved
    {
      float h[MT][2][4] = {};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < kn) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[3][4];
            split3(acc[mt][2 * s][0], acc[mt][2 * s][1], a[0][0], a[1][0], a[2][0]);
            split3(acc[mt][2 * s][2], acc[mt][2 * s][3], a[0][1], a[1][1], a[2][1]);
            split3(acc[mt][2 * s + 1][0], acc[mt][2 * s + 1][1], a[0][2], a[1][2],
                   a[2][2]);
            split3(acc[mt][2 * s + 1][2], acc[mt][2 * s + 1][3], a[0][3], a[1][3],
                   a[2][3]);
#pragma unroll
            for (int term = 0; term < 3; ++term) {
              mma_bf16(h[mt][0], a[term], qa[s][0], qa[s][2]);
              mma_bf16(h[mt][1], a[term], qa[s][1], qa[s][3]);
            }
          }
        }
      }
      if (kn > 0) {  // hpart[warp][i][v]: element (v, i) of the tile
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* hp = hpart + warp * BQ * HP + mt * 16 + g;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int i = nt * 8 + c2;
            hp[i * HP] = h[mt][nt][0];
            hp[(i + 1) * HP] = h[mt][nt][1];
            hp[i * HP + 8] = h[mt][nt][2];
            hp[(i + 1) * HP + 8] = h[mt][nt][3];
          }
        }
      }
    }

    // partial q.n over this warp's rows of n (CUDA cores), then its fold
    {
      const int i = lane >> 1, half = lane & 1;
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s >= kn) break;
        const int d0 = (kw0 + s) * 16 + half * 8;
        const uint4 u = *reinterpret_cast<const uint4*>(qs + i * DP + d0);
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 qf = unpack2(w4[e]);
          a = fmaf(qf.x, ns[d0 + 2 * e], a);
          a = fmaf(qf.y, ns[d0 + 2 * e + 1], a);
        }
      }
      a += __shfl_xor_sync(FULL, a, 1);
      if (kn > 0 && half == 0) qnp[warp * BQ + i] = a;
      __syncwarp();  // the warp's reads of n are done
      float wall[BQ];
#pragma unroll
      for (int jj = 0; jj < BQ; ++jj) wall[jj] = __shfl_sync(FULL, wj, jj);
#pragma unroll
      for (int dd = 0; dd < KS * 16; dd += 32) {
        const int d = kw0 * 16 + dd + lane;
        if (dd + lane < kn * 16) {
          float f = 0.f;
#pragma unroll
          for (int jj = 0; jj < BQ; ++jj)
            f = fmaf(__bfloat162float(ks[jj * DP + d]), wall[jj], f);
          ns[d] = carry * ns[d] + f;
        }
      }
    }

    // the fold: C^T <- carry C^T + v^T (w k), one k-step over the chunk's
    // steps; A = v^T (ldmatrix.trans of v [j][v]), B = w k as three terms
    {
      uint32_t va[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(va[mt], vs + ((lane & 7) + (lane >> 4) * 8) * VP + mt * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < kn) {
          uint32_t kf[4];  // k [j][d] transposed: B fragments of 2 n-tiles
          ldsm_x4_t(kf, ks + lr * DP + (kw0 + s) * 16 + lc);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int nt = 2 * s + h2;
            const float2 k01 = unpack2(kf[2 * h2]), k89 = unpack2(kf[2 * h2 + 1]);
            uint32_t b[3][2];
            split3(k01.x * w0, k01.y * w1, b[0][0], b[1][0], b[2][0]);
            split3(k89.x * w8, k89.y * w9, b[0][1], b[1][1], b[2][1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= carry;
#pragma unroll
              for (int term = 0; term < 3; ++term)
                mma_bf16(acc[mt][nt], va[mt], b[term][0], b[term][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the partials are written

    // scores summed over the warps, decayed; row maxima m_i, the state's
    // weight sc_i and the denominators. Thread (i, j): warp w has rows
    // 2w and 2w + 1, lane % 16 = j, whose F and it this lane holds
    {
      const int i = tid >> 4;
      const float Fi = __shfl_sync(FULL, F, i & 15);
      const bool causal = j <= i;
      const float bias = (Fi - F) + itj;
      float mrow = causal ? bias : NEG;
#pragma unroll
      for (int off = BQ / 2; off > 0; off >>= 1)
        mrow = fmaxf(mrow, __shfl_xor_sync(FULL, mrow, off));
      const float wst = Fi + m_c;
      const float mi = fmaxf(fmaxf(mrow, wst), NEG);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (w < nwa) s += spart[(w * BQ + i) * BQ + j];
      s *= causal ? expf(bias - mi) : 0.f;
      sd[i * BQ + j] = s;
      float rs = s;
#pragma unroll
      for (int off = BQ / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(FULL, rs, off);
      if (j == 0) {
        float qn = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          if (w < nwa) qn += qnp[w * BQ + i];
        const float sci = expf(wst - mi);
        den[i] = fmaxf(fabsf(rs + sci * qn), expf(-mi));
        scs[i] = sci;
      }
    }
    __syncthreads();  // sd, den and sc are ready

    // h = (decayed scores v + sc q C) / den over this block's columns;
    // sd is 0 past the diagonal, so every row sums all BQ steps in order
    {
      const int vv = tid % TV;
      float vf[BQ];
#pragma unroll
      for (int jj = 0; jj < BQ; ++jj) vf[jj] = __bfloat162float(vs[jj * VP + vv]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = tid / TV + r * RSTEP;
        float hq = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          if (w < nwa) hq += hpart[(w * BQ + i) * HP + vv];
        float sv = 0.f;
#pragma unroll
        for (int jj = 0; jj < BQ; jj += 4) {
          const float4 s4 = *reinterpret_cast<const float4*>(sd + i * BQ + jj);
          sv = fmaf(s4.x, vf[jj], sv);
          sv = fmaf(s4.y, vf[jj + 1], sv);
          sv = fmaf(s4.z, vf[jj + 2], sv);
          sv = fmaf(s4.w, vf[jj + 3], sv);
        }
        if (i < nv)
          ob[(long long)(t0 + i) * D + v0 + vv] =
              __float2bfloat16((sv + scs[i] * hq) / den[i]);
      }
    }
    m_c = m_new;
  }

  // the final state: this block's columns of C, and n and m from v-tile 0
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt / 2 < kn) {
        const int kk = kw0 * 16 + nt * 8 + c2, vv = v0 + mt * 16 + g;
        float* c = Cout + (bh * D + kk) * D + vv;
        c[0] = acc[mt][nt][0];
        c[D] = acc[mt][nt][1];
        c[8] = acc[mt][nt][2];
        c[D + 8] = acc[mt][nt][3];
      }
    }
  __syncthreads();  // every warp's fold of n is done
  if (blockIdx.x == 0) {
    for (int e = tid; e < D; e += THREADS) nout[bh * D + e] = ns[e];
    if (tid == 0) mout[bh] = m_c;
  }
}

template <int KS, int MT, bool EVEN>
int launch(const void* q, const void* k, const void* v, const float* it,
           const float* lf, const float* C0, const float* n0, const float* m0,
           void* o, float* C, float* n, float* m, int BH, int S, int D,
           cudaStream_t stream) {
  const int bytes = smem_bytes(D, 16 * MT);
  static int allowed = 48 * 1024;  // raised as larger calls come
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_tc_kernel<KS, MT, EVEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const dim3 grid(D / (16 * MT), BH);
  mlstm_tc_kernel<KS, MT, EVEN><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), it, lf, C0, n0, m0, static_cast<bf16*>(o),
      C, n, m, S, D);
  return (int)cudaGetLastError();
}

// KS = ceil(D / 128) k-steps a warp; v-tiles of 64 columns where D allows
template <int MT, bool EVEN>
int launch_ks(const void* q, const void* k, const void* v, const float* it,
              const float* lf, const float* C0, const float* n0,
              const float* m0, void* o, float* C, float* n, float* m, int BH,
              int S, int D, cudaStream_t stream) {
#define MLSTM_KS(N)                                                        \
  case N:                                                                  \
    return launch<N, MT, EVEN>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH,    \
                               S, D, stream);
  switch ((D + 127) / 128) {
    MLSTM_KS(1)
    MLSTM_KS(2)
    MLSTM_KS(3)
    MLSTM_KS(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MLSTM_KS
}

}  // namespace tc

int launch_fp32(const void* q, const void* k, const void* v, const float* it,
                const float* lf, const float* C0, const float* n0,
                const float* m0, void* o, float* C, float* n, float* m, int BH,
                int S, int D, cudaStream_t stream) {
  if (D % 64 == 0)
    return launch<64>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
  return launch<32>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const float* it,
                const float* lf, const float* C0, const float* n0,
                const float* m0, void* o, float* C, float* n, float* m, int BH,
                int S, int D, cudaStream_t stream) {
  if (D % 128 == 0)  // every warp owns D / 128 k-steps
    return tc::launch_ks<4, true>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
  if (D % 64 == 0)
    return tc::launch_ks<4, false>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
  return tc::launch_ks<2, false>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
}

}  // namespace

// dtype (of q, k, v and o): 0 = float32, 1 = bfloat16; it, lf, C0, n0, m0,
// C, n, m are float32; all tensors contiguous. D must be a multiple of 32
// and at most 512. Returns the cudaError_t of the launch (0 = success).
extern "C" int mlstm_chunkwise_launch(const void* q, const void* k,
                                      const void* v, const void* it,
                                      const void* lf, const void* C0,
                                      const void* n0, const void* m0, void* o,
                                      void* C, void* n, void* m, int BH, int S,
                                      int D, int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || D <= 0 || D % 32 != 0 || D > MAX_D || BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(it), static_cast<const float*>(lf),
                       static_cast<const float*>(C0), static_cast<const float*>(n0),
                       static_cast<const float*>(m0)};
  float* out[3] = {static_cast<float*>(C), static_cast<float*>(n), static_cast<float*>(m)};
  if (dtype == 0)
    return launch_fp32(q, k, v, f[0], f[1], f[2], f[3], f[4], o, out[0],
                       out[1], out[2], BH, S, D, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, f[0], f[1], f[2], f[3], f[4], o, out[0],
                       out[1], out[2], BH, S, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
