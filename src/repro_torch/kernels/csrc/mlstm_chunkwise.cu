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
// columns): it keeps C[:, v0:v0+TV] (D x TV f32, 128 KiB at TV = 64) and all
// of n in shared memory, walks every chunk of BQ = 16 steps in order, and
// recomputes the chunk's [BQ, BQ] scores and its q.n itself. Only the block
// of v-tile 0 writes n and m. A chunk past S is masked: its steps get
// identity gates and zero q, k, v, so S need not divide by BQ.
//
// What bounds it on the H100: operations. At the serving shape [32, 2048,
// 512] the work is ~4 BH S D^2 flops (q C and the rank-BQ fold) against
// ~268 MB of q/k/v/h. This first version runs them on the CUDA cores in
// f32, one block per SM (204 KB of shared memory), so it is far from that
// bound; tensor cores (wgmma) for q k^T, scores v, q C and the fold are
// later work.
//
// "Never" is -1e30, not -inf, as in the TPU kernel and the reference: the
// initial m and a padded step's it. A row whose m stays -1e30 has
// exp(-m) = +inf in its denominator and an output of 0. Masked scores
// (j > i) are 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 16;  // steps per chunk; THREADS == BQ * BQ score pairs
constexpr float NEG = -1e30f;
constexpr int MAX_D = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <typename T, int TV>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ it,
             const float* __restrict__ lf, const float* __restrict__ C0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             T* __restrict__ o, float* __restrict__ Cout,
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
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;
  T* ob = o + bh * S * D;
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
        qv = to_f32(qb[g]);
        kv = to_f32(kb[g]);
      }
      qs[i * DP + d] = qv;
      ks[i * DP + d] = kv;
    }
    for (int e = tid; e < BQ * TV; e += THREADS) {
      const int i = e / TV;
      vs[e] = i < nv ? to_f32(vb[(long long)(t0 + i) * D + v0 + (e - i * TV)]) : 0.f;
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
          store(ob + (long long)(t0 + i) * D + v0 + c, (sv + sc[i] * acc[r]) / dn[i]);
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

template <typename T, int TV>
int launch(const void* q, const void* k, const void* v, const float* it,
           const float* lf, const float* C0, const float* n0, const float* m0,
           void* o, float* C, float* n, float* m, int BH, int S, int D,
           cudaStream_t stream) {
  const int bytes = smem_floats(D, TV) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_kernel<T, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / TV, BH);
  mlstm_kernel<T, TV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), it, lf, C0, n0, m0, static_cast<T*>(o), C, n,
      m, S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const float* it,
                 const float* lf, const float* C0, const float* n0,
                 const float* m0, void* o, float* C, float* n, float* m,
                 int BH, int S, int D, cudaStream_t stream) {
  if (D % 64 == 0)
    return launch<T, 64>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
  return launch<T, 32>(q, k, v, it, lf, C0, n0, m0, o, C, n, m, BH, S, D, stream);
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
    return launch_dtype<float>(q, k, v, f[0], f[1], f[2], f[3], f[4], o, out[0],
                               out[1], out[2], BH, S, D, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, f[0], f[1], f[2], f[3], f[4], o,
                                       out[0], out[1], out[2], BH, S, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
