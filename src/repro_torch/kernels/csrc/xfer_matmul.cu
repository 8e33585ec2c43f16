// xfer_matmul: out[R, M] = x[R, N] @ w[N, M], fp32 accumulator, cast to
// x's dtype once per output tile.
// quant_matmul: the same with an int8 w and one f32 scale per output
// column, out[R, M] = (x[R, N] @ w_q[N, M]) * scale[M].
//
// xfer_matmul replaces the TPU kernel repro/kernels/xfer_matmul.py:
// xfer_matmul / _matmul_kernel (the paper's <Tr, Tm, Tn>-tiled core);
// quant_matmul replaces repro/kernels/quant_matmul.py: quant_matmul /
// _quant_matmul_kernel (the INT8 serving path's dequant-fused matmul).
// Both are one kernel templated on w's element type. The TPU grid's
// sequential contraction axis, with its VMEM accumulator carried across
// grid steps, becomes a loop over N inside one block that keeps the
// accumulator in registers; blocks run in parallel over output tiles.
// As in the TPU quant_matmul, per-column symmetric scaling commutes with
// the contraction, (x @ q) * s == x @ (q * s), so int8 tiles are only
// widened to fp32 inside the loop and the scale multiplies the
// accumulated tile once at flush.
//
// What bounds it on the H100: on the serving path R is the slot count
// (decode) or a prefill group's token count, far below the ~295 bf16
// operations per byte the card needs to be compute bound, so it is bound
// by reading w from device memory (w is read once per row block): two
// bytes per weight in bf16, one in int8. The design therefore reads each
// w element once per block of BM rows, through shared memory (widened to
// fp32 as it is stored there), coalesced along whichever axis of w is
// contiguous: row-major weights [N, M] (stride_m == 1) and the tied
// unembedding passed as embed.T or embed.q.T (stride_n == 1) are both
// read without a transposed copy. BM = 16 for decode-sized R keeps the
// masked-row waste small. Ragged edges are masked here (the TPU versions
// asserted that the tiles divide the dims; 151,936 is not a multiple of
// 256). At decode there are only M / 64 blocks of columns (16 for a
// 1024-wide output on 132 SMs), so neither reaches that bound.
//
// Simple first: fp32 FMA on CUDA cores, scalar loads. Tensor cores
// (mma.sync / wgmma, int8 widened to bf16), TMA pipelines and split-K
// for decode are later work.
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

// T: x and out; W: w (T, or int8_t with one f32 scale per column)
template <typename T, typename W, int BM>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out, int R,
              int N, int M, long long swn, long long swm) {
  constexpr bool Q8 = std::is_same<W, int8_t>::value;
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

template <typename T, typename W>
void launch(const void* x, const void* w, const float* scale, void* out,
            int R, int N, int M, long long swn, long long swm, int bm,
            cudaStream_t stream) {
  const dim3 grid((M + BN - 1) / BN, (R + bm - 1) / bm);
  if (bm == 16) {
    matmul_kernel<T, W, 16><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scale,
        static_cast<T*>(out), R, N, M, swn, swm);
  } else {
    matmul_kernel<T, W, 64><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), scale,
        static_cast<T*>(out), R, N, M, swn, swm);
  }
}

// W = T for xfer_matmul (scale unused), int8_t for quant_matmul
template <bool Q8>
int dispatch(const void* x, const void* w, const void* scale, void* out,
             int R, int N, int M, long long swn, long long swm, int dtype,
             int bm, void* stream) {
  if ((bm != 16 && bm != 64) || R <= 0 || M <= 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    launch<float, typename std::conditional<Q8, int8_t, float>::type>(
        x, w, sc, out, R, N, M, swn, swm, bm, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16,
           typename std::conditional<Q8, int8_t, __nv_bfloat16>::type>(
        x, w, sc, out, R, N, M, swn, swm, bm, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16. bm: 16 or 64 rows per
// block. w[n, m] lives at w + n * swn + m * swm (element strides); for
// quant_matmul w is int8 and scale holds M contiguous floats.
// Each returns the cudaError_t of its launch (0 = success).
extern "C" int xfer_matmul_launch(const void* x, const void* w, void* out,
                                  int R, int N, int M, long long swn,
                                  long long swm, int dtype, int bm,
                                  void* stream) {
  return dispatch<false>(x, w, nullptr, out, R, N, M, swn, swm, dtype, bm,
                         stream);
}

extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* scale, void* out, int R,
                                   int N, int M, long long swn,
                                   long long swm, int dtype, int bm,
                                   void* stream) {
  return dispatch<true>(x, w, scale, out, R, N, M, swn, swm, dtype, bm,
                        stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
