// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// a, b [B, S, W] from h0 [B, W] (f32), returning the h sequence [B, S, W]
// in a's dtype (float32 or bfloat16). The carry is f32.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py: rglru_scan /
// _rglru_kernel. The TPU grid walks (B, S / bs) with the sequence axis
// innermost and sequential, carrying h across S-blocks in VMEM scratch;
// it asserts S % bs == 0. Here one thread owns one (b, w) channel and
// loops over all of S with its carry in a register, so nothing is
// carried between blocks and S may be any length.
//
// What bounds it on the H100: the TPU docstring's "memory-bound
// streaming layer" reads a and b once and writes h once, 3 * B * S * W
// elements. On this card that byte bound is not reached at the serving
// path's shapes ([n <= 8, 2048-2560, 2560]): only B * W <= 20,480
// threads exist, each doing S dependent steps, so the kernel is bound by
// the latency of its loads. The design hides some of it: a warp's 32
// threads read 32 consecutive w of one step (every load and store is
// coalesced), and each thread issues the loads of UNROLL steps before it
// computes them, so UNROLL loads per thread are in flight at once. A
// chunked scan over S (more threads, a second pass for the carries) is
// later work.
//
// Each step is a multiply then an add, both rounded (no fused
// multiply-add), as the plain PyTorch version computes it, so the two
// agree bit for bit. Identity steps (a, b) = (1, 0), which the model
// writes on a right-padded prompt's tail, leave h exactly unchanged.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int UNROLL = 8;     // steps whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ o, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const long long base = row * S * W + w;
  float h = h0[row * W + w];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float at[UNROLL], bt[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(t + u) * W;
      at[u] = to_f32(a[i]);
      bt[u] = to_f32(b[i]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(at[u], h), bt[u]);
      store(o + base + (long long)(t + u) * W, h);
    }
  }
  for (; t < S; ++t) {
    const long long i = base + (long long)t * W;
    h = __fadd_rn(__fmul_rn(to_f32(a[i]), h), to_f32(b[i]));
    store(o + i, h);
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* h0, void* o, int B,
            int S, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(o), S, W);
}

}  // namespace

// dtype (of a, b and o): 0 = float32, 1 = bfloat16; h0 is float32; all
// tensors contiguous. Returns the cudaError_t of the launch (0 = success).
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* o, int B, int S, int W,
                                 int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, h0, o, B, S, W, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, h0, o, B, S, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
