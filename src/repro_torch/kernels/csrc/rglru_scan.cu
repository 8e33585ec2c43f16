// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// a, b [B, S, W] from h0 [B, W] (f32), returning the h sequence [B, S, W]
// in a's dtype (float32 or bfloat16). The carry is f32.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py: rglru_scan /
// _rglru_kernel. The TPU grid walks (B, S / bs) with the sequence axis
// innermost and sequential, carrying h across S-blocks in VMEM scratch;
// it asserts S % bs == 0. Here one thread owns one (b, w) channel and
// walks all of S with its carry in a register, so nothing is carried
// between blocks and S may be any length.
//
// What bounds it on the H100: a and b are read once and h written once,
// 3 * B * S * W elements: 0.150 ms at [8, 2048, 2560] fp32, 0.019 ms at
// n = 1. The walk itself is S dependent multiply-adds a channel (~9 us at
// S = 2048), far under that, so the kernel is bound by how many bytes it
// keeps in flight (Little's law: ~3.4 MB at 3.35 TB/s and ~1 us).
//
// rglru_ring_kernel<T, CW> (the route when W * sizeof(T) % 16 == 0 and a,
// b lie on 16 bytes): one warp a block walks CW = 32, 16 or 8 channels of
// one batch row (the wrapper's plan picks the widest CW that gives two
// blocks an SM: 32 at [n >= 4, *, 2560], 16 at n = 2 and 3, 8 at n = 1;
// a block's time is its warp's walk and copy issue, so at small n more,
// narrower blocks go faster). a and b
// stream through a shared-memory ring of RING_STAGES stages, each TS =
// 512 / CW steps x CW channels of both arrays (4 KB in fp32), filled by
// 16-byte cp.async: seven stages are in flight while the walk reads the
// eighth, ~28 KB a block, so the loads are off the dependent chain. The
// walk reads WALK steps' a and b from the ring into registers, then runs
// them; each step's h goes straight out as a coalesced store (CW
// consecutive channels), which the walk does not wait on.
//
// rglru_rows_kernel<T> (any other width or alignment): one thread per
// channel reading a and b from device memory, UNROLL steps' loads issued
// together.
//
// Each step is a multiply then an add, both rounded (no fused
// multiply-add), as the plain PyTorch version computes it, so the two
// agree bit for bit; no step is reordered or recombined. Identity steps
// (a, b) = (1, 0), which the model writes on a right-padded prompt's
// tail, leave h exactly unchanged.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---- the ring route -------------------------------------------------------

constexpr int RING_STAGES = 8;    // stages of the ring, RING_STAGES - 1 in flight
constexpr int STAGE_ELEMS = 512;  // steps x channels of one array in a stage
constexpr int WALK = 16;          // steps whose operands are read together

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <typename T, int CW>
__global__ void __launch_bounds__(32)
rglru_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ o, int S,
                  int W) {
  constexpr int TS = STAGE_ELEMS / CW;      // steps a stage
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr int CPR = CW / VEC;             // copies a step and array
  constexpr int COPIES = 2 * TS * CPR;      // copies a stage
  static_assert(CPR >= 1 && COPIES % 32 == 0 && TS % WALK == 0,
                "bad channel tile");
  __shared__ __align__(16) T ring[RING_STAGES][2][TS][CW];

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CW;
  const long long row = blockIdx.y;
  const long long base = row * S * W + c0;  // element (row, 0, c0)
  const int n = (S + TS - 1) / TS;           // stages

  // stage k into slot k % RING_STAGES; steps past S and channels past W
  // are zero-filled, not read
  auto issue = [&](int k) {
    const int slot = k % RING_STAGES, t0 = k * TS;
#pragma unroll
    for (int i = lane; i < COPIES; i += 32) {
      const int arr = i / (TS * CPR), rem = i % (TS * CPR);
      const int t = rem / CPR, ch = (rem % CPR) * VEC;
      const bool ok = t0 + t < S && c0 + ch < W;
      const T* src = arr ? b : a;
      cp_async16(&ring[slot][arr][t][ch],
                 ok ? src + base + (long long)(t0 + t) * W + ch : src,
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int k = 0; k < RING_STAGES - 1; ++k) {
    if (k < n) issue(k);
    cp_async_commit();
  }

  const bool walks = lane < CW && c0 + lane < W;
  float h = walks ? h0[row * W + c0 + lane] : 0.f;
  T* out = o + base + lane;
  for (int k = 0; k < n; ++k) {
    cp_async_wait<RING_STAGES - 2>();  // this lane's copies of stage k landed
    __syncwarp();  // every lane's; and every lane is done with stage k - 1
    if (k + RING_STAGES - 1 < n) issue(k + RING_STAGES - 1);  // into k - 1's slot
    cp_async_commit();
    if (!walks) continue;
    const int slot = k % RING_STAGES, t0 = k * TS;
    const T* as = &ring[slot][0][0][lane];
    const T* bs = &ring[slot][1][0][lane];
    T* ot = out + (long long)t0 * W;
    if (t0 + TS <= S) {
      // WALK steps' operands into registers first: the stores below
      // could alias them for all the compiler knows, and a shared load
      // issued after each store would put its latency on the chain
#pragma unroll
      for (int u = 0; u < TS; u += WALK) {
        float av[WALK], bv[WALK];
#pragma unroll
        for (int t = 0; t < WALK; ++t) {
          av[t] = to_f32(as[(u + t) * CW]);
          bv[t] = to_f32(bs[(u + t) * CW]);
        }
#pragma unroll
        for (int t = 0; t < WALK; ++t) {
          h = __fadd_rn(__fmul_rn(av[t], h), bv[t]);
          store(ot + (long long)(u + t) * W, h);
        }
      }
    } else {
      for (int t = 0; t < S - t0; ++t) {
        h = __fadd_rn(__fmul_rn(to_f32(as[t * CW]), h), to_f32(bs[t * CW]));
        store(ot + (long long)t * W, h);
      }
    }
  }
  cp_async_wait<0>();
}

// ---- the rows route (any width) -------------------------------------------

constexpr int THREADS = 128;  // channels per block
constexpr int UNROLL = 8;     // steps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ o, int S,
                  int W) {
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

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* o,
                   int B, int S, int W, int cw, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const float* h = static_cast<const float*>(h0);
  T* ot = static_cast<T*>(o);
  if (cw == 0) {
    const dim3 grid((W + THREADS - 1) / THREADS, B);
    rglru_rows_kernel<T><<<grid, THREADS, 0, stream>>>(at, bt, h, ot, S, W);
    return cudaSuccess;
  }
  if ((W * sizeof(T)) % 16 != 0 || !on16(a) || !on16(b))
    return cudaErrorMisalignedAddress;
  const dim3 grid((W + cw - 1) / cw, B);
  switch (cw) {
    case 32: rglru_ring_kernel<T, 32><<<grid, 32, 0, stream>>>(at, bt, h, ot, S, W); break;
    case 16: rglru_ring_kernel<T, 16><<<grid, 32, 0, stream>>>(at, bt, h, ot, S, W); break;
    case 8: rglru_ring_kernel<T, 8><<<grid, 32, 0, stream>>>(at, bt, h, ot, S, W); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// dtype (of a, b and o): 0 = float32, 1 = bfloat16; h0 is float32; all
// tensors contiguous. cw: the ring route's channels a block (32, 16 or 8;
// W * sizeof(T) and the bases of a and b on 16 bytes), or 0 for the rows
// route. Returns the cudaError_t of the launch (0 = success).
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* o, int B, int S, int W,
                                 int dtype, int cw, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(a, b, h0, o, B, S, W, cw, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(a, b, h0, o, B, S, W, cw, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
