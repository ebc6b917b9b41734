// RG-LRU linear recurrence for Hopper (sm_90a). Per channel (b, d):
//
//   h_t = a_t * h_{t-1} + x_t,        h_{-1} = 0
//
// a, x, h: (B, T, D) float32, contiguous.
//
// Replaces the Pallas TPU kernel `lru_scan` (src/repro/kernels/lru_scan.py:44,
// pallas_call at :50, body _lru_kernel :27). The TPU kernel walks a
// sequential grid of time chunks and carries the (B, D) state in VMEM
// scratch, zeroed at the first chunk. Blocks on the card run in no order,
// so the time axis is a loop inside one thread instead: each thread owns
// one (b, d) channel, starts at h = 0 and keeps h in a register for all T
// steps. Nothing carries over between blocks.
//
// Design (simple first; a scan over t):
//   * one CTA of kThreads channels along D for each (D tile, b); loads and
//     stores of a step are coalesced along D, masked at a ragged D edge;
//   * the steps are read kSteps at a time into one of two register
//     buffers, and the loads of the next kSteps steps are issued before
//     the FMAs of the current ones, so a step does not wait a full HBM
//     latency; a ragged last chunk (T not a multiple of kSteps) loads and
//     runs only its T mod kSteps steps;
//   * a and x are read once and h written once with streaming cache hints
//     (ld.global.cs / st.global.cs): nothing is reused;
//   * offsets are 64-bit (B T D passes 2^31 at the reference's prefill_32k
//     shape, B 32, T 32768, D 4096).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The function must read a and x
// and write h once: 12 B T D bytes, 805 MB at the recurrentgemma-9b
// prefill shape (B 4, T 4096, D 4096), 0.240 ms; its 2 B T D flops are
// negligible. This version is latency-bound instead: B D / kThreads = 128
// CTAs of 4 warps at that shape, about one CTA an SM, so each SM has only
// its 4 warps' register buffers (32 KB) of loads in flight. Splitting T
// into chunks scanned in parallel (a two-pass chunked scan) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per CTA, along D
constexpr int kSteps = 32;     // steps per register buffer

// Load steps [0, n) of a channel starting at `off` (n <= 0: none).
__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           long long off, long long stride,
                                           int n, float (&ra)[kSteps],
                                           float (&rx)[kSteps]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i < n) {
      ra[i] = __ldcs(a + off + i * stride);
      rx[i] = __ldcs(x + off + i * stride);
    }
  }
}

// Run steps [0, n) from the state h and store each new state.
__device__ __forceinline__ float run_steps(float h,
                                           const float (&ra)[kSteps],
                                           const float (&rx)[kSteps],
                                           float* __restrict__ out,
                                           long long off, long long stride,
                                           int n) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i < n) {
      h = fmaf(ra[i], h, rx[i]);
      __stcs(out + off + i * stride, h);
    }
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
    lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    float* __restrict__ out, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long stride = D;
  const long long chunk = stride * kSteps;
  const long long base = static_cast<long long>(blockIdx.y) * T * D + d;
  float a0[kSteps], x0[kSteps], a1[kSteps], x1[kSteps];
  float h = 0.f;
  load_steps(a, x, base, stride, T, a0, x0);
  // Two chunks an iteration, so each buffer keeps its registers: while one
  // buffer's steps run, the other buffer's loads are in flight.
  for (int t0 = 0; t0 < T; t0 += 2 * kSteps) {
    const long long off0 = base + (t0 / kSteps) * chunk;
    const long long off1 = off0 + chunk;
    load_steps(a, x, off1, stride, T - t0 - kSteps, a1, x1);
    h = run_steps(h, a0, x0, out, off0, stride, T - t0);
    load_steps(a, x, off1 + chunk, stride, T - t0 - 2 * kSteps, a0, x0);
    h = run_steps(h, a1, x1, out, off1, stride, T - t0 - kSteps);
  }
}

// The backward, a reverse scan over t (no TPU counterpart: the JAX package
// trains the RG-LRU through lax.associative_scan). With G_t = dL/dh_t:
//
//   G_t = dh_t + a_{t+1} G_{t+1},   G_{T-1} = dh_{T-1}
//   dx_t = G_t,                     da_t = G_t h_{t-1}  (h_{-1} = 0)
//
// One thread a channel, as in the forward, walking t down from T - 1 with
// G and a_{t+1} in registers; a chunk of kSteps steps (dh_t, a_t, h_{t-1})
// is loaded into registers before its FMAs run. Bound: bytes, read a, h and
// dh and write da and dx once, 20 B T D: 1.34 GB at (4, 4096, 4096), 0.40 ms.
__global__ void __launch_bounds__(kThreads)
    lru_scan_bwd_kernel(const float* __restrict__ a,
                        const float* __restrict__ h,
                        const float* __restrict__ dh,
                        float* __restrict__ da, float* __restrict__ dx, int T,
                        int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long stride = D;
  const long long base = static_cast<long long>(blockIdx.y) * T * D + d;
  float g = 0.f, a_next = 0.f;
  for (int hi = T; hi > 0; hi -= kSteps) {
    const int n = min(kSteps, hi);
    float ra[kSteps], rd[kSteps], rh[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < n) {
        const long long off = base + (hi - 1 - i) * stride;
        ra[i] = __ldcs(a + off);
        rd[i] = __ldcs(dh + off);
        rh[i] = hi - 1 - i > 0 ? __ldcs(h + off - stride) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < n) {
        const long long off = base + (hi - 1 - i) * stride;
        g = fmaf(a_next, g, rd[i]);
        __stcs(dx + off, g);
        __stcs(da + off, g * rh[i]);
        a_next = ra[i];
      }
    }
  }
}

}  // namespace

// The backward's entry point: a, h, dh, da, dx are contiguous float32
// (B, T, D) arrays on the current device (h the forward's output), with
// the forward's limits. Returns the cudaError_t of the launch.
extern "C" int lru_scan_bwd_launch(const void* a, const void* h,
                                   const void* dh, void* da, void* dx, int B,
                                   int T, int D, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  lru_scan_bwd_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<float*>(da),
      static_cast<float*>(dx), T, D);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point (loaded with ctypes). Every pointer is a contiguous
// float32 (B, T, D) array on the current device; 1 <= B <= 65535 (grid.y),
// T, D >= 1 (the wrapper refuses anything else before calling). Returns the
// cudaError_t of the launch (0 on success); the kernel does not synchronise.
extern "C" int lru_scan_launch(const void* a, const void* x, void* h, int B,
                               int T, int D, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  lru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<float*>(h), T, D);
  return static_cast<int>(cudaGetLastError());
}
