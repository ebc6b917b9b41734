// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a). Per row bh of the
// (batch x heads) axis, with key dim K, value dim V and decay w_t:
//
//   y_t = (r_t . u) (k_t v_t^T) + r_t^T S_{t-1}
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_0 = 0
//
// r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K); y: (BH, T, V); all f32.
//
// Replaces the Pallas TPU kernel `wkv6` (src/repro/kernels/wkv6.py:53,
// pallas_call at :61, body _wkv_kernel :28). The TPU kernel walks a
// sequential (bh, time-chunk) grid and keeps S in VMEM scratch, zeroed at
// the first chunk of a row. Blocks on the card run in no order, so the
// time axis is a loop inside one block instead, and S starts at zero in
// registers: nothing carries over between blocks.
//
// Design (simple first; a scan over t):
//   * one CTA per (bh, V-tile) of VT = min(V, 32) columns, one thread per
//     column j of S: thread j keeps S[:, j] (K floats) in registers for the
//     whole scan;
//   * the CTA stages r, k, w (K floats a step) and its v tile for kChunk
//     steps at a time in shared memory with cp.async, double-buffered, so
//     the next chunk's loads overlap this chunk's steps; u is staged once;
//   * per step thread j computes y_j = sum_k r_k (u_k k_k v_j + S_kj) and
//     then S_kj = w_k S_kj + k_k v_j, and writes y_j. A ragged last chunk
//     (T not a multiple of kChunk) loads and runs only its T mod kChunk
//     steps.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes. The function must
// read r, k, w, v and u once and write y once: 4 (BH T (3K + 2V) + BH K) B,
// 839 MB at the rwkv6-3b prefill shape (BH 160, T 4096, K = V = 64), 0.25
// ms; it does 5 K V T BH = 13.4 GFLOP, 0.20 ms. This version is latency-
// bound instead: each warp runs T dependent steps of ~5K instructions, and
// 160 rows x 2 tiles give 320 warps on 132 SMs, too few to hide a step's
// latency. Splitting K across threads (more warps, a shuffle reduction of
// y) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;   // steps staged per shared-memory buffer

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int K, int VT>
struct Stage {
  float r[2][kChunk * K];
  float k[2][kChunk * K];
  float w[2][kChunk * K];
  float v[2][kChunk * VT];
};

template <int K, int VT>
__global__ void __launch_bounds__(VT) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v,
    const float* __restrict__ u, float* __restrict__ y, int T, int V) {
  __shared__ __align__(16) Stage<K, VT> st;
  __shared__ float su[K];
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * VT;
  const long long bh = blockIdx.y;
  const float* rb = r + bh * T * K;
  const float* kb = k + bh * T * K;
  const float* wb = w + bh * T * K;
  const float* vb = v + bh * T * V + j0;
  float* yb = y + bh * T * V + j0;

  for (int i = tid; i < K; i += VT) su[i] = u[bh * K + i];

  // Stage steps [t0, t0 + n) into buffer `buf`: 16 bytes a copy.
  auto load = [&](int buf, int t0) {
    const int n = min(kChunk, T - t0);
    const long long off = static_cast<long long>(t0) * K;
    for (int q = tid; q < n * K / 4; q += VT) {
      cp_async16(&st.r[buf][4 * q], rb + off + 4 * q);
      cp_async16(&st.k[buf][4 * q], kb + off + 4 * q);
      cp_async16(&st.w[buf][4 * q], wb + off + 4 * q);
    }
    constexpr int kQuads = VT / 4;
    for (int q = tid; q < n * kQuads; q += VT) {
      const int c = q / kQuads;
      const int e = q - c * kQuads;
      cp_async16(&st.v[buf][c * VT + 4 * e],
                 vb + static_cast<long long>(t0 + c) * V + 4 * e);
    }
    cp_async_commit();
  };

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = 0.f;

  const int nchunks = (T + kChunk - 1) / kChunk;
  load(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) {
      load(buf ^ 1, (c + 1) * kChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kChunk, T - c * kChunk);
    for (int t = 0; t < n; ++t) {
      const float4* rt = reinterpret_cast<const float4*>(&st.r[buf][t * K]);
      const float4* kt = reinterpret_cast<const float4*>(&st.k[buf][t * K]);
      const float4* wt = reinterpret_cast<const float4*>(&st.w[buf][t * K]);
      const float4* ut = reinterpret_cast<const float4*>(su);
      const float vj = st.v[buf][t * VT + tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 r4 = rt[q], k4 = kt[q], w4 = wt[q], u4 = ut[q];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kk[e] * vj;
          acc[e] += rr[e] * (uu[e] * kv + S[i]);
          S[i] = ww[e] * S[i] + kv;
        }
      }
      yb[static_cast<long long>(c * kChunk + t) * V + tid] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();  // every thread is done with `buf` before it refills
  }
}

template <int K, int VT>
cudaError_t launch(const float* r, const float* k, const float* w,
                   const float* v, const float* u, float* y, int bh, int T,
                   int V, cudaStream_t stream) {
  const dim3 grid(V / VT, bh);
  wkv6_kernel<K, VT><<<grid, VT, 0, stream>>>(r, k, w, v, u, y, T, V);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const float* r, const float* k, const float* w,
                     const float* v, const float* u, float* y, int bh, int T,
                     int V, cudaStream_t stream) {
  switch (V) {
    case 8: return launch<K, 8>(r, k, w, v, u, y, bh, T, V, stream);
    case 16: return launch<K, 16>(r, k, w, v, u, y, bh, T, V, stream);
    case 32:
    case 64: return launch<K, 32>(r, k, w, v, u, y, bh, T, V, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). K and V must each be one of
// 8, 16, 32, 64 (the wrapper refuses any other shape before calling), and
// every pointer 16-byte aligned. Returns the cudaError_t of the launch (0
// on success); the kernel does not synchronise.
extern "C" int wkv6_launch(const void* r, const void* k, const void* w,
                           const void* v, const void* u, void* y, int bh,
                           int T, int K, int V, void* stream) {
  if (bh < 1 || T < 1 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* wf = static_cast<const float*>(w);
  const auto* vf = static_cast<const float*>(v);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K) {
    case 8: err = launch_k<8>(rf, kf, wf, vf, uf, yf, bh, T, V, s); break;
    case 16: err = launch_k<16>(rf, kf, wf, vf, uf, yf, bh, T, V, s); break;
    case 32: err = launch_k<32>(rf, kf, wf, vf, uf, yf, bh, T, V, s); break;
    case 64: err = launch_k<64>(rf, kf, wf, vf, uf, yf, bh, T, V, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
