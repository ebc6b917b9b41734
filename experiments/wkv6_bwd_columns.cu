// The WKV backward's column-tiled design, kept beside the package's kernel
// (src/repro_torch/kernels/csrc/wkv6_bwd.cu, which cuts rows instead) so
// that experiments/torch_wkv6_bwd_variants.py can build both and time them
// in one run. Not part of the package; its C entry point takes the scratch
// described at its end (`part` as well as `states`).
//
// Backward of the RWKV-6 WKV recurrence for Hopper (sm_90a). Per row bh,
// with the forward (csrc/wkv6.cu)
//
//   y_t = (r_t . (u o k_t)) v_t + S_{t-1}^T r_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,        S_{-1} = 0
//
// and G_t = dL/dS_t, G_{T-1} = 0, G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//
//   dr_t = S_{t-1} dy_t + (u o k_t)(v_t . dy_t)
//   dk_t = G_t v_t + (u o r_t)(v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u o k_t)) dy_t
//   dw_t[i] = sum_j S_{t-1}[i,j] G_t[i,j]
//   du = sum_t (r_t o k_t)(v_t . dy_t)
//
// r, k, w, dr, dk, dw: (BH, T, 64); v, dy, dv: (BH, T, 64); u, du: (BH, 64);
// all f32. K = V = 64 only (the model's head width).
//
// No TPU kernel to replace: the JAX package trains these blocks through
// jnp algebra (src/repro/models/rwkv.py), its Pallas `wkv6` serves
// inference only. This kernel is the port's own, the backward of
// WKV6Fn in kernels/wkv6.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes, with the
// operations close behind. The function must read r, k, w, v and dy once
// and write dr, dk, dw and dv once: 9 x 4 BH T 64 B, 1.51 GB at the
// rwkv6-3b prefill shape (BH 160, T 4096), 0.45 ms; it does ~12 f32
// operations an element of S a step (the state and its gradient updated,
// four products summed), 3.2e10 at that shape, 0.48 ms.
//
// Design (simple first: a scan over t on CUDA cores, two kernels):
//   * dw needs S_{t-1} while G is walked backward in time. The main kernel
//     walks t forward once, keeping S in registers and saving it to a
//     scratch buffer at the start of every chunk of kChunk steps; then it
//     walks the chunks backward, recomputes each chunk's kChunk states
//     from its saved start into registers, and walks the chunk's steps
//     backward with G in registers;
//   * one CTA per (bh, tile of kTile columns of V), 256 threads; a
//     thread owns kRows consecutive rows i of one column j of S and of G
//     (a half-warp's 16 lanes share the rows and hold the tile's 16
//     columns);
//   * the sums over j (dr, dk, dw) are reduce-scatters over the half-warp
//     (each lane keeps a share of the values, half of them each way); the
//     tile's partial sums go to a scratch buffer, one slice a tile; the
//     sums over i (dv) meet in shared memory and are added in warp order
//     at the chunk's end, written complete (a CTA holds every row);
//   * a second kernel, one CTA a row, adds the kTiles partial sums in
//     tile order, the bonus terms and b_t dy_t, and sums du over t in a
//     fixed order (a warp's steps in order, then the warps in order).
// Every sum is taken in a fixed order: the result does not depend on
// scheduling. The scratch (the saved states, BH T / kChunk 4096 floats,
// and the partial sums, 3 kTiles BH T 64 floats) is allocated by the
// wrapper. Its traffic, ~4 GB at the prefill shape, is what a later
// version should remove.
#include <cuda_runtime.h>

namespace {

constexpr int kDim = 64;                  // K = V
constexpr int kTile = 16;                 // columns of V a CTA owns
constexpr int kTiles = kDim / kTile;      // CTAs a row
constexpr int kRows = 4;                  // rows of S a thread owns
constexpr int kThreads = (kDim / kRows) * kTile;   // 256
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                // steps between saved states
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Reduce-scatter of a[0, M) over the 16 lanes of a half-warp (offsets
// O, O / 2, ..., 1): while more than one value is live, each lane sends
// half of them to its partner and adds the partner's half to the half it
// keeps (the upper half where the lane's bit O is set); then the one
// value left is summed across the remaining lanes. Afterwards a[0] holds
// the full sum of value index sum over halving levels of (bit O set ? M /
// 2 : 0), and each sum is taken in one order on every lane that holds it.
template <int M, int O, int N>
__device__ __forceinline__ void scatter_sum(float (&a)[N], int lane) {
  if constexpr (O > 0) {
    if constexpr (M > 1) {
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int e = 0; e < M / 2; ++e) {
        const float send = hi ? a[e] : a[e + M / 2];
        const float keep = hi ? a[e + M / 2] : a[e];
        a[e] = keep + __shfl_xor_sync(kFull, send, O);
      }
      scatter_sum<M / 2, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], O);
      scatter_sum<1, O / 2>(a, lane);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ w, const float* __restrict__ v,
                    const float* __restrict__ dy,
                    float4* __restrict__ states, float* __restrict__ part,
                    float* __restrict__ dv, int BH, int T) {
  __shared__ float dvs[kChunk][kWarps][kTile];
  const int jt = blockIdx.x;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int jl = lane & 15;
  const int i0 = (warp * 2 + (lane >> 4)) * kRows;
  const int j = jt * kTile + jl;
  const int nc = (T + kChunk - 1) / kChunk;
  const long long row = bh * T * kDim;             // (bh, 0, 0)
  float4* st = states + (bh * kTiles + jt) * nc * kThreads + tid;
  const long long slice = static_cast<long long>(BH) * T * kDim;
  // partial sums of this tile: q = 0 dr, 1 dk, 2 dw
  float* pdr = part + (0 * kTiles + jt) * slice + row;
  float* pdk = part + (1 * kTiles + jt) * slice + row;
  float* pdw = part + (2 * kTiles + jt) * slice + row;

  // Forward walk: S_{c kChunk - 1} saved at the start of chunk c.
  float S[kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    st[static_cast<long long>(c) * kThreads] =
        make_float4(S[0], S[1], S[2], S[3]);
    const int n = min(kChunk, T - c * kChunk);
    for (int s = 0; s < n; ++s) {
      const long long off = row + (static_cast<long long>(c) * kChunk + s)
                                      * kDim;
      const float4 wq = ld4(w + off + i0), kq = ld4(k + off + i0);
      const float vj = __ldg(v + off + j);
      S[0] = fmaf(wq.x, S[0], kq.x * vj);
      S[1] = fmaf(wq.y, S[1], kq.y * vj);
      S[2] = fmaf(wq.z, S[2], kq.z * vj);
      S[3] = fmaf(wq.w, S[3], kq.w * vj);
    }
  }

  // Backward walk, a chunk at a time, G in registers.
  float G[kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int c = nc - 1; c >= 0; --c) {
    const int n = min(kChunk, T - c * kChunk);
    const long long base = row + static_cast<long long>(c) * kChunk * kDim;
    const float4 s0 = st[static_cast<long long>(c) * kThreads];
    float H[kChunk][kRows];      // H[s] = S_{t-1} at step t = c kChunk + s
    float Sc[kRows] = {s0.x, s0.y, s0.z, s0.w};
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s < n) {
        const long long off = base + s * kDim;
        const float4 wq = ld4(w + off + i0), kq = ld4(k + off + i0);
        const float vj = __ldg(v + off + j);
#pragma unroll
        for (int e = 0; e < kRows; ++e) H[s][e] = Sc[e];
        Sc[0] = fmaf(wq.x, Sc[0], kq.x * vj);
        Sc[1] = fmaf(wq.y, Sc[1], kq.y * vj);
        Sc[2] = fmaf(wq.z, Sc[2], kq.z * vj);
        Sc[3] = fmaf(wq.w, Sc[3], kq.w * vj);
      }
    }
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      if (s < n) {
        const long long off = base + s * kDim;
        const float4 rq = ld4(r + off + i0), wq = ld4(w + off + i0),
                     kq = ld4(k + off + i0);
        const float vj = __ldg(v + off + j), dyj = __ldg(dy + off + j);
        const float rr[kRows] = {rq.x, rq.y, rq.z, rq.w};
        const float ww[kRows] = {wq.x, wq.y, wq.z, wq.w};
        const float kk[kRows] = {kq.x, kq.y, kq.z, kq.w};
        float a8[8], a4[4];
        float dvp = 0.f;
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          a4[e] = H[s][e] * dyj;          // dr: S_{t-1} dy_t
          a8[e] = G[e] * vj;              // dk: G_t v_t
          a8[e + kRows] = H[s][e] * G[e]; // dw
          dvp = fmaf(G[e], kk[e], dvp);   // dv: G_t^T k_t
          G[e] = fmaf(ww[e], G[e], rr[e] * dyj);
        }
        scatter_sum<8, 8>(a8, lane);
        scatter_sum<4, 8>(a4, lane);
        const long long at = off - row;   // (t, 0) within the row
        const int i8 = ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
                       ((lane >> 1) & 1);
        if ((lane & 1) == 0) {
          if (i8 < kRows) pdk[at + i0 + i8] = a8[0];
          else pdw[at + i0 + i8 - kRows] = a8[0];
        }
        const int i4 = ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
        if ((lane & 3) == 0) pdr[at + i0 + i4] = a4[0];
        dvp += __shfl_xor_sync(kFull, dvp, 16);
        if (lane < 16) dvs[s][warp][jl] = dvp;
      }
    }
    __syncthreads();
    {
      const int s = tid / kTile, jj = tid % kTile;
      if (s < n) {
        float acc = dvs[s][0][jj];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) acc += dvs[s][q][jj];
        dv[base + s * kDim + jt * kTile + jj] = acc;
      }
    }
    __syncthreads();
  }
}

// One CTA a row bh, kWarps warps; warp q takes the steps t = q, q +
// kWarps, ... in order, lane l the elements l and l + 32.
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_finish(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ u,
                    const float* __restrict__ dy,
                    const float* __restrict__ part, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dw,
                    float* __restrict__ dv, float* __restrict__ du, int BH,
                    int T) {
  __shared__ float dus[kWarps][kDim];
  const long long bh = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = bh * T * kDim;
  const long long slice = static_cast<long long>(BH) * T * kDim;
  const float u0 = u[bh * kDim + lane], u1 = u[bh * kDim + lane + 32];
  float du0 = 0.f, du1 = 0.f;
  for (int t = warp; t < T; t += kWarps) {
    const long long off = row + static_cast<long long>(t) * kDim;
    const float r0 = r[off + lane], r1 = r[off + lane + 32];
    const float k0 = k[off + lane], k1 = k[off + lane + 32];
    const float y0 = dy[off + lane], y1 = dy[off + lane + 32];
    float vdy = fmaf(v[off + lane + 32], y1, v[off + lane] * y0);
    float b = fmaf(r1, u1 * k1, r0 * (u0 * k0));
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      vdy += __shfl_xor_sync(kFull, vdy, o);
      b += __shfl_xor_sync(kFull, b, o);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long at = off + lane + 32 * h;
      float sr = part[at], sk = part[kTiles * slice + at],
            sw = part[2 * kTiles * slice + at];
#pragma unroll
      for (int q = 1; q < kTiles; ++q) {
        sr += part[q * slice + at];
        sk += part[(kTiles + q) * slice + at];
        sw += part[(2 * kTiles + q) * slice + at];
      }
      const float uu = h ? u1 : u0, rr = h ? r1 : r0, kk = h ? k1 : k0;
      dr[at] = sr + uu * kk * vdy;
      dk[at] = sk + uu * rr * vdy;
      dw[at] = sw;
      dv[at] += b * (h ? y1 : y0);
    }
    du0 += r0 * k0 * vdy;
    du1 += r1 * k1 * vdy;
  }
  dus[warp][lane] = du0;
  dus[warp][lane + 32] = du1;
  __syncthreads();
  if (threadIdx.x < kDim) {
    float acc = dus[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) acc += dus[q][threadIdx.x];
    du[bh * kDim + threadIdx.x] = acc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). r, k, w, v, dy, dr, dk, dw, dv
// are contiguous float32 (BH, T, 64) arrays, u and du (BH, 64), on the
// current device; `states` holds BH * kTiles * ceil(T / kChunk) *
// kThreads float4 and `part` 3 * kTiles * BH * T * 64 floats of scratch
// (the wrapper allocates both). 1 <= BH <= 65535, T >= 1 (the wrapper
// refuses anything else before calling). Returns the cudaError_t of the
// launches (0 on success); nothing synchronises.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* w,
                               const void* v, const void* u, const void* dy,
                               void* states, void* part, void* dr, void* dk,
                               void* dw, void* dv, void* du, int bh, int T,
                               void* stream) {
  if (bh < 1 || bh > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* yf = static_cast<const float*>(dy);
  auto* pf = static_cast<float*>(part);
  auto* dvf = static_cast<float*>(dv);
  wkv6_bwd_kernel<<<dim3(kTiles, bh), kThreads, 0, s>>>(
      rf, kf, static_cast<const float*>(w), vf, yf,
      static_cast<float4*>(states), pf, dvf, bh, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_finish<<<bh, kThreads, 0, s>>>(
      rf, kf, vf, static_cast<const float*>(u), yf, pf,
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dw), dvf, static_cast<float*>(du), bh, T);
  return static_cast<int>(cudaGetLastError());
}
