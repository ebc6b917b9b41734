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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): bytes. The function must
// read r, k, w, v and u once and write y once: 4 (BH T (3K + 2V) + BH K) B,
// 839 MB at the rwkv6-3b prefill shape (BH 160, T 4096, K = V = 64), 0.25
// ms. Arithmetic comes close behind: written as below, a step costs 3 f32
// operations an element of S (the k v product, the readout FMA, the update
// FMA), 8.05e9 lane operations or 2.5e8 warp instructions over the card's
// 528 schedulers, ~0.24 ms at full issue.
//
// What holds this kernel back is the shared-memory pipe that hands r, k
// and w to the lanes: every lane needs its slice's values in its own
// registers each step. A float4 read costs an SM 2.1 cycles when each
// quarter-warp reads one address and 4.0 when its 8 lanes read several
// (experiments/smem_patterns.cu), so the layout below gives each
// quarter-warp one slice and each lane two columns (each float4 feeds 24
// operations). That pipe then runs at ~3/4 of its rate, and the step loop
// near one instruction a cycle on the busiest schedulers.
//
// Design (a scan over t on CUDA cores):
//   * one CTA per (bh, V-tile of VT = min(V, kTile) columns), 640 CTAs of
//     64 threads at the prefill shape, at most 5 an SM against a mean of
//     4.85; CTAs of one bh are adjacent in the grid, so they run together
//     and all but the first read r, k and w from L2, not HBM;
//   * each column's K rows are cut into G = min(kGroups, K / 4) slices
//     (quads g, g + G, ... of K); a warp holds 4 slices, one to each
//     quarter-warp, and lane c of a quarter scans columns 2c and 2c + 1 of
//     the tile, keeping its slice of those two columns of S (16 floats) in
//     registers for the whole scan. At the prefill shape that is 2 warps a
//     CTA, 1,280 warps;
//   * a chunk's 16 steps run unrolled, each lane keeping its partial
//     readouts in registers; at the chunk's end one reduce-scatter (2
//     shuffle levels across the quarters, half the values each way) leaves
//     each lane 8 of the warp's sums, and the warps' sums meet in shared
//     memory, added in warp order after the next barrier and written to y
//     in 16-byte stores;
//   * the bonus (r_t . (u o k_t)) is one scalar a step: y_j = b_t v_j +
//     sum_k r_k S_kj. The CTA computes b for a staged chunk's steps once
//     (G lanes a step, u's slice in registers), so an element of S costs 3
//     operations a step; b_t v_t is added to warp 0's sums;
//   * r, k, w and the v tile are staged a chunk at a time with cp.async
//     into a ring of three buffers. At the top of chunk c one barrier makes
//     chunk c + 1 (loaded during chunk c - 1) visible and frees chunk c -
//     1's buffer and sums; then the CTA starts chunk c + 2's load, computes
//     chunk c + 1's bonus, writes chunk c - 1's y and runs chunk c's steps,
//     one straight block with no branch, so that the compiler interleaves
//     the other chunks' work with the steps' arithmetic;
//   * a ragged last chunk (T not a multiple of 16) loads copies of row
//     T - 1 past T and writes only its T mod 16 steps.
//
// The sums are taken in a fixed order (every lane of a reduction ends
// with the same bits); kernels/wkv6.py's wkv6_grouped computes the same
// order on the CPU.
//
// Tensor cores are not used. The chunked form of the recurrence (the
// reference's time_mix algebra) would put the state products in TF32,
// whose 10-bit mantissa is ~3 orders of magnitude outside the float32
// limit the kernel is held to, and the bound above says CUDA cores
// suffice.
#include <cuda_runtime.h>

namespace {

// The launch shape, from the variants measured by
// experiments/torch_wkv6_variants.py, which replaces these lines.
constexpr int kGroups = 8;   // K-slices a column is cut into (<= K / 4)
constexpr int kTile = 16;    // columns of V a CTA scans (<= V), 8 lanes wide
constexpr int kChunk = 16;   // steps staged per shared-memory buffer

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float at(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

template <int K, int VT, int G>
struct Shape {
  static constexpr int Q = G < 4 ? G : 4;   // slices a warp holds
  static constexpr int W = G / Q;           // warps, one for each Q slices
  static constexpr int JS = VT / 8;         // columns a lane scans
  static constexpr int NT = 8 * Q * W;      // threads
  static constexpr int NQ = K / (4 * G);    // float4s of a slice
  static constexpr unsigned kMask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  // One buffer: r, k, w (kChunk x K each), then the v tile (kChunk x VT).
  static constexpr int kBuf = kChunk * (3 * K + VT);
  static constexpr int kBonus = 3 * kBuf;                  // [2][kChunk]
  static constexpr int kPart = kBonus + 2 * kChunk;        // [2][W][kChunk][VT]
  static constexpr int kBytes = 4 * (kPart + 2 * W * kChunk * VT);
  static_assert(K % (4 * G) == 0 && VT % 8 == 0 && (G & (G - 1)) == 0,
                "shape");
};

// Sum of p over the G adjacent lanes of a group in the readout's order:
// the quarters' tree (lanes xor Q / 2, ..., 1), then the warps' (xor Q,
// 2Q, ...): for G = 8, ((p0 + p2) + (p1 + p3)) + ((p4 + p6) + (p5 + p7)).
template <int G>
__device__ __forceinline__ float group_sum(float p, unsigned mask) {
  constexpr int Q = G < 4 ? G : 4;
#pragma unroll
  for (int off = Q / 2; off > 0; off /= 2) p += __shfl_xor_sync(mask, p, off);
#pragma unroll
  for (int off = Q; off < G; off *= 2) p += __shfl_xor_sync(mask, p, off);
  return p;
}

template <int K, int VT, int G>
__global__ void __launch_bounds__((Shape<K, VT, G>::NT))
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ w, const float* __restrict__ v,
                const float* __restrict__ u, float* __restrict__ y, int T,
                int V) {
  using Sh = Shape<K, VT, G>;
  constexpr int Q = Sh::Q, JS = Sh::JS, NT = Sh::NT, NQ = Sh::NQ;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  // The scan's lanes: warp wp holds slices wp Q ... wp Q + Q - 1, one to
  // each quarter-warp, so a quarter's float4 reads of r, k, w share one
  // address; lane c of a quarter scans columns c JS ... c JS + JS - 1.
  const int wp = tid / (8 * Q);
  const int qt = (tid / 8) % Q;
  const int sl = wp * Q + qt;   // the slice: quads sl, sl + G, ... of K
  const int col = (tid % 8) * JS;
  // The bonus's lanes: G adjacent lanes a step, lane bp of them a slice.
  const int bp = tid % G;
  const int j0 = blockIdx.x * VT;
  const long long bh = blockIdx.y;
  const float* rb = r + bh * T * K;
  const float* kb = k + bh * T * K;
  const float* wb = w + bh * T * K;
  const float* vb = v + bh * T * V + j0;
  float* yb = y + bh * T * V + j0;
  const int nchunks = (T + kChunk - 1) / kChunk;

  float us[4 * NQ];   // u's quads of slice bp, for the bonus
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float4 q = reinterpret_cast<const float4*>(u + bh * K)[bp + G * i];
    us[4 * i] = q.x, us[4 * i + 1] = q.y, us[4 * i + 2] = q.z,
    us[4 * i + 3] = q.w;
  }

  // Every per-chunk helper runs a fixed number of iterations with its
  // stores predicated, so a chunk's work is one straight block that the
  // compiler can interleave with the steps' arithmetic.
  constexpr int kQuads = K / 4, kVQuads = VT / 4;

  // Stage chunk c's kChunk steps into buffer `slot`, 16 bytes a copy; rows
  // past T repeat row T - 1.
  auto load = [&](int c, int slot) {
    float* buf = smem + slot * Sh::kBuf;
    const int t0 = c * kChunk;
#pragma unroll
    for (int q0 = 0; q0 < kChunk * kQuads; q0 += NT) {
      const int q = q0 + tid;
      if (kChunk * kQuads % NT == 0 || q < kChunk * kQuads) {
        const int s = q / kQuads;
        const long long src =
            static_cast<long long>(min(t0 + s, T - 1)) * K + 4 * (q % kQuads);
        cp_async16(buf + 4 * q, rb + src);
        cp_async16(buf + kChunk * K + 4 * q, kb + src);
        cp_async16(buf + 2 * kChunk * K + 4 * q, wb + src);
      }
    }
#pragma unroll
    for (int q0 = 0; q0 < kChunk * kVQuads; q0 += NT) {
      const int q = q0 + tid;
      if (kChunk * kVQuads % NT == 0 || q < kChunk * kVQuads) {
        const int s = q / kVQuads;
        cp_async16(buf + 3 * kChunk * K + 4 * q,
                   vb + static_cast<long long>(min(t0 + s, T - 1)) * V +
                       4 * (q % kVQuads));
      }
    }
    cp_async_commit();
  };

  // b_t = r_t . (u o k_t) for chunk c's steps (in buffer c % 3) into
  // bonus slot `slot`: G adjacent lanes a step, slice bp on lane bp, NT / G
  // steps a pass.
  auto bonus = [&](int c, int slot) {
    const float* buf = smem + (c % 3) * Sh::kBuf;
    float* out = smem + Sh::kBonus + slot * kChunk;
    const int n = min(kChunk, T - c * kChunk);
#pragma unroll
    for (int s0 = 0; s0 < kChunk; s0 += NT / G) {
      const int s = s0 + tid / G;
      const float4* r4 = reinterpret_cast<const float4*>(buf + s * K);
      const float4* k4 =
          reinterpret_cast<const float4*>(buf + kChunk * K + s * K);
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 rq = r4[bp + G * i], kq = k4[bp + G * i];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e & 1] = fmaf(at(rq, e), us[4 * i + e] * at(kq, e), acc[e & 1]);
      }
      const float b = group_sum<G>(acc[0] + acc[1], Sh::kMask);
      if (bp == 0 && s < n) out[s] = b;
    }
  };

  // The first `rows` steps of chunk c's y: the warps' partial readouts
  // (warp 0's with b_t v_t) summed in warp order, in 16-byte stores.
  auto store_y = [&](int c, int rows) {
    const float* part = smem + Sh::kPart + (c & 1) * Sh::W * kChunk * VT;
#pragma unroll
    for (int q0 = 0; q0 < kChunk * kVQuads; q0 += NT) {
      const int q = q0 + tid;
      const int s = q / kVQuads;
      if ((kChunk * kVQuads % NT == 0 || q < kChunk * kVQuads) && s < rows) {
        float4 acc = reinterpret_cast<const float4*>(part)[q];
#pragma unroll
        for (int x = 1; x < Sh::W; ++x) {
          const float4 p =
              reinterpret_cast<const float4*>(part + x * kChunk * VT)[q];
          acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
        }
        *reinterpret_cast<float4*>(
            yb + static_cast<long long>(c * kChunk + s) * V +
            4 * (q % kVQuads)) = acc;
      }
    }
  };

  // After a chunk's reduce-scatter (below) a lane holds kHeld of the
  // chunk's kChunk JS partial sums: flat indices base, ..., + kHeld - 1.
  constexpr int kHeld = kChunk * JS / Q;
  int base = 0;
#pragma unroll
  for (int level = 0, off = 4 * Q; off >= 8; ++level, off /= 2)
    base += (tid & off) ? kChunk * JS >> (level + 1) : 0;

  float S[JS][4 * NQ];
#pragma unroll
  for (int j = 0; j < JS; ++j)
#pragma unroll
    for (int i = 0; i < 4 * NQ; ++i) S[j][i] = 0.f;

  load(0, 0);
  load(min(1, nchunks - 1), 1);
  cp_async_wait_all();
  __syncthreads();
  bonus(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    // Chunk c + 1 has landed for every thread, bonus slot c % 2 and chunk
    // c - 1's partials are written, and chunk c - 1's buffer is free.
    cp_async_wait_all();
    __syncthreads();
    const float* buf = smem + (c % 3) * Sh::kBuf;
    const int n = min(kChunk, T - c * kChunk);
    // Warp 0's sums take b_t v_t: read now, so that the reads' latency
    // passes under the steps.
    float bv[kHeld];
    if (wp == 0) {
      const float* bb = smem + Sh::kBonus + (c & 1) * kChunk;
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int s = (base + h) / JS;
        bv[h] = bb[s] * buf[3 * kChunk * K + s * VT + col + (base + h) % JS];
      }
    }
    // Past the last chunk the loads and the bonus repeat it, into a buffer
    // and a slot that nothing reads.
    load(min(c + 2, nchunks - 1), (c + 2) % 3);
    bonus(min(c + 1, nchunks - 1), (c + 1) & 1);
    store_y(c - 1, c > 0 ? kChunk : 0);

    // The chunk's kChunk steps, unrolled, each lane's partial readouts
    // kept in registers: val[s JS + j] for step s, column col + j. A
    // ragged chunk runs its last kChunk - n steps on copies of row T - 1:
    // they change only the state after step T - 1, which is never read,
    // and the y of steps past T, which is never written.
    float val[kChunk * JS];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float4* r4 = reinterpret_cast<const float4*>(buf + s * K);
      const float4* k4 =
          reinterpret_cast<const float4*>(buf + kChunk * K + s * K);
      const float4* w4 =
          reinterpret_cast<const float4*>(buf + 2 * kChunk * K + s * K);
      const float* vs = buf + 3 * kChunk * K + s * VT + col;
      float vj[JS];
#pragma unroll
      for (int j = 0; j < JS; ++j) vj[j] = vs[j];
      // Two partial sums a column, of a quad's even and odd positions.
      float acc[JS][2];
#pragma unroll
      for (int j = 0; j < JS; ++j) acc[j][0] = acc[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 rq = r4[sl + G * i], kq = k4[sl + G * i],
                     wq = w4[sl + G * i];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < JS; ++j) {
            const float kv = at(kq, e) * vj[j];
            acc[j][e & 1] = fmaf(at(rq, e), S[j][4 * i + e], acc[j][e & 1]);
            S[j][4 * i + e] = fmaf(at(wq, e), S[j][4 * i + e], kv);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JS; ++j) val[s * JS + j] = acc[j][0] + acc[j][1];
    }

    // Sum the warp's Q slices in the quarters' tree (xor 4 Q, ..., 8
    // lanes), each level sending half the values held to the partner
    // quarter and keeping the other half: the lane ends with val[0],
    // ..., val[kHeld - 1], flat indices base, ..., base + kHeld - 1.
#pragma unroll
    for (int level = 0, off = 4 * Q; off >= 8; ++level, off /= 2) {
      const int held = kChunk * JS >> (level + 1);
      const bool hi = (tid & off) != 0;
#pragma unroll
      for (int i = 0; i < kChunk * JS / 2; ++i) {
        if (i < held) {
          const float send = hi ? val[i] : val[held + i];
          const float recv = __shfl_xor_sync(Sh::kMask, send, off);
          val[i] = (hi ? val[held + i] : val[i]) + recv;
        }
      }
    }
    // The partials go to shared memory for store_y, which adds the warps'
    // in order after the next barrier.
    float* part = smem + Sh::kPart + ((c & 1) * Sh::W + wp) * kChunk * VT;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int s = (base + h) / JS;
      if (s < n)
        part[s * VT + col + (base + h) % JS] = wp == 0 ? bv[h] + val[h]
                                                        : val[h];
    }
  }
  __syncthreads();
  store_y(nchunks - 1, T - (nchunks - 1) * kChunk);
}

template <int K, int V>
cudaError_t launch(const float* r, const float* k, const float* w,
                   const float* v, const float* u, float* y, int bh, int T,
                   cudaStream_t stream) {
  constexpr int VT = V < kTile ? V : kTile;
  constexpr int G = K / 4 < kGroups ? K / 4 : kGroups;
  using Sh = Shape<K, VT, G>;
  if (Sh::kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<K, VT, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sh::kBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(V / VT, bh);
  wkv6_kernel<K, VT, G><<<grid, Sh::NT, Sh::kBytes, stream>>>(
      r, k, w, v, u, y, T, V);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const float* r, const float* k, const float* w,
                     const float* v, const float* u, float* y, int bh, int T,
                     int V, cudaStream_t stream) {
  switch (V) {
    case 8: return launch<K, 8>(r, k, w, v, u, y, bh, T, stream);
    case 16: return launch<K, 16>(r, k, w, v, u, y, bh, T, stream);
    case 32: return launch<K, 32>(r, k, w, v, u, y, bh, T, stream);
    case 64: return launch<K, 64>(r, k, w, v, u, y, bh, T, stream);
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
