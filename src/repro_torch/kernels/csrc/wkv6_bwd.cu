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
// jnp algebra and jax autodiff (src/repro/models/rwkv.py:89), its Pallas
// `wkv6` serves inference only. This kernel is the port's own, the
// backward of WKV6Fn in kernels/wkv6.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): operations, with the
// bytes close behind. The function must read r, k, w, v and dy once and
// write dr, dk, dw and dv once: 4 BH T (4 K + 5 V) B, 1.51 GB at the
// rwkv6-3b prefill shape (BH 160, T 4096), 0.451 ms, and 0.225 ms at the
// training step's BH 80. It does 14 f32 flops an element of S a step (the
// state recomputed 3, its gradient updated 3, four products summed 8),
// 3.76e10 at BH 160, 0.561 ms, and 0.280 ms at BH 80 (chip_smoke.py's
// wkv_bwd_bound counts the same).
//
// Design (a scan over t on CUDA cores, one kernel):
//   * the rows i of S are cut into kSlices slices of kRows; one CTA owns a
//     slice of one bh with all 64 columns, and the kSlices CTAs of a bh
//     form a thread-block cluster. dr, dk and dw (sums over j) are then
//     sums inside the CTA; only dv (a sum over i) crosses CTAs, through
//     distributed shared memory;
//   * a warp owns 2 kLaneRows rows; lane (rl, cl) = (lane / 16, lane %
//     16) owns the kLaneRows x 4 block of rows kLaneRows rl, ... and
//     columns 4 cl .. 4 cl + 3 of S and of G, so each step's r, w, k
//     vector is one address a quarter-warp (a broadcast) and each v, dy
//     float4 feeds 4 kLaneRows elements. At 2 rows a lane, 4 warps a CTA
//     (16 rows, 4 CTAs a bh), a bh has 16 warps: the scan is bound by
//     each warp's chain of dependent steps, not by the card's issue rate,
//     so more warps a bh (each with less to do a step) run it faster;
//   * a forward walk saves S at the start of every chunk of kChunk steps
//     to a scratch buffer (BH ceil(T / kChunk) 4096 floats); the backward
//     walks the chunks down. A chunk's r, w, k, v, dy and its saved state
//     are staged in shared memory with cp.async, two buffers, the next
//     chunk's loads in flight while one is walked; steps past T load
//     zeros, which leave G at 0 and write nothing;
//   * a chunk is walked in sub-chunks of kSub steps, the last first: from
//     the chunk's state a lane walks up to the sub-chunk and recomputes
//     its kSub states into registers (H, 4 kLaneRows floats a step); then
//     it walks the kSub steps down with G in registers. H is read from
//     registers, not shared memory, so the backward step's loads are the
//     step's five input vectors;
//   * the bonus terms of dk and dv ride in G' = G + diag(u o r_t) dy_t^T
//     (dk_t = G'_t v_t, dv_t = G'^T_t k_t), one FMA an element; dr's and
//     du's need v_t . dy_t, computed once a step of the chunk and added in
//     the chunk's epilogue. v . dy and du are summed in double: du sums T
//     terms that cancel (at T 4096 float32 sums miss the float64 result
//     by ~3e-4 on values of ~1), and the work is 68 products a step;
//   * the sums over j (dr, dk, dw: 3 kLaneRows a lane a step) stay in
//     registers for the sub-chunk's kSub steps and meet in one
//     reduce-scatter across the 16 lanes that share the rows (shuffles xor
//     8, 4, 2, 1; half of the values each way, so 4 levels of latency a
//     sub-chunk, not a step), written to shared memory and stored at the
//     chunk's end in 16-byte stores; the sums over i meet across the two
//     row halves of a warp (xor 16) each step, then each warp writes its
//     partial dv of the sub-chunk to a ring of three shared buffers; after
//     a cluster barrier each CTA reads its quarter of the columns from the
//     cluster's kSlices x kWarps partials and stores the sum. The barrier
//     is split (arrive after a sub-chunk's writes, wait one sub-chunk
//     later), so no CTA waits on the others while it has work.
// Every sum is taken in a fixed order, with no atomics: two launches on
// the same inputs give the same bits.
#include <cuda_runtime.h>

namespace {

// The launch shape, from the variants measured by
// experiments/torch_wkv6_bwd_variants.py, which replaces these lines.
constexpr int kLaneRows = 2;  // rows of S (and G) a lane owns, 4 columns
constexpr int kWarps = 4;     // warps a CTA, 2 kLaneRows rows of S each
constexpr int kChunk = 16;    // steps between saved states, staged a buffer
constexpr int kSub = 8;       // steps whose states a lane keeps in registers

constexpr int kDim = 64;                   // K = V
constexpr int kRows = 2 * kLaneRows * kWarps;   // rows of S a CTA owns
constexpr int kSlices = kDim / kRows;      // CTAs of a bh: one cluster
constexpr int kThreads = 32 * kWarps;
constexpr int kSubs = kChunk / kSub;
constexpr unsigned kFull = 0xffffffffu;
static_assert((kLaneRows == 4 || kLaneRows == 2) && kDim % kRows == 0 &&
                  kSlices <= 8 && kChunk % kSub == 0 && kChunk % 4 == 0 &&
                  3 * kLaneRows * kSub % 16 == 0 &&
                  (kThreads % kChunk == 0 || kChunk % kThreads == 0),
              "shape");

// Shared memory, in floats. A staging buffer holds a chunk's r, w, k
// (kChunk x kRows each), v, dy (kChunk x kDim each) and saved state (the
// CTA's kThreads x 4 kLaneRows floats, each lane's float4s row-major); then
// come
// the two buffers, the chunk's row sums (dr, dk, dw: 3 x kChunk x kRows),
// the ring of dv partials (3 x kWarps x kSub x kDim), v . dy a step and
// du's partial sums (doubles: two floats each).
constexpr int kR = 0;
constexpr int kW = kChunk * kRows;
constexpr int kK = 2 * kChunk * kRows;
constexpr int kV = 3 * kChunk * kRows;
constexpr int kY = kV + kChunk * kDim;
constexpr int kS = kY + kChunk * kDim;
constexpr int kBuf = kS + kRows * kDim;
constexpr int kOut = 2 * kBuf;
constexpr int kDvp = kOut + 3 * kChunk * kRows;
constexpr int kVdy = kDvp + 3 * kWarps * kSub * kDim;
constexpr int kDu = kVdy + 2 * kChunk;
constexpr int kBytes = 4 * (kDu + 8 * kThreads);

// PTX helpers: cp.async with zero fill, the cluster barrier, and a read of
// another CTA's shared memory.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float2 ld_cluster2(const float* smem,
                                              unsigned rank) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(s), "r"(rank));
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y) : "r"(remote) : "memory");
  return x;
}

__device__ __forceinline__ float at(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// A lane's kLaneRows consecutive values of a row-indexed vector, in one
// load.
struct Rows {
  float v[kLaneRows];
};

__device__ __forceinline__ Rows ld_rows(const float* p) {
  Rows out;
  if constexpr (kLaneRows == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out.v[0] = q.x, out.v[1] = q.y, out.v[2] = q.z, out.v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out.v[0] = q.x, out.v[1] = q.y;
  }
  return out;
}

// Reduce-scatter of a[0, M) over the lanes xor O, O / 2, ..., 1: while
// more than one value is live, each lane sends half of them to its
// partner and adds the partner's half to the half it keeps (the upper
// half where the lane's bit O is set); then the one value left is summed
// across the remaining lanes. Afterwards a[0] holds the full sum of value
// index sum over halving levels of (bit O set ? M / 2 : 0), and every
// lane that holds a sum holds the same bits.
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

__global__ void __cluster_dims__(kSlices, 1, 1) __launch_bounds__(kThreads)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ w, const float* __restrict__ v,
                    const float* __restrict__ u,
                    const float* __restrict__ dy, float* __restrict__ states,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dw, float* __restrict__ dv,
                    float* __restrict__ du, int T) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int q = blockIdx.x;                 // the slice: the cluster rank
  const long long bh = blockIdx.y;
  const int row0 = q * kRows;
  // The lane's first row in the slice, and its first column.
  const int i0 = 2 * kLaneRows * wp + kLaneRows * (lane >> 4);
  const int j0 = 4 * (lane & 15);
  const int nc = (T + kChunk - 1) / kChunk;
  const long long base = bh * T * kDim;
  const float *rb = r + base, *kb = k + base, *wb = w + base,
              *vb = v + base, *yb = dy + base;
  float* st = states + (bh * kSlices + q) * nc * (kRows * kDim);

  // Stage chunk c into buffer `slot` (r, dy and the saved state only for
  // the backward walk), 16 bytes a copy, zeros past T.
  auto load = [&](int c, int slot, bool bwd) {
    float* buf = smem + slot * kBuf;
    const int t0 = c * kChunk;
    constexpr int kRowQuads = kChunk * kRows / 4, kColQuads = kChunk * 16;
#pragma unroll
    for (int x = tid; x < kRowQuads; x += kThreads) {
      const int t = t0 + x / (kRows / 4);
      const long long src = static_cast<long long>(min(t, T - 1)) * kDim +
                            row0 + 4 * (x % (kRows / 4));
      if (bwd) cp_async16(buf + kR + 4 * x, rb + src, t < T);
      cp_async16(buf + kW + 4 * x, wb + src, t < T);
      cp_async16(buf + kK + 4 * x, kb + src, t < T);
    }
#pragma unroll
    for (int x = tid; x < kColQuads; x += kThreads) {
      const int t = t0 + x / 16;
      const long long src =
          static_cast<long long>(min(t, T - 1)) * kDim + 4 * (x % 16);
      cp_async16(buf + kV + 4 * x, vb + src, t < T);
      if (bwd) cp_async16(buf + kY + 4 * x, yb + src, t < T);
    }
    if (bwd) {
      const float* src = st + static_cast<long long>(c) * kRows * kDim;
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e)
        cp_async16(buf + kS + 4 * (e * kThreads + tid),
                   src + 4 * (e * kThreads + tid), true);
    }
    cp_async_commit();
  };

  // One step of the state: S = diag(w_t) S + k_t v_t^T, step s of `buf`.
  auto advance = [&](const float* buf, int s, float (&S)[kLaneRows][4]) {
    const Rows wq = ld_rows(buf + kW + s * kRows + i0);
    const Rows kq = ld_rows(buf + kK + s * kRows + i0);
    const float4 vq = *reinterpret_cast<const float4*>(buf + kV + s * kDim +
                                                       j0);
#pragma unroll
    for (int e = 0; e < kLaneRows; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        S[e][f] = fmaf(wq.v[e], S[e][f], kq.v[e] * at(vq, f));
  };

  // Forward walk: S_{c kChunk - 1} saved at the start of chunk c.
  {
    float S[kLaneRows][4];
#pragma unroll
    for (int e = 0; e < kLaneRows; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) S[e][f] = 0.f;
    load(0, 0, false);
    for (int c = 0; c < nc; ++c) {
      // Chunk c has landed and every thread is done with chunk c - 1.
      cp_async_wait_all();
      __syncthreads();
      if (c + 1 < nc) load(c + 1, (c + 1) & 1, false);
      float4* dst = reinterpret_cast<float4*>(
          st + static_cast<long long>(c) * kRows * kDim);
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e)
        dst[e * kThreads + tid] = make_float4(S[e][0], S[e][1], S[e][2],
                                              S[e][3]);
      const float* buf = smem + (c & 1) * kBuf;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) advance(buf, s, S);
    }
  }
  // Each thread reads back only the states it wrote: the fence orders its
  // stores before its own cp.async reads of them.
  __threadfence();
  __syncthreads();
  load(nc - 1, (nc - 1) & 1, true);

  const Rows uq = ld_rows(u + bh * kDim + row0 + i0);
  float* out = smem + kOut;        // [3][kChunk][kRows]: dr, dk, dw
  double* vdy = reinterpret_cast<double*>(smem + kVdy);
  // The epilogue's rows (fixed per thread: kThreads is a multiple of
  // kRows / 4) and its share of du.
  const int ex = 4 * (tid % (kRows / 4));
  const float4 ue = *reinterpret_cast<const float4*>(u + bh * kDim + row0 +
                                                     ex);
  double dus[4] = {0.0, 0.0, 0.0, 0.0};

  // dv of sub-chunk number g (its first step t0): the cluster's kSlices x
  // kWarps partials of this CTA's columns [row0, row0 + kRows), summed in
  // rank then warp order. A lane of the partials' rows holds columns 4 cl
  // + 2 rl and + 1 at float2 index lane = 16 rl + cl.
  auto reduce_dv = [&](int g, int t0) {
    constexpr int kPairs = kRows / 2;
#pragma unroll
    for (int x = tid; x < kSub * kPairs; x += kThreads) {
      const int s = x / kPairs, p2 = q * kPairs + x % kPairs;
      const int ln = 16 * (p2 & 1) + (p2 >> 1);
      const float* part = smem + kDvp + (g % 3) * kWarps * kSub * kDim +
                          s * kDim + 2 * ln;
      float2 acc = ld_cluster2(part, 0);
#pragma unroll
      for (int pw = 1; pw < kSlices * kWarps; ++pw) {
        const float2 y = ld_cluster2(part + (pw % kWarps) * kSub * kDim,
                                     pw / kWarps);
        acc.x += y.x;
        acc.y += y.y;
      }
      if (t0 + s < T)
        *reinterpret_cast<float2*>(dv + base +
                                   static_cast<long long>(t0 + s) * kDim +
                                   2 * p2) = acc;
    }
  };

  // Backward walk, a chunk at a time, the last first, G in registers.
  float G[kLaneRows][4];
#pragma unroll
  for (int e = 0; e < kLaneRows; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) G[e][f] = 0.f;
  int g = 0, t_prev = 0;     // sub-chunks walked; the last one's first step
  for (int c = nc - 1; c >= 0; --c) {
    // Chunk c has landed, and chunk c + 1's epilogue is done.
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) load(c - 1, (c - 1) & 1, true);
    const float* buf = smem + (c & 1) * kBuf;
    const int t0c = c * kChunk;

    // v_t . dy_t of the chunk's steps in double, kP lanes a step.
    {
      constexpr int kP = kThreads >= kChunk ? kThreads / kChunk : 1;
#pragma unroll
      for (int x = tid; x < kChunk * kP; x += kThreads) {
        const int s = x / kP, p = x % kP;
        double acc = 0.0;
#pragma unroll
        for (int j = p * (kDim / kP); j < (p + 1) * (kDim / kP); j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(buf + kV +
                                                            s * kDim + j);
          const float4 b = *reinterpret_cast<const float4*>(buf + kY +
                                                            s * kDim + j);
          acc = fma(double(a.x), double(b.x), acc);
          acc = fma(double(a.y), double(b.y), acc);
          acc = fma(double(a.z), double(b.z), acc);
          acc = fma(double(a.w), double(b.w), acc);
        }
#pragma unroll
        for (int o = kP / 2; o > 0; o /= 2)
          acc += __shfl_xor_sync(kFull, acc, o);
        if (p == 0) vdy[s] = acc;
      }
    }

    for (int sub = kSubs - 1; sub >= 0; --sub) {
      const int sb = sub * kSub;         // the sub-chunk's first step
      float S[kLaneRows][4];
#pragma unroll
      for (int e = 0; e < kLaneRows; ++e) {
        const float4 x = reinterpret_cast<const float4*>(
            buf + kS)[e * kThreads + tid];
        S[e][0] = x.x, S[e][1] = x.y, S[e][2] = x.z, S[e][3] = x.w;
      }
      for (int s = 0; s < sb; ++s) advance(buf, s, S);

      // Recompute: H[s] = S_{t-1} of the sub-chunk's steps.
      float H[kSub][kLaneRows][4];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
#pragma unroll
        for (int e = 0; e < kLaneRows; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) H[s][e][f] = S[e][f];
        advance(buf, sb + s, S);
      }

      // Backward: the lane's partial sums over its 4 columns of dr, dk
      // (with its bonus, through G') and dw, kept for the sub-chunk's
      // steps (p[kP3 s + kLaneRows q + e] for quantity q, row e: H[s]
      // frees 4 kLaneRows registers a step as p takes 3 kLaneRows), dv's
      // summed at once; then G_{t-1}.
      constexpr int kP3 = 3 * kLaneRows;
      float p[kP3 * kSub];
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int sc = sb + s;
        const Rows rq = ld_rows(buf + kR + sc * kRows + i0);
        const Rows wq = ld_rows(buf + kW + sc * kRows + i0);
        const Rows kq = ld_rows(buf + kK + sc * kRows + i0);
        const float4 vq = *reinterpret_cast<const float4*>(
            buf + kV + sc * kDim + j0);
        const float4 yq = *reinterpret_cast<const float4*>(
            buf + kY + sc * kDim + j0);
        float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < kLaneRows; ++e) {
          const float ur = uq.v[e] * rq.v[e];
          float ar = 0.f, ak = 0.f, aw = 0.f;
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const float gp = fmaf(ur, at(yq, f), G[e][f]);
            ar = fmaf(H[s][e][f], at(yq, f), ar);
            ak = fmaf(gp, at(vq, f), ak);
            aw = fmaf(H[s][e][f], G[e][f], aw);
            d4[f] = fmaf(gp, kq.v[e], d4[f]);
            G[e][f] = fmaf(wq.v[e], G[e][f], rq.v[e] * at(yq, f));
          }
          p[kP3 * s + e] = ar;
          p[kP3 * s + kLaneRows + e] = ak;
          p[kP3 * s + 2 * kLaneRows + e] = aw;
        }
        // dv over the warp's two row halves: lane keeps columns 2 rl, + 1.
        const bool hi = (lane & 16) != 0;
        const float d0 = (hi ? d4[2] : d4[0]) +
                         __shfl_xor_sync(kFull, hi ? d4[0] : d4[2], 16);
        const float d1 = (hi ? d4[3] : d4[1]) +
                         __shfl_xor_sync(kFull, hi ? d4[1] : d4[3], 16);
        reinterpret_cast<float2*>(smem + kDvp +
                                  ((g % 3) * kWarps + wp) * kSub * kDim +
                                  s * kDim)[lane] = make_float2(d0, d1);
      }
      // The row sums of the sub-chunk at once: a lane ends with the
      // kHeld consecutive values from `held` of the 16 lanes' sums.
      constexpr int kHeld = kP3 * kSub / 16;
      scatter_sum<kP3 * kSub, 8>(p, lane);
      const int held = ((lane >> 3) & 1) * 8 * kHeld +
                       ((lane >> 2) & 1) * 4 * kHeld +
                       ((lane >> 1) & 1) * 2 * kHeld + (lane & 1) * kHeld;
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int x = held + h, s = x / kP3, qe = x % kP3;
        out[(qe / kLaneRows) * kChunk * kRows + (sb + s) * kRows + i0 +
            qe % kLaneRows] = p[h];
      }

      // The previous sub-chunk's partials are complete in every CTA of the
      // cluster once it passes this wait; this one's are released by the
      // arrive. A ring of three buffers: buffer g % 3 is written again
      // only after every CTA arrived past its reads.
      if (g > 0) {
        cluster_wait();
        reduce_dv(g - 1, t_prev);
      }
      cluster_arrive();
      t_prev = t0c + sb;
      ++g;
    }

    // Epilogue: dr's bonus, dr, dk, dw in 16-byte stores, du's sums.
    __syncthreads();
#pragma unroll
    for (int x = tid; x < kChunk * kRows / 4; x += kThreads) {
      const int s = x / (kRows / 4), t = t0c + s;
      const float4 rq = *reinterpret_cast<const float4*>(buf + kR +
                                                         s * kRows + ex);
      const float4 kq = *reinterpret_cast<const float4*>(buf + kK +
                                                         s * kRows + ex);
      const double vd = vdy[s];
      const float vf = static_cast<float>(vd);
      float4 a = *reinterpret_cast<const float4*>(out + s * kRows + ex);
      a.x = fmaf(ue.x * kq.x, vf, a.x);
      a.y = fmaf(ue.y * kq.y, vf, a.y);
      a.z = fmaf(ue.z * kq.z, vf, a.z);
      a.w = fmaf(ue.w * kq.w, vf, a.w);
      dus[0] = fma(double(rq.x) * kq.x, vd, dus[0]);
      dus[1] = fma(double(rq.y) * kq.y, vd, dus[1]);
      dus[2] = fma(double(rq.z) * kq.z, vd, dus[2]);
      dus[3] = fma(double(rq.w) * kq.w, vd, dus[3]);
      if (t < T) {
        const long long at_ = base + static_cast<long long>(t) * kDim +
                              row0 + ex;
        const float* o = out + s * kRows + ex;
        *reinterpret_cast<float4*>(dr + at_) = a;
        *reinterpret_cast<float4*>(dk + at_) =
            *reinterpret_cast<const float4*>(o + kChunk * kRows);
        *reinterpret_cast<float4*>(dw + at_) =
            *reinterpret_cast<const float4*>(o + 2 * kChunk * kRows);
      }
    }
  }
  cluster_wait();
  reduce_dv(g - 1, t_prev);
  // No CTA leaves while another may still read its partials.
  cluster_arrive();
  cluster_wait();

  // du: each row's partial sums added in thread order.
  double* dsum = reinterpret_cast<double*>(smem + kDu);
#pragma unroll
  for (int e = 0; e < 4; ++e) dsum[4 * tid + e] = dus[e];
  __syncthreads();
  if (tid < kRows) {
    const int g4 = tid / 4, e = tid % 4;
    double acc = dsum[4 * g4 + e];
    for (int x = g4 + kRows / 4; x < kThreads; x += kRows / 4)
      acc += dsum[4 * x + e];
    du[bh * kDim + row0 + tid] = static_cast<float>(acc);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). r, k, w, v, dy, dr, dk, dw, dv
// are contiguous float32 (BH, T, 64) arrays, u and du (BH, 64), on the
// current device, 16-byte aligned; `states` holds BH * ceil(T / kChunk) *
// 64 * 64 floats of scratch (the wrapper allocates it). 1 <= BH <= 65535,
// T >= 1 (the wrapper refuses anything else before calling). Returns the
// cudaError_t of the launch (0 on success); nothing synchronises.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* w,
                               const void* v, const void* u, const void* dy,
                               void* states, void* dr, void* dk, void* dw,
                               void* dv, void* du, int bh, int T,
                               void* stream) {
  if (bh < 1 || bh > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_kernel<<<dim3(kSlices, bh), kThreads, kBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(w), static_cast<const float*>(v),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<float*>(states), static_cast<float*>(dr),
      static_cast<float*>(dk), static_cast<float*>(dw),
      static_cast<float*>(dv), static_cast<float*>(du), T);
  return static_cast<int>(cudaGetLastError());
}
