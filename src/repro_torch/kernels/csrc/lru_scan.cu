// RG-LRU linear recurrence for Hopper (sm_90a). Per channel (b, d):
//
//   h_t = a_t * h_{t-1} + x_t,        h_{-1} = 0
//
// a, x, h: (B, T, D) float32, contiguous.
//
// Replaces the Pallas TPU kernel `lru_scan` (src/repro/kernels/lru_scan.py:44,
// pallas_call at :50, body _lru_kernel :27), which walks a sequential grid
// of time chunks and carries the (B, D) state in VMEM scratch. The backward
// (lru_scan_bwd_kernel below) replaces no TPU kernel: the JAX package trains
// the RG-LRU through lax.associative_scan.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The forward must read a and x and
// write h once, 12 B T D bytes (805 MB, 0.240 ms at recurrentgemma-9b's
// prefill (4, 4096, 4096); 101 MB, 0.030 ms at a model shard's
// (1, 4096, 2048)); the backward reads a, h, dh and writes da, dx, 20 B T D.
// The flops (2 and 3 an element) are negligible.
//
// A scan that gives each channel to one thread for all T steps is bound by
// the latency of one warp's walk wherever B D / 32 CTAs do not fill the
// card several times over: at (1, 4096, 2048) the one-thread-a-channel
// kernel had 16 CTAs of 128 channels for 132 SMs and reached a tenth of the
// bound. So the time axis is split too.
//
// Design: a scan split over time.
//   * A CTA is one warp: kC = 32 channels along D (a lane a channel; a step's
//     row is one 128-byte line) and one span of L steps of them. The grid
//     is (split, b, channel tile); the wrapper picks the span from
//     (B, T, D) and the SM count (`split_bounds` in kernels/lru_scan.py):
//     one span of T where B ceil(D / 32) CTAs are 1.5 an SM or more, else
//     spans of at most kG kSlots = 128 steps (longer only where 64 spans
//     would not cover T).
//   * Each CTA scans its span from a zero state: P, the product of the
//     span's a, and L_h, its end state. It publishes (P, L_h) and raises a
//     release flag, then waits for the flags of the earlier spans of its
//     channels and folds their aggregates in a fixed order, span 0 first
//     (carry = fmaf(P_j, carry, L_h_j)), never a predecessor's inclusive
//     value, whose readiness depends on timing: results repeat bitwise run
//     to run. Last it runs h = fmaf(a, h, x) again over its span from that
//     carry and stores h. The rounding inside a span is the sequential
//     scan's; only the carry crosses spans. Span 0 (carry 0) stores h on
//     its first walk and ends there, and with one span that is the whole
//     kernel.
//   * A CTA takes its span from an atomic ticket, split-major, so every CTA
//     it waits for holds an earlier ticket, has started, and publishes
//     without waiting itself: no deadlock whatever the occupancy.
//   * Loads are cp.async copies into a ring of kSlots stages of kG steps in
//     shared memory (16 bytes a lane where D and the pointers allow, else
//     4), issued kA stages ahead and spending no registers. Where the span
//     fits the ring (L <= 128) it stays there: the second walk reads shared
//     memory, and a and x are read once (12 B T D; the backward 20 B T D).
//     Where it does not (a very long T at a small B D, e.g. 64 spans of 512
//     at (1, 32768, 1024)) the second walk loads the span again: 20 B T D
//     (the backward 32 B T D) for those shapes.
//   * A whole stage's values go from shared memory into registers before
//     its 16 steps run unrolled, and h (and da, dx) are stored from
//     registers through a pointer stepped by D, with streaming hints: a
//     step costs an FMA's latency and a store. Offsets are 64-bit.
//   * The wrapper hands in `sync`, zeroed by torch.zeros (the ticket, then a
//     flag a (split, b, tile)), and `agg`, room for the aggregates; the
//     kernel allocates nothing.
// On an H100 a warp's walk moves ~10 GB/s (experiments/torch_lru_split_probe
// .py: deeper or shallower loads do not change it; the steps alone take a
// third of it), so the card is filled by warps, not by loads in flight:
// one span from ~2 CTAs an SM, spans of 128 below that.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kC = 32;     // channels a CTA: one warp, a lane a channel
constexpr int kG = 16;     // steps a stage of the ring
constexpr int kA = 7;      // stages loaded ahead of the one being walked
constexpr int kSlots = kA + 1;  // stages the ring holds (kG kSlots = 128)
constexpr long long kMaxSpin = 1LL << 26;  // polls of a flag (seconds)

// ---------------------------------------------------------------------------
// Copies and flags.
// ---------------------------------------------------------------------------
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 4 * V : 0;   // 0: fill zeros, read nothing
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// ---------------------------------------------------------------------------
// Where a CTA works.
// ---------------------------------------------------------------------------
struct Span {
  int k;          // split (span) index
  int r;          // b * tiles + tile: the CTA's slot within its split
  int d0;         // first channel of the tile
  bool live;      // this lane's channel d0 + lane < D
  int t0, n;      // the span's first step and length
  long long row;  // offset of (b, t = 0, d = 0)
};

// The CTA's span: from its ticket (split-major; `reverse` hands the last
// split out first) when there are several splits, else from blockIdx.
__device__ __forceinline__ Span locate(int B, int T, int D, int S, int L,
                                       int* ticket, bool reverse) {
  const int tiles = (D + kC - 1) / kC;
  const int per = B * tiles;
  int v = blockIdx.x;
  if (S > 1) {
    if (threadIdx.x == 0) v = atomicAdd(ticket, 1);
    v = __shfl_sync(0xffffffffu, v, 0);
  }
  Span s;
  s.k = v / per;
  if (reverse) s.k = S - 1 - s.k;
  s.r = v % per;
  const int b = s.r / tiles;
  s.d0 = (s.r % tiles) * kC;
  s.live = s.d0 + static_cast<int>(threadIdx.x) < D;
  s.t0 = s.k * L;
  s.n = min(T, s.t0 + L) - s.t0;
  s.row = static_cast<long long>(b) * T * D;
  return s;
}

// ---------------------------------------------------------------------------
// The ring: `slots` stages of NA arrays (kSlots, or the span's stages where
// fewer: the ring then holds the whole span); stage q holds walk steps
// [q kG, q kG + kG), array j's step i of the tile at slot[(j kG + i) kC +
// channel]. Step p of the walk is t = t0 + p forward, t = t0 + n - 1 - p in
// reverse; array j is read at row t - lag[j] (zeros before row 0). A slot
// is refilled kA + 1 = kSlots stages later, after its stage was walked.
// ---------------------------------------------------------------------------
// Copy stage q of the span into `slot` (nothing past the span's end), and
// close a cp.async group either way.
template <int NA, int V, bool REV>
__device__ __forceinline__ void issue(float* slot,
                                      const float* const (&src)[NA],
                                      const int (&lag)[NA], const Span& s,
                                      int D, int q) {
  constexpr int kPer = kC / V;    // copies a row
  constexpr int kRows = kC / kPer; // rows a warp's copy covers
  if (q * kG < s.n) {
    const int col = static_cast<int>(threadIdx.x) % kPer * V;
    const bool in_d = s.d0 + col < D;
    const int rows = min(kG, s.n - q * kG);
#pragma unroll
    for (int r = 0; r < kG / kRows; ++r) {
      const int i = r * kRows + static_cast<int>(threadIdx.x) / kPer;
      if (i < rows) {
        const int p = q * kG + i;
        const int t = REV ? s.t0 + s.n - 1 - p : s.t0 + p;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          const int tt = t - lag[j];
          const bool ok = in_d && tt >= 0;
          const float* g = ok ? src[j] + s.row +
                                    static_cast<long long>(tt) * D + s.d0 +
                                    col
                              : src[j];
          cp_async<V>(slot + (j * kG + i) * kC + col, g, ok);
        }
      }
    }
  }
  cp_commit();
}

// Walk the span's n steps in order, calling f(v) with v[j] array j's value
// at the next step of the walk for this lane's channel. Loads run kA stages
// ahead; `loaded`: the ring already holds the whole span. A whole stage's
// values are read into registers before its steps run, and its steps are
// unrolled without guards, so a step waits only on the one before's FMA.
template <int NA, int V, bool REV, class F>
__device__ __forceinline__ void walk(float* ring,
                                     const float* const (&src)[NA],
                                     const int (&lag)[NA], const Span& s,
                                     int D, int slots, bool loaded, F&& f) {
  constexpr int kSlot = NA * kG * kC;   // floats a slot
  const int nst = (s.n + kG - 1) / kG;
  int fill = 0, cur = 0;   // slots of the next stage copied and walked
  __syncwarp();
  if (!loaded)
    for (int q = 0; q < kA; ++q) {
      issue<NA, V, REV>(ring + fill * kSlot, src, lag, s, D, q);
      fill = fill + 1 == slots ? 0 : fill + 1;
    }
  for (int q = 0; q < nst; ++q) {
    if (!loaded) {
      __syncwarp();   // every lane is done with the slot refilled now
      issue<NA, V, REV>(ring + fill * kSlot, src, lag, s, D, q + kA);
      fill = fill + 1 == slots ? 0 : fill + 1;
      cp_wait<kA>();
      __syncwarp();   // stage q, copied by every lane, visible to all
    }
    const float* slot = ring + cur * kSlot + threadIdx.x;
    cur = cur + 1 == slots ? 0 : cur + 1;
    if ((q + 1) * kG <= s.n) {
      float v[kG][NA];
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int j = 0; j < NA; ++j) v[i][j] = slot[(j * kG + i) * kC];
#pragma unroll
      for (int i = 0; i < kG; ++i) f(v[i]);
    } else {
      for (int i = 0; q * kG + i < s.n; ++i) {
        float v[NA];
#pragma unroll
        for (int j = 0; j < NA; ++j) v[j] = slot[(j * kG + i) * kC];
        f(v);
      }
    }
  }
}

// Publish this span's aggregate (P, L_h) of the lane's channel, then the
// CTA's release flag.
__device__ __forceinline__ void publish(int* flags, float2* agg,
                                        const Span& s, int per, float p,
                                        float l) {
  agg[(static_cast<long long>(s.k) * per + s.r) * kC + threadIdx.x] =
      make_float2(p, l);
  __threadfence();
  __syncwarp();
  if (threadIdx.x == 0) st_release(flags + s.k * per + s.r, 1);
}

// The carry into this span: the aggregates of spans j0, j0 + step, ...
// (count of them) folded in that order from 0, once every one is
// published.
__device__ __forceinline__ float carry_in(const int* flags,
                                          const float2* agg, const Span& s,
                                          int per, int j0, int step,
                                          int count) {
  for (int i = threadIdx.x; i < count; i += kC) {
    const int* f = flags + (j0 + i * step) * per + s.r;
    // A flag waited on belongs to a CTA that has started and raises it
    // after its own first walk, microseconds later; one that stays down
    // for seconds is a fault: trap (a launch failure) rather than hang.
    for (long long spin = 0; ld_acquire(f) == 0; ++spin) {
      if (spin > kMaxSpin) __trap();
      __nanosleep(64);
    }
  }
  __syncwarp();
  float c = 0.f;
#pragma unroll 16   // loads in flight together: up to 64 spans, 4 batches
  for (int i = 0; i < count; ++i) {
    const float2 v = __ldcg(
        agg + (static_cast<long long>(j0 + i * step) * per + s.r) * kC +
        threadIdx.x);
    c = fmaf(v.x, c, v.y);
  }
  return c;
}

template <int V>
__global__ void __launch_bounds__(kC)
    lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                    float* __restrict__ h, int B, int T, int D, int S, int L,
                    int slots, int* sync, float2* agg) {
  extern __shared__ __align__(16) float ring[];
  const Span s = locate(B, T, D, S, L, sync, false);
  const int per = B * ((D + kC - 1) / kC);
  const float* const src[2] = {a, x};
  const int lag[2] = {0, 0};
  float* const out = h + s.row + s.d0 + threadIdx.x +
                     static_cast<long long>(s.t0) * D;
  const bool first = s.k == 0;   // carry in 0: its first walk is the scan
  const bool store = first && s.live;
  float p = 1.f, y = 0.f, *o = out;
  walk<2, V, false>(ring, src, lag, s, D, slots, false,
                    [&](const float (&v)[2]) {
                      y = fmaf(v[0], y, v[1]);
                      p *= v[0];
                      if (store) __stcs(o, y);
                      o += D;
                    });
  if (s.k + 1 < S) publish(sync + 1, agg, s, per, p, y);
  if (first) return;
  y = carry_in(sync + 1, agg, s, per, 0, 1, s.k);
  o = out;
  walk<2, V, false>(ring, src, lag, s, D, slots, s.n <= slots * kG,
                    [&](const float (&v)[2]) {
                      y = fmaf(v[0], y, v[1]);
                      if (s.live) __stcs(o, y);
                      o += D;
                    });
}

// The backward, a reverse scan over t. With G_t = dL/dh_t:
//
//   G_t = dh_t + a_{t+1} G_{t+1},   G_{T-1} = dh_{T-1}
//   dx_t = G_t,                     da_t = G_t h_{t-1}  (h_{-1} = 0)
//
// The same design with time reversed. A span [t0, t1) takes the carry
// c = a_{t1} G_{t1} from the later spans (0 for the last) and gives
// a_{t0} G_{t0} = P c + L_h to the one before, with P the product of the
// span's a and L_h that value from c = 0. The last span's CTAs hold the
// first tickets; span k folds spans S - 1, ..., k + 1 in that order. h is
// read one row late (h_{t-1} beside step t), so the span's first step takes
// h_{t0 - 1} from the span before. Bound: 20 B T D (1.34 GB, 0.40 ms at
// (4, 4096, 4096); 0.050 ms at (1, 4096, 2048)); 32 B T D where a span
// does not fit the ring.
template <int V>
__global__ void __launch_bounds__(kC)
    lru_scan_bwd_kernel(const float* __restrict__ a,
                        const float* __restrict__ h,
                        const float* __restrict__ dh, float* __restrict__ da,
                        float* __restrict__ dx, int B, int T, int D, int S,
                        int L, int slots, int* sync, float2* agg) {
  extern __shared__ __align__(16) float ring[];
  const Span s = locate(B, T, D, S, L, sync, true);
  const int per = B * ((D + kC - 1) / kC);
  const float* const src[3] = {a, dh, h};
  const int lag[3] = {0, 0, 1};
  // The walk's first step is the span's last, t0 + n - 1.
  const long long top = s.row + s.d0 + threadIdx.x +
                        static_cast<long long>(s.t0 + s.n - 1) * D;
  const bool last = s.k == S - 1;   // carry in 0
  const bool store = last && s.live;
  float p = 1.f, g = 0.f, an = 1.f, *ox = dx + top, *oa = da + top;
  walk<3, V, true>(ring, src, lag, s, D, slots, false,
                   [&](const float (&v)[3]) {
                     g = fmaf(an, g, v[1]);
                     p *= v[0];
                     an = v[0];
                     if (store) {
                       __stcs(ox, g);
                       __stcs(oa, g * v[2]);
                     }
                     ox -= D;
                     oa -= D;
                   });
  if (s.k > 0) publish(sync + 1, agg, s, per, p, an * g);
  if (last) return;
  g = carry_in(sync + 1, agg, s, per, S - 1, -1, S - 1 - s.k);
  an = 1.f;
  ox = dx + top;
  oa = da + top;
  walk<3, V, true>(ring, src, lag, s, D, slots, s.n <= slots * kG,
                   [&](const float (&v)[3]) {
                     g = fmaf(an, g, v[1]);
                     an = v[0];
                     if (s.live) {
                       __stcs(ox, g);
                       __stcs(oa, g * v[2]);
                     }
                     ox -= D;
                     oa -= D;
                   });
}

// Checks shared by both entry points; returns the grid size, or 0 for
// arguments the kernels do not take.
long long grid_of(int B, int T, int D, int S, int L, const void* sync,
                  const void* agg) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || L < 1 || S < 1 || S > 64 ||
      static_cast<long long>(S - 1) * L >= T ||
      static_cast<long long>(S) * L < T || (S > 1 && (!sync || !agg)))
    return 0;
  const long long n = static_cast<long long>(S) * B * ((D + kC - 1) / kC);
  return n > 0x7fffffffLL ? 0 : n;
}

// Stages of the ring: a span's, up to kSlots. Its shared memory, NA slots
// * kG kC 4 B, is at most 3 * 8 * 2 KB = 48 KB: no opt-in needed.
int slots_of(int T, int L) {
  return std::min(kSlots, (std::min(T, L) + kG - 1) / kG);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// Plain C entry points (loaded with ctypes). a, x, h (forward) and a, h,
// dh, da, dx (backward, h the forward's output) are contiguous float32
// (B, T, D) arrays on the current device; 1 <= B <= 65535, T, D >= 1; S
// spans of L steps (S = ceil(T / L) <= 64); for S > 1, `sync` is
// 1 + S B ceil(D / 32) zeroed int32 and `agg` S B ceil(D / 32) * 32
// float2. Returns the cudaError_t of the launch (0 on success); the kernels
// do not synchronise.
extern "C" int lru_scan_launch(const void* a, const void* x, void* h, int B,
                               int T, int D, int S, int L, void* sync,
                               void* agg, void* stream) {
  const long long grid = grid_of(B, T, D, S, L, sync, agg);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = slots_of(T, L);
  const size_t smem = static_cast<size_t>(slots) * 2 * kG * kC * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fx = static_cast<const float*>(x);
  auto* fh = static_cast<float*>(h);
  auto* fs = static_cast<int*>(sync);
  auto* fg = static_cast<float2*>(agg);
  if (D % 4 == 0 && aligned16({a, x}))
    lru_scan_kernel<4><<<static_cast<unsigned>(grid), kC, smem, st>>>(
        fa, fx, fh, B, T, D, S, L, slots, fs, fg);
  else
    lru_scan_kernel<1><<<static_cast<unsigned>(grid), kC, smem, st>>>(
        fa, fx, fh, B, T, D, S, L, slots, fs, fg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lru_scan_bwd_launch(const void* a, const void* h,
                                   const void* dh, void* da, void* dx, int B,
                                   int T, int D, int S, int L, void* sync,
                                   void* agg, void* stream) {
  const long long grid = grid_of(B, T, D, S, L, sync, agg);
  if (!grid) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = slots_of(T, L);
  const size_t smem = static_cast<size_t>(slots) * 3 * kG * kC * sizeof(float);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fh = static_cast<const float*>(h);
  const auto* fd = static_cast<const float*>(dh);
  auto* oa = static_cast<float*>(da);
  auto* ox = static_cast<float*>(dx);
  auto* fs = static_cast<int*>(sync);
  auto* fg = static_cast<float2*>(agg);
  if (D % 4 == 0 && aligned16({a, h, dh}))
    lru_scan_bwd_kernel<4><<<static_cast<unsigned>(grid), kC, smem, st>>>(
        fa, fh, fd, oa, ox, B, T, D, S, L, slots, fs, fg);
  else
    lru_scan_bwd_kernel<1><<<static_cast<unsigned>(grid), kC, smem, st>>>(
        fa, fh, fd, oa, ox, B, T, D, S, L, slots, fs, fg);
  return static_cast<int>(cudaGetLastError());
}
