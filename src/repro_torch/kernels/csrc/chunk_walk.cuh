// Pieces shared by the spMTTKRP kernels that walk a work table of chunks
// (mttkrp_balanced.cu, mttkrp_gather.cu, mttkrp_pregathered.cu): cp.async
// copies into shared memory, the table row a CTA takes, the rows_pp x R
// accumulator tile and the warp runs that sum into it.
//
// The work table (kernels/mttkrp.py WorkTable, built and checked on the
// host) is (nchunks, 4) int32 rows (partition, first block, end block,
// partial); CTA i takes row i. A chunk that is its whole partition writes
// its tile to out_rel; the chunks of a split partition write theirs to a
// scratch buffer of partials, which mttkrp_balanced_reduce_kernel
// (mttkrp_balanced.cu) sums in chunk order.
//
// Each .cu file that includes this header is its own library, so the
// helpers live in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxInputs = 8;   // input factors per launch: nmodes <= 9
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct FactorPtrs {
  const float* p[kMaxInputs];
};

__host__ __device__ constexpr int a4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n 4-byte words global -> shared, spread over the CTA; 16-byte copies
// where both ends are 16-byte aligned and n is a multiple of 4 (the same
// for every thread, so the branch does not diverge).
__device__ __forceinline__ void copy_words(int* dst, const int* src, int n,
                                           int tid) {
  const bool vec = (((reinterpret_cast<uintptr_t>(src) | smem_u32(dst)) &
                     15) == 0) && (n & 3) == 0;
  if (vec) {
    for (int t = tid; t < (n >> 2); t += kThreads) {
      cp_async16(dst + 4 * t, src + 4 * t);
    }
  } else {
    for (int t = tid; t < n; t += kThreads) cp_async4(dst + t, src + t);
  }
}

struct Chunk {
  int part, b0, b1, partial;
};

// CTA i's row of the work table. The wrappers pass only tables that
// check_work passed; a malformed row stops the kernel with a trap (an
// error at the next synchronisation), never a silent return that would
// leave rows of the output unwritten.
__device__ __forceinline__ Chunk chunk_row(const int* work, int i, int kappa,
                                           int nblocks, int n_partials) {
  const int* c = work + 4 * static_cast<long long>(i);
  const Chunk k = {c[0], c[1], c[2], c[3]};
  if (k.part < 0 || k.part >= kappa || k.b0 < 0 || k.b1 < k.b0 ||
      k.b1 > nblocks || k.partial < -1 || k.partial >= n_partials) {
    __trap();
  }
  return k;
}

__device__ __forceinline__ void zero_tile(float* acc, int tile, int tid) {
  if ((tile & 3) == 0) {
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int t = tid; t < (tile >> 2); t += kThreads) {
      acc4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int t = tid; t < tile; t += kThreads) acc[t] = 0.f;
  }
}

// The accumulator to out_rel (a whole partition) or to the chunk's partial.
__device__ __forceinline__ void write_tile(const float* acc, int tile,
                                           const Chunk& c, float* out,
                                           float* partials, int tid) {
  float* dst = c.partial < 0
                   ? out + static_cast<long long>(c.part) * tile
                   : partials + static_cast<long long>(c.partial) * tile;
  if ((tile & 3) == 0) {
    const float4* acc4 = reinterpret_cast<const float4*>(acc);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int t = tid; t < (tile >> 2); t += kThreads) dst4[t] = acc4[t];
  } else {
    for (int t = tid; t < tile; t += kThreads) dst[t] = acc[t];
  }
}

// A warp takes the run of consecutive slots [i0, i1) of a block, one rank
// column a lane, and sums val[s] * prod(s, col) in a register while the
// slot's row (lrow) stays the same, with one shared-memory atomic a row
// change: the hot row's slots cost one atomic a run, not one a slot. Pad
// slots (lrow < 0) are skipped before prod reads anything of them.
template <class Prod>
__device__ __forceinline__ void warp_runs(float* acc, const int* lrow,
                                          const float* val, int i0, int i1,
                                          int r, int lane, Prod prod) {
  for (int col = lane; col < r; col += 32) {
    int cur = -1;
    float sum = 0.f;
    for (int s = i0; s < i1; ++s) {
      const int lr = lrow[s];
      if (lr < 0) continue;
      const float term = prod(s, col) * val[s];
      if (lr == cur) {
        sum += term;
      } else {
        if (cur >= 0) atomicAdd(&acc[cur * r + col], sum);
        cur = lr;
        sum = term;
      }
    }
    if (cur >= 0) atomicAdd(&acc[cur * r + col], sum);
  }
}

// Slots [i0, i1) of a block of p that warp `wid` takes.
__device__ __forceinline__ void warp_slots(int p, int wid, int& i0, int& i1) {
  const int spw = (p + kWarps - 1) / kWarps;
  i0 = min(p, wid * spw);
  i1 = min(p, i0 + spw);
}

// Alg. 3 for one block, from its metadata in shared memory: each alive
// slot's (val, idx, alpha) row to row alpha[s, next_mode] of the next
// layout. The destinations are a permutation of the alive slots, so the
// copies need no atomics; pads (alpha[s, next_mode] < 0) stay put, over
// the pad pattern the wrapper filled the next layout with.
__device__ __forceinline__ void remap_scatter(const int* idx,
                                              const int* alpha,
                                              const float* val, int p, int n,
                                              int next_mode, float* nval,
                                              int* nidx, int* nalpha,
                                              int tid) {
  for (int t = tid; t < p * n; t += kThreads) {
    const int s = t / n;
    const int mm = t - s * n;
    const int d = alpha[s * n + next_mode];
    if (d < 0) continue;
    const long long dst = static_cast<long long>(d) * n + mm;
    nidx[dst] = idx[t];
    nalpha[dst] = alpha[t];
    if (mm == 0) nval[d] = val[s];
  }
}

}  // namespace
