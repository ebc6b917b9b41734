// spMTTKRP elementwise computation (paper Alg. 2/4) on the compact block
// schedule with in-block factor-row dedup, and optionally the Alg. 3 remap
// into the next mode's layout, for Hopper (sm_90a), with the partitions'
// work balanced across thread blocks.
//
// Replaces the Pallas TPU kernels (src/repro/kernels/mttkrp_kernel.py):
//   mttkrp_fused_gather_compact (:466)   REMAP = false
//   mttkrp_fused_remap_compact  (:583)   REMAP = true
// Both bodies are _compact_gather_kernel (:304); the remap is
// _remap_init_and_scatter (:214). What they compute:
//   out_rel[bpart[b] * rows_pp + lrow_i, :] +=
//       val_i * prod_{w} F_w[uidx[w, b * P + upos[i, w]], :]
// over the alive slots i (lrow_i >= 0) of every block b; with the remap,
// each alive slot's (val, idx, alpha) row is also copied to row
// alpha[i, next] of the next layout, which the wrapper fills with the pad
// pattern before the launch.
//
// Bound on an H100 SXM: bytes, as chip_smoke.py byte_bound counts them
// (val, lrow, upos, the used uidx entries, nuniq, each factor row in use
// once, out_rel written once; the remap adds idx/alpha read and the next
// layout written): ~6 FLOP a slot and rank lane against 3.35 TB/s.
//
// Two things keep a one-CTA-per-partition kernel far from that bound, and
// the design has one part for each:
//
// (a) Balance. A row is owned by one partition (paper Observation 2), so a
//     hot row makes one partition hold a large share of the blocks (~11%
//     of nell1's nonzeros), and one CTA walking it alone sets the time.
//     Here the host builds a work table of chunks (partition, [b_begin,
//     b_end), partial), each at most `cap` consecutive blocks of one
//     partition, largest first; the grid is the chunk count and CTA i
//     takes chunk i (a static assignment, no work-queue atomics). A CTA
//     accumulates its chunk into a rows_pp x R tile in shared memory. A
//     partition that is one chunk writes its tile straight to out_rel (the
//     paper's design); the chunks of a split partition write their tiles to
//     a scratch buffer of partials, and the second kernel of this file,
//     mttkrp_balanced_reduce_kernel, sums each split partition's partials
//     in chunk order and writes its rows of out_rel. So no global atomics
//     touch the output, and the result does not depend on the order in
//     which CTAs run. The only global traffic between CTAs is those
//     partials: each split partition's tile written once per chunk and
//     read once, 2 * n_partials * rows_pp * R * 4 bytes (~30 partials of
//     107 KB for nell1's hot partition at R 32).
// (b) The cost per block. A slot loop that reads its metadata from global
//     memory waits on a chain of dependent loads per slot (lrow, then
//     upos, then the stage, then val).
//     Here each block's lrow, val, upos, uidx and nuniq (and idx/alpha for
//     the remap) are staged into shared memory with one coalesced cp.async
//     copy, one block ahead of the compute, so the next block's metadata
//     is in flight while a block fetches its factor rows (which depend on
//     its uidx) and computes. The slot loop then reads only shared memory.
//     A warp takes a run of consecutive slots, one rank column a lane, and
//     sums in a register while lrow stays the same (the hot row, in the
//     hot partition) before its shared-memory atomic. With the remap, a
//     block's scatter into the next layout reads only its metadata, so it
//     runs while the block's factor rows are in flight. A deeper pipeline
//     (factor rows two or three blocks ahead) made the gather kernel no
//     faster on an H100 and the remap kernel a few percent at most (the
//     slot loop's own instructions set the time; PERF.md), so the
//     pipeline is one block deep and leaves the shared memory to the
//     accumulator.
//
// Shared memory per CTA (4-byte words; a4 rounds up to a multiple of 4):
//   two metadata buffers of 2 a4(P) + a4(P (N-1)) + (N-1) a4(P)
//     + a4(N-1) [+ 2 a4(P N) with the remap],
//   one factor-row stage of a4((N-1) P R), and the rows_pp x R
//   accumulator (smem_bytes below). kernels/mttkrp.py balanced_smem_bytes
//   is the same formula: the wrapper passes its count and the launch
//   refuses one that differs. ExecutionConfig.resolve_rows_pp sizes
//   rows_pp from it.

#include "chunk_walk.cuh"

namespace {

constexpr int kReduceThreads = 256;

// Word offsets of one block's metadata buffer.
struct MetaLayout {
  int lrow, val, upos, uidx, nuniq, idx, alpha, words, a4p;
  __device__ MetaLayout(int p, int nm1, int n) {
    a4p = a4(p);
    lrow = 0;
    val = a4p;
    upos = 2 * a4p;
    uidx = upos + a4(p * nm1);
    nuniq = uidx + nm1 * a4p;
    idx = nuniq + a4(nm1);
    alpha = idx + (n > 0 ? a4(p * n) : 0);
    words = alpha + (n > 0 ? a4(p * n) : 0);
  }
};

struct Args {
  const float* val;
  const int* lrow;
  const int* upos;
  const int* uidx;
  const int* nuniq;
  const int* work;        // (nchunks, 4): part, b_begin, b_end, partial
  FactorPtrs fac;
  int nm1, kappa, rows_pp, block_p, rank, nblocks, n_partials;
  float* out;             // (kappa * rows_pp, R)
  float* partials;        // (n_partials, rows_pp, R)
  const int* idx;         // remap: (S, N)
  const int* alpha;       // remap: (S, N)
  int nmodes, next_mode;  // nmodes = 0 without the remap
  float* nval;
  int* nidx;
  int* nalpha;
};

template <bool REMAP>
__device__ __forceinline__ void load_meta(const Args& a, const MetaLayout& ml,
                                          int* m, long long b, int tid) {
  const int p = a.block_p;
  const long long base = b * p;
  const long long s = static_cast<long long>(a.nblocks) * p;
  copy_words(m + ml.lrow, a.lrow + base, p, tid);
  copy_words(m + ml.val, reinterpret_cast<const int*>(a.val) + base, p, tid);
  copy_words(m + ml.upos, a.upos + base * a.nm1, p * a.nm1, tid);
  for (int w = 0; w < a.nm1; ++w) {
    copy_words(m + ml.uidx + w * ml.a4p, a.uidx + w * s + base, p, tid);
  }
  if (tid < a.nm1) {
    cp_async4(m + ml.nuniq + tid, a.nuniq + tid * a.nblocks + b);
  }
  if (REMAP) {
    copy_words(m + ml.idx, a.idx + base * a.nmodes, p * a.nmodes, tid);
    copy_words(m + ml.alpha, a.alpha + base * a.nmodes, p * a.nmodes, tid);
  }
}

// The nuniq[w] unique rows of each input factor named by the block's uidx,
// into the stage (factor w at w * P * R, unique row u at u * R).
template <bool VEC>
__device__ __forceinline__ void load_rows(const Args& a, const MetaLayout& ml,
                                          const int* m, float* st, int tid) {
  const int p = a.block_p, r = a.rank;
  const int chunk = VEC ? r >> 2 : r;   // copies per row
  for (int w = 0; w < a.nm1; ++w) {
    const int un = min(m[ml.nuniq + w], p);
    const int* ui = m + ml.uidx + w * ml.a4p;
    const float* f = a.fac.p[w];
    float* dst = st + w * p * r;
    for (int t = tid; t < un * chunk; t += kThreads) {
      const int u = t / chunk;
      const int c = t - u * chunk;
      const float* src = f + static_cast<long long>(ui[u]) * r;
      if (VEC) {
        cp_async16(dst + u * r + 4 * c, src + 4 * c);
      } else {
        cp_async4(dst + u * r + c, src + c);
      }
    }
  }
}

// One CTA an SM (the accumulator takes most of the shared memory), so the
// compiler may use all of its registers: 128 a thread at 512 threads.
template <bool REMAP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    mttkrp_balanced_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const int p = a.block_p, r = a.rank, nm1 = a.nm1;
  const MetaLayout ml(p, nm1, REMAP ? a.nmodes : 0);
  int* meta = smem;   // two buffers: block i's at (i & 1)
  float* stage = reinterpret_cast<float*>(smem + 2 * ml.words);
  float* acc = stage + a4(nm1 * p * r);
  const int tile = a.rows_pp * r;

  const Chunk c = chunk_row(a.work, blockIdx.x, a.kappa, a.nblocks,
                            a.n_partials);
  const int b0 = c.b0;
  const int nb = c.b1 - c.b0;
  zero_tile(acc, tile, tid);

  const int lane = tid & 31;
  int i0, i1;
  warp_slots(p, tid >> 5, i0, i1);
  if (nb > 0) load_meta<REMAP>(a, ml, meta, b0, tid);
  cp_commit();
  for (int i = 0; i < nb; ++i) {
    const int* m = meta + (i & 1) * ml.words;
    const int* lrow = m + ml.lrow;
    const float* val = reinterpret_cast<const float*>(m + ml.val);
    const int* upos = m + ml.upos;
    cp_wait<0>();          // meta(i) has landed
    __syncthreads();       // ... for all; block i - 1 is done everywhere
    load_rows<VEC>(a, ml, m, stage, tid);
    cp_commit();
    if (i + 1 < nb) {
      load_meta<REMAP>(a, ml, meta + ((i + 1) & 1) * ml.words, b0 + i + 1,
                       tid);
    }
    cp_commit();
    if (REMAP) {
      // It reads only block i's metadata, so it runs while the block's
      // factor rows are in flight.
      remap_scatter(m + ml.idx, m + ml.alpha, val, p, a.nmodes, a.next_mode,
                    a.nval, a.nidx, a.nalpha, tid);
    }
    cp_wait<1>();          // rows(i) have landed
    __syncthreads();

    warp_runs(acc, lrow, val, i0, i1, r, lane, [&](int s, int col) {
      const int* up = upos + s * nm1;
      float prod = stage[up[0] * r + col];
      for (int w = 1; w < nm1; ++w) {
        prod *= stage[w * p * r + up[w] * r + col];
      }
      return prod;
    });
  }
  cp_wait<0>();
  __syncthreads();

  write_tile(acc, tile, c, a.out, a.partials, tid);
}

// The second pass: for each split partition, out_rel's rows are the sum of
// its partials in chunk order. wsum (n_partials, 2) holds, for the first
// partial of each split partition, (partition, count), and (-1, 0) for the
// others; a partition's partials are consecutive. blockIdx.x is the
// partial, blockIdx.y a slice of the tile.
template <bool VEC>
__global__ void __launch_bounds__(kReduceThreads)
    mttkrp_balanced_reduce_kernel(const float* __restrict__ partials,
                                  const int* __restrict__ wsum, int tile,
                                  int kappa, int n_partials,
                                  float* __restrict__ out) {
  const int q = blockIdx.x;
  const int part = wsum[2 * q], count = wsum[2 * q + 1];
  if (count <= 0) return;   // not the first partial of a split partition
  // A malformed head (check_work refuses one on the host) traps rather
  // than leaving the partition's rows of out_rel unwritten.
  if (part < 0 || part >= kappa || q + count > n_partials) __trap();
  const long long t =
      static_cast<long long>(blockIdx.y) * kReduceThreads + threadIdx.x;
  if (VEC) {
    if (t >= (tile >> 2)) return;
    const float4* src = reinterpret_cast<const float4*>(partials) +
                        static_cast<long long>(q) * (tile >> 2) + t;
    float4 s = __ldcs(src);
    for (int k = 1; k < count; ++k) {
      const float4 v = __ldcs(src + static_cast<long long>(k) * (tile >> 2));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[static_cast<long long>(part) *
                                       (tile >> 2) + t] = s;
  } else {
    if (t >= tile) return;
    const float* src = partials + static_cast<long long>(q) * tile + t;
    float s = __ldcs(src);
    for (int k = 1; k < count; ++k) {
      s += __ldcs(src + static_cast<long long>(k) * tile);
    }
    out[static_cast<long long>(part) * tile + t] = s;
  }
}

// Shared memory of one CTA (bytes): the layout at the top of this file.
size_t smem_bytes(int rows_pp, int rank, int nm1, int block_p, int nmodes) {
  const int meta_words =
      2 * a4(block_p) + a4(block_p * nm1) + nm1 * a4(block_p) + a4(nm1) +
      (nmodes > 0 ? 2 * a4(block_p * nmodes) : 0);
  return 4 * (2 * static_cast<size_t>(meta_words) +
              static_cast<size_t>(a4(nm1 * block_p * rank)) +
              static_cast<size_t>(rows_pp) * rank);
}

template <bool REMAP, bool VEC>
int launch(const Args& a, int nchunks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_balanced_kernel<REMAP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mttkrp_balanced_kernel<REMAP, VEC><<<nchunks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes); each returns the cudaError_t
// of its launch (0 on success) and does not synchronise.
//
// mttkrp_balanced_launch: `factors` is a host array of nm1 device
// pointers; `work` the (nchunks, 4) chunk table on the device; `partials`
// the (n_partials, rows_pp, R) scratch (may be null when n_partials is 0).
// With `alpha == nullptr` the kernel without the remap runs and
// idx/nmodes/next_mode/nval/nidx/nalpha are ignored. `vec` selects 16-byte
// factor-row copies (R % 4 == 0 and every factor 16-byte aligned);
// `smem` is the caller's count of the CTA's shared memory, refused unless
// it equals this file's.
extern "C" int mttkrp_balanced_launch(
    const void* val, const void* lrow, const void* upos, const void* uidx,
    const void* nuniq, const void* work, const void* factors, int nm1,
    int nchunks, int kappa, int rows_pp, int block_p, int rank, int nblocks,
    int n_partials, int vec, int smem, void* out,
    void* partials, const void* idx, const void* alpha, int nmodes,
    int next_mode, void* nval, void* nidx, void* nalpha, void* stream) {
  const bool remap = alpha != nullptr;
  if (nm1 < 1 || nm1 > kMaxInputs || nchunks < 1 || block_p < 1 ||
      rank < 1 || rows_pp < 1 ||
      static_cast<size_t>(smem) != smem_bytes(rows_pp, rank, nm1, block_p,
                                              remap ? nmodes : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  const void* const* fp = static_cast<const void* const*>(factors);
  for (int w = 0; w < nm1; ++w) a.fac.p[w] = static_cast<const float*>(fp[w]);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  a.val = static_cast<const float*>(val);
  a.lrow = i32(lrow);
  a.upos = i32(upos);
  a.uidx = i32(uidx);
  a.nuniq = i32(nuniq);
  a.work = i32(work);
  a.nm1 = nm1;
  a.kappa = kappa;
  a.rows_pp = rows_pp;
  a.block_p = block_p;
  a.rank = rank;
  a.nblocks = nblocks;
  a.n_partials = n_partials;
  a.out = static_cast<float*>(out);
  a.partials = static_cast<float*>(partials);
  if (remap) {
    a.idx = i32(idx);
    a.alpha = i32(alpha);
    a.nmodes = nmodes;
    a.next_mode = next_mode;
    a.nval = static_cast<float*>(nval);
    a.nidx = static_cast<int*>(nidx);
    a.nalpha = static_cast<int*>(nalpha);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (remap) {
    return vec ? launch<true, true>(a, nchunks, smem, st)
               : launch<true, false>(a, nchunks, smem, st);
  }
  return vec ? launch<false, true>(a, nchunks, smem, st)
             : launch<false, false>(a, nchunks, smem, st);
}

// mttkrp_balanced_reduce_launch: the second pass over `partials`
// (n_partials, rows_pp, R) and `wsum` (n_partials, 2) into `out`.
extern "C" int mttkrp_balanced_reduce_launch(const void* partials,
                                             const void* wsum,
                                             int n_partials, int kappa,
                                             int rows_pp, int rank,
                                             void* out, void* stream) {
  if (n_partials < 1 || rows_pp < 1 || rank < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = rows_pp * rank;
  const bool vec = (tile & 3) == 0;
  const int words = vec ? tile >> 2 : tile;
  const dim3 grid(n_partials, (words + kReduceThreads - 1) / kReduceThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(partials);
  auto w = static_cast<const int*>(wsum);
  auto o = static_cast<float*>(out);
  if (vec) {
    mttkrp_balanced_reduce_kernel<true><<<grid, kReduceThreads, 0, st>>>(
        p, w, tile, kappa, n_partials, o);
  } else {
    mttkrp_balanced_reduce_kernel<false><<<grid, kReduceThreads, 0, st>>>(
        p, w, tile, kappa, n_partials, o);
  }
  return static_cast<int>(cudaGetLastError());
}
