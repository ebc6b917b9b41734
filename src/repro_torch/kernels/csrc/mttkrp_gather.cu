// spMTTKRP elementwise computation (paper Alg. 2/4) on the rect block
// schedule with the factor-row gather inside the kernel, and optionally the
// Alg. 3 remap into the next mode's layout, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the in-kernel gather pipeline
// (src/repro/kernels/mttkrp_kernel.py):
//   mttkrp_fused_gather         (:420)   REMAP = false
//   mttkrp_fused_remap          (:517)   REMAP = true
//     (both bodies: _fused_gather_kernel :241)
// What they compute:
//   out_rel[part(b) * rows_pp + lrow_i, :] +=
//       val_i * prod_w F_w[lidx[w, i], :]
// over the alive slots i (lrow_i >= 0) of every block b; with the remap,
// each alive slot's (val, idx, alpha) row is also copied to row
// alpha[i, next] of the next layout, which the wrapper fills with the pad
// pattern before the launch (the TPU kernel did that at grid step 0). The
// compact-schedule pair (with in-block row dedup) is mttkrp_balanced.cu.
//
// Bound on an H100 SXM: bytes. The function must read lrow for the blocks
// it walks, val and lidx of the alive slots and once each factor row that
// an alive slot uses, and write the output tile once; the remap adds idx
// and alpha (N ints each) read and the next layout written (chip_smoke.py
// new_byte_bound). That is far below the 67 TFLOP/s f32 rate, so the floor
// is bytes / 3.35 TB/s.
//
// Design. The rect schedule pads every partition to the hottest one's
// blocks_pp blocks, alive slots first (core/partition.py), so at nell1
// 0.01 ~97% of the slots are pads, and one partition holds ~11% of the
// nonzeros. The host builds a work table (chunk_walk.cuh) that lists only
// each partition's alive extent, ceil(part_nnz / P) blocks from its first,
// cut into chunks of at most `cap` blocks (kernels/mttkrp.py rect_work,
// which checks on the host that every alive slot lies in a listed block);
// the grid is the chunk count and CTA i takes chunk i. A partition with no
// nonzeros keeps one empty chunk, so its tile is still written (zeros). A
// split partition's partial tiles are summed in chunk order by
// mttkrp_balanced_reduce_launch (the wrappers call it). A skipped block
// holds only pads, which neither add to out_rel nor move in the remap.
//   Per block, its lrow, val, lidx (and idx/alpha for the remap) are
// staged by cp.async one block ahead. Once they land, each alive slot's
// own factor rows are copied into the stage (a pad loads nothing), and the
// remap scatter runs from the staged metadata while those rows are in
// flight. A warp then takes a run of consecutive slots, one rank column a
// lane, and sums in a register while lrow repeats (warp_runs).
//
// Shared memory per CTA (4-byte words; a4 rounds up to a multiple of 4):
//   two metadata buffers of 2 a4(P) + (N-1) a4(P) [+ 2 a4(P N) with the
//   remap], one factor-row stage of a4((N-1) P R), and the rows_pp x R
//   accumulator (smem_bytes below). kernels/mttkrp.py gather_smem_bytes is
//   the same formula: the wrapper passes its count and the launch refuses
//   one that differs. It is at most the balanced kernel's, for which
//   ExecutionConfig.resolve_rows_pp sizes rows_pp.

#include "chunk_walk.cuh"

namespace {

// Word offsets of one block's metadata buffer.
struct MetaLayout {
  int lrow, val, lidx, idx, alpha, words, a4p;
  __device__ MetaLayout(int p, int nm1, int n) {
    a4p = a4(p);
    lrow = 0;
    val = a4p;
    lidx = 2 * a4p;
    idx = lidx + nm1 * a4p;
    alpha = idx + (n > 0 ? a4(p * n) : 0);
    words = alpha + (n > 0 ? a4(p * n) : 0);
  }
};

struct Args {
  const float* val;
  const int* lrow;
  const int* lidx;        // (N-1, S)
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
  for (int w = 0; w < a.nm1; ++w) {
    copy_words(m + ml.lidx + w * ml.a4p, a.lidx + w * s + base, p, tid);
  }
  if (REMAP) {
    copy_words(m + ml.idx, a.idx + base * a.nmodes, p * a.nmodes, tid);
    copy_words(m + ml.alpha, a.alpha + base * a.nmodes, p * a.nmodes, tid);
  }
}

// Each alive slot's row of every input factor into the stage (factor w at
// w * P * R, slot s at s * R); pads load nothing.
template <bool VEC>
__device__ __forceinline__ void load_rows(const Args& a, const MetaLayout& ml,
                                          const int* m, float* st, int tid) {
  const int p = a.block_p, r = a.rank;
  const int chunk = VEC ? r >> 2 : r;   // copies per row
  const int* lrow = m + ml.lrow;
  for (int w = 0; w < a.nm1; ++w) {
    const int* li = m + ml.lidx + w * ml.a4p;
    const float* f = a.fac.p[w];
    float* dst = st + w * p * r;
    for (int t = tid; t < p * chunk; t += kThreads) {
      const int s = t / chunk;
      if (lrow[s] < 0) continue;
      const int c = t - s * chunk;
      const float* src = f + static_cast<long long>(li[s]) * r;
      if (VEC) {
        cp_async16(dst + s * r + 4 * c, src + 4 * c);
      } else {
        cp_async4(dst + s * r + c, src + c);
      }
    }
  }
}

// One CTA an SM (the accumulator takes most of the shared memory).
template <bool REMAP, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    mttkrp_gather_kernel(const Args a) {
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
  const int nb = c.b1 - c.b0;
  zero_tile(acc, tile, tid);

  const int lane = tid & 31;
  int i0, i1;
  warp_slots(p, tid >> 5, i0, i1);
  if (nb > 0) load_meta<REMAP>(a, ml, meta, c.b0, tid);
  cp_commit();
  for (int i = 0; i < nb; ++i) {
    const int* m = meta + (i & 1) * ml.words;
    const int* lrow = m + ml.lrow;
    const float* val = reinterpret_cast<const float*>(m + ml.val);
    cp_wait<0>();          // meta(i) has landed
    __syncthreads();       // ... for all; block i - 1 is done everywhere
    load_rows<VEC>(a, ml, m, stage, tid);
    cp_commit();
    if (i + 1 < nb) {
      load_meta<REMAP>(a, ml, meta + ((i + 1) & 1) * ml.words,
                       c.b0 + i + 1, tid);
    }
    cp_commit();
    if (REMAP) {
      remap_scatter(m + ml.idx, m + ml.alpha, val, p, a.nmodes, a.next_mode,
                    a.nval, a.nidx, a.nalpha, tid);
    }
    cp_wait<1>();          // rows(i) have landed
    __syncthreads();

    warp_runs(acc, lrow, val, i0, i1, r, lane, [&](int s, int col) {
      float prod = stage[s * r + col];
      for (int w = 1; w < nm1; ++w) prod *= stage[(w * p + s) * r + col];
      return prod;
    });
  }
  cp_wait<0>();
  __syncthreads();

  write_tile(acc, tile, c, a.out, a.partials, tid);
}

// Shared memory of one CTA (bytes): the layout at the top of this file.
size_t smem_bytes(int rows_pp, int rank, int nm1, int block_p, int nmodes) {
  const int meta_words = (2 + nm1) * a4(block_p) +
                         (nmodes > 0 ? 2 * a4(block_p * nmodes) : 0);
  return 4 * (2 * static_cast<size_t>(meta_words) +
              static_cast<size_t>(a4(nm1 * block_p * rank)) +
              static_cast<size_t>(rows_pp) * rank);
}

template <bool REMAP, bool VEC>
int launch(const Args& a, int nchunks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_gather_kernel<REMAP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mttkrp_gather_kernel<REMAP, VEC><<<nchunks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `factors` is a host array of
// nm1 device pointers; `lidx` the (nm1, S) row table; `work` the
// (nchunks, 4) chunk table on the device; `partials` the
// (n_partials, rows_pp, R) scratch (may be null when n_partials is 0).
// With `alpha == nullptr` the kernel without the remap runs and
// idx/nmodes/next_mode/nval/nidx/nalpha are ignored. `vec` selects 16-byte
// factor-row copies (R % 4 == 0 and every factor 16-byte aligned); `smem`
// is the caller's count of the CTA's shared memory, refused unless it
// equals this file's. Returns the cudaError_t of the launch (0 on
// success); the kernel does not synchronise.
extern "C" int mttkrp_gather_launch(
    const void* val, const void* lrow, const void* lidx, const void* work,
    const void* factors, int nm1, int nchunks, int kappa, int rows_pp,
    int block_p, int rank, int nblocks, int n_partials, int vec, int smem,
    void* out, void* partials, const void* idx, const void* alpha,
    int nmodes, int next_mode, void* nval, void* nidx, void* nalpha,
    void* stream) {
  const bool remap = alpha != nullptr;
  if (nm1 < 1 || nm1 > kMaxInputs || nchunks < 1 || kappa < 1 ||
      block_p < 1 || rank < 1 || rows_pp < 1 ||
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
  a.lidx = i32(lidx);
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
