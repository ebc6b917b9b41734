// spMTTKRP elementwise computation (paper Alg. 2/4) over a pre-gathered
// (S, N-1, R) operand, for Hopper (sm_90a): the fusion comparison baseline
// (paper Fig. 7), where the factor rows were gathered into device memory
// before the kernel runs.
//
// Replaces the two Pallas TPU kernels that share `_ec_compute`
// (src/repro/kernels/mttkrp_kernel.py:78):
//   mttkrp_fused          (:132, body _ec_kernel :112)          rect
//   mttkrp_fused_compact  (:173, body _compact_ec_kernel :119)  compact
// What they compute:
//   out_rel[part(b) * rows_pp + lrow_i, :] +=
//       val_i * prod_w gathered[i, w, :]
// over the alive slots i (lrow_i >= 0) of every block b. The two schedules
// differ only in which partition owns a block, and that is in the work
// table, so one kernel serves both.
//
// Bound on an H100 SXM: bytes. Per alive slot the function must read
// (N-1) x R floats of the operand plus val, lrow for the blocks it walks,
// and write the output tile once: ~260 B per alive slot at N = 3, R = 32,
// against ~96 FLOP, so the floor is bytes / 3.35 TB/s (chip_smoke.py
// new_byte_bound computes it from each run's data).
//
// Design. A hot row makes one partition hold a large share of the blocks
// (~11% of nell1's nonzeros), and every output row is owned by one
// partition (paper Observation 2), so a CTA a partition is bound by that
// partition's walk. As in mttkrp_balanced.cu, the host builds a work table
// of chunks of at most `cap` consecutive blocks of one partition
// (chunk_walk.cuh); the grid is the chunk count, CTA i takes chunk i and
// accumulates it into a rows_pp x R tile in shared memory, and a split
// partition's partial tiles are summed in chunk order by
// mttkrp_balanced_reduce_launch (the wrappers call it). Under rect the
// table lists only each partition's alive extent (its alive slots come
// first), so the pad blocks are never walked.
//   Per block, its lrow and val are staged by cp.async one block ahead;
// once they land, the block's operand rows (contiguous in device memory,
// (N-1) R floats a slot) are copied into the stage, pads skipped. A warp
// then takes a run of consecutive slots, one rank column a lane, and sums
// in a register while lrow repeats (chunk_walk.cuh warp_runs), so the hot
// row costs one shared-memory atomic a run, not 512 threads' atomics on
// the same 32 addresses.
//
// Shared memory per CTA (4-byte words; a4 rounds up to a multiple of 4):
//   two metadata buffers of 2 a4(P) (lrow, val), one operand stage of
//   a4((N-1) P R), and the rows_pp x R accumulator (smem_bytes below).
//   kernels/mttkrp.py pregathered_smem_bytes is the same formula: the
//   wrapper passes its count and the launch refuses one that differs. The
//   stage is the size of the balanced kernel's factor-row stage and its
//   metadata smaller, so the rows_pp that ExecutionConfig.resolve_rows_pp
//   sizes for that kernel fits here too.

#include "chunk_walk.cuh"

namespace {

struct Args {
  const float* gathered;  // (S, N-1, R)
  const float* val;
  const int* lrow;
  const int* work;        // (nchunks, 4): part, b_begin, b_end, partial
  int nm1, kappa, rows_pp, block_p, rank, nblocks, n_partials;
  float* out;             // (kappa * rows_pp, R)
  float* partials;        // (n_partials, rows_pp, R)
};

// One CTA an SM (the accumulator takes most of the shared memory).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    mttkrp_pregathered_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const int p = a.block_p, r = a.rank, nm1 = a.nm1;
  const int a4p = a4(p);
  const int meta_words = 2 * a4p;   // lrow at 0, val at a4p
  const int row = nm1 * r;          // operand floats a slot
  int* meta = smem;                 // two buffers: block i's at (i & 1)
  float* stage = reinterpret_cast<float*>(smem + 2 * meta_words);
  float* acc = stage + a4(p * row);
  const int tile = a.rows_pp * r;

  const Chunk c = chunk_row(a.work, blockIdx.x, a.kappa, a.nblocks,
                            a.n_partials);
  const int nb = c.b1 - c.b0;
  zero_tile(acc, tile, tid);

  auto load_meta = [&](int* m, long long b) {
    copy_words(m, a.lrow + b * p, p, tid);
    copy_words(m + a4p, reinterpret_cast<const int*>(a.val) + b * p, p, tid);
  };
  const int lane = tid & 31;
  int i0, i1;
  warp_slots(p, tid >> 5, i0, i1);
  if (nb > 0) load_meta(meta, c.b0);
  cp_commit();
  for (int i = 0; i < nb; ++i) {
    const int* m = meta + (i & 1) * meta_words;
    const int* lrow = m;
    const float* val = reinterpret_cast<const float*>(m + a4p);
    cp_wait<0>();          // meta(i) has landed
    __syncthreads();       // ... for all; block i - 1 is done everywhere
    // The block's operand, alive slots only: (N-1) R floats a slot.
    const float* src =
        a.gathered + static_cast<long long>(c.b0 + i) * p * row;
    if (VEC) {
      const int q = row >> 2;   // 16-byte copies a slot
      for (int t = tid; t < p * q; t += kThreads) {
        if (lrow[t / q] >= 0) cp_async16(stage + 4 * t, src + 4 * t);
      }
    } else {
      for (int t = tid; t < p * row; t += kThreads) {
        if (lrow[t / row] >= 0) cp_async4(stage + t, src + t);
      }
    }
    cp_commit();
    if (i + 1 < nb) {
      load_meta(meta + ((i + 1) & 1) * meta_words, c.b0 + i + 1);
    }
    cp_commit();
    cp_wait<1>();          // the operand of block i has landed
    __syncthreads();

    warp_runs(acc, lrow, val, i0, i1, r, lane, [&](int s, int col) {
      const float* g = stage + s * row + col;
      float prod = g[0];
      for (int w = 1; w < nm1; ++w) prod *= g[w * r];
      return prod;
    });
  }
  cp_wait<0>();
  __syncthreads();

  write_tile(acc, tile, c, a.out, a.partials, tid);
}

// Shared memory of one CTA (bytes): the layout at the top of this file.
size_t smem_bytes(int rows_pp, int rank, int nm1, int block_p) {
  return 4 * (4 * static_cast<size_t>(a4(block_p)) +
              static_cast<size_t>(a4(nm1 * block_p * rank)) +
              static_cast<size_t>(rows_pp) * rank);
}

template <bool VEC>
int launch(const Args& a, int nchunks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_pregathered_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mttkrp_pregathered_kernel<VEC><<<nchunks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `work` is the (nchunks, 4)
// chunk table on the device, `partials` the (n_partials, rows_pp, R)
// scratch (may be null when n_partials is 0). `vec` selects 16-byte
// operand copies ((N-1) R % 4 == 0 and `gathered` 16-byte aligned);
// `smem` is the caller's count of the CTA's shared memory, refused unless
// it equals this file's. Returns the cudaError_t of the launch (0 on
// success); the kernel does not synchronise.
extern "C" int mttkrp_pregathered_launch(
    const void* gathered, const void* val, const void* lrow,
    const void* work, int nm1, int nchunks, int kappa, int rows_pp,
    int block_p, int rank, int nblocks, int n_partials, int vec, int smem,
    void* out, void* partials, void* stream) {
  if (nm1 < 1 || nchunks < 1 || kappa < 1 || block_p < 1 || rank < 1 ||
      rows_pp < 1 ||
      static_cast<size_t>(smem) != smem_bytes(rows_pp, rank, nm1, block_p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.gathered = static_cast<const float*>(gathered);
  a.val = static_cast<const float*>(val);
  a.lrow = static_cast<const int*>(lrow);
  a.work = static_cast<const int*>(work);
  a.nm1 = nm1;
  a.kappa = kappa;
  a.rows_pp = rows_pp;
  a.block_p = block_p;
  a.rank = rank;
  a.nblocks = nblocks;
  a.n_partials = n_partials;
  a.out = static_cast<float*>(out);
  a.partials = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(a, nchunks, smem, st)
             : launch<false>(a, nchunks, smem, st);
}
