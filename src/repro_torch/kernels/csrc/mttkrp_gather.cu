// spMTTKRP elementwise computation (paper Alg. 2/4) on the rect block
// schedule with the factor-row gather inside the kernel, and optionally the
// Alg. 3 remap into the next mode's layout, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the in-kernel gather pipeline
// (src/repro/kernels/mttkrp_kernel.py):
//   mttkrp_fused_gather         (:420)   REMAP = false
//   mttkrp_fused_remap          (:517)   REMAP = true
//     (both bodies: _fused_gather_kernel :241)
// The compact-schedule pair (mttkrp_fused_gather_compact :466 and
// mttkrp_fused_remap_compact :583, with in-block row dedup) is
// csrc/mttkrp_balanced.cu, which also splits long partitions across CTAs.
//
// Design (the paper's own GPU design, not the TPU kernel's block walk):
//   * one thread block (CTA) owns one partition: it walks that partition's
//     run of blocks [pstart[j], pstart[j+1]) (pstart[j] = j * blocks_pp)
//     and keeps the partition's rows_pp x R f32 accumulator in shared
//     memory; every output row is owned by exactly one partition (paper
//     Observation 2), so there are no global atomics and no cross-CTA
//     reduction.
//   * per block it stages every alive slot's own factor row lidx[w, slot]
//     into shared memory at stage position i. A pad slot (lrow < 0) loads
//     no row: on a skewed tensor most rect slots are pads. Each alive slot
//     then adds val_i * prod_w stage_w[i] into row lrow_i with
//     shared-memory atomics;
//   * the remap variant also copies each alive slot's (val, idx, alpha) to
//     row alpha[i, next] of the next layout. The destinations are a
//     permutation of the alive slots, so no atomics are needed. The wrapper
//     fills the next layout with the pad pattern before the launch (the TPU
//     kernel did that at grid step 0; a GPU grid has no step 0).
//   * pad slots (lrow < 0, alpha[i, next] < 0) are skipped before they touch
//     the stage, so stage rows that were not loaded are never read and need
//     no zeroing.
//
// Bound on an H100 SXM: bytes. The function must read lrow for every slot,
// val, lidx and once each factor row that an alive slot uses, and write
// the output tile once; the remap adds idx and alpha (N ints each) read and
// the next layout written (chip_smoke.py new_byte_bound). That is far
// below the 67 TFLOP/s f32 rate, so the floor is bytes / 3.35 TB/s. This
// kernel reads a factor row once per slot that uses it. This first version
// is simple: the stage is filled with plain loads (no cp.async / TMA
// double buffering), and a partition is never split across CTAs, so a mode
// whose hottest row holds a large share of the nonzeros is bound by that
// one CTA's walk, not by the card's bandwidth.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxInputs = 8;   // input factors per launch: nmodes <= 9
constexpr int kThreads = 512;

struct FactorPtrs {
  const float* p[kMaxInputs];
};

template <bool REMAP>
__global__ void __launch_bounds__(kThreads) mttkrp_gather_kernel(
    const float* __restrict__ val, const int* __restrict__ lrow,
    const int* __restrict__ pstart, const int* __restrict__ lidx,
    FactorPtrs fac, int nm1, int rows_pp, int block_p, int rank,
    int nblocks, float* __restrict__ out, const int* __restrict__ idx,
    const int* __restrict__ alpha, int nmodes, int next_mode,
    float* __restrict__ nval, int* __restrict__ nidx,
    int* __restrict__ nalpha) {
  extern __shared__ float smem[];
  const int tile = rows_pp * rank;          // accumulator floats
  const int prow = block_p * rank;          // one factor's stage floats
  float* acc = smem;
  float* stage = smem + tile;
  const long long s = static_cast<long long>(nblocks) * block_p;
  const int part = blockIdx.x;
  const int tid = threadIdx.x;

  for (int t = tid; t < tile; t += kThreads) acc[t] = 0.f;

  const int b0 = pstart[part];
  const int b1 = pstart[part + 1];
  for (int b = b0; b < b1; ++b) {
    const long long base = static_cast<long long>(b) * block_p;
    // The previous block's reads of the stage (and the zeroing of acc) are
    // done before the stage is overwritten.
    __syncthreads();
    for (int w = 0; w < nm1; ++w) {
      const int* ri = lidx + static_cast<long long>(w) * s + base;
      const float* f = fac.p[w];
      float* st = stage + w * prow;
      // Every alive slot stages its own row at position i.
      for (int t = tid; t < prow; t += kThreads) {
        const int i = t / rank;
        const int r = t - i * rank;
        if (lrow[base + i] < 0) continue;
        st[t] = __ldg(f + static_cast<long long>(ri[i]) * rank + r);
      }
    }
    if (REMAP) {
      for (int i = tid; i < block_p; i += kThreads) {
        const long long slot = base + i;
        const int d = alpha[slot * nmodes + next_mode];
        if (d < 0) continue;
        const long long dst = static_cast<long long>(d) * nmodes;
        nval[d] = val[slot];
        for (int m = 0; m < nmodes; ++m) {
          nidx[dst + m] = idx[slot * nmodes + m];
          nalpha[dst + m] = alpha[slot * nmodes + m];
        }
      }
    }
    __syncthreads();
    for (int t = tid; t < prow; t += kThreads) {
      const int i = t / rank;
      const int r = t - i * rank;
      const long long slot = base + i;
      const int lr = lrow[slot];
      if (lr < 0) continue;
      float prod = stage[t];
      for (int w = 1; w < nm1; ++w) prod *= stage[w * prow + t];
      atomicAdd(&acc[lr * rank + r], prod * val[slot]);
    }
  }
  __syncthreads();
  float* o = out + static_cast<long long>(part) * tile;
  for (int t = tid; t < tile; t += kThreads) o[t] = acc[t];
}

template <bool REMAP>
int launch(const float* val, const int* lrow, const int* pstart,
           const int* lidx, const FactorPtrs& fac, int nm1, int kappa,
           int rows_pp, int block_p, int rank, int nblocks, float* out,
           const int* idx, const int* alpha, int nmodes, int next_mode,
           float* nval, int* nidx, int* nalpha, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(rows_pp) * rank +
       static_cast<size_t>(nm1) * block_p * rank) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_gather_kernel<REMAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mttkrp_gather_kernel<REMAP><<<kappa, kThreads, smem, stream>>>(
      val, lrow, pstart, lidx, fac, nm1, rows_pp, block_p, rank, nblocks,
      out, idx, alpha, nmodes, next_mode, nval, nidx, nalpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). `factors` is a host array of
// nm1 device pointers; `lidx` is the (nm1, S) row table. With
// `alpha == nullptr` the kernel without the remap runs and
// idx/alpha/nval/nidx/nalpha/nmodes/next_mode are ignored. Returns the
// cudaError_t of the launch (0 on success); the kernel does not
// synchronise.
extern "C" int mttkrp_gather_launch(
    const void* val, const void* lrow, const void* pstart, const void* lidx,
    const void* factors, int nm1, int kappa, int rows_pp, int block_p,
    int rank, int nblocks, void* out, const void* idx, const void* alpha,
    int nmodes, int next_mode, void* nval, void* nidx, void* nalpha,
    void* stream) {
  if (nm1 < 1 || nm1 > kMaxInputs || kappa < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FactorPtrs fac = {};
  const void* const* fp = static_cast<const void* const*>(factors);
  for (int w = 0; w < nm1; ++w) fac.p[w] = static_cast<const float*>(fp[w]);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = static_cast<const float*>(val);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  if (alpha != nullptr) {
    return launch<true>(f, i32(lrow), i32(pstart), i32(lidx), fac, nm1,
                        kappa, rows_pp, block_p, rank, nblocks,
                        static_cast<float*>(out), i32(idx), i32(alpha),
                        nmodes, next_mode, static_cast<float*>(nval),
                        static_cast<int*>(nidx), static_cast<int*>(nalpha),
                        st);
  }
  return launch<false>(f, i32(lrow), i32(pstart), i32(lidx), fac, nm1, kappa,
                       rows_pp, block_p, rank, nblocks,
                       static_cast<float*>(out), nullptr, nullptr, 0, 0,
                       nullptr, nullptr, nullptr, st);
}
