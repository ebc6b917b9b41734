// spMTTKRP elementwise computation (paper Alg. 2/4) over a pre-gathered
// (S, N-1, R) operand, for Hopper (sm_90a): the fusion comparison baseline
// (paper Fig. 7), where the factor rows were gathered into device memory
// before the kernel runs.
//
// Replaces the two Pallas TPU kernels that share `_ec_compute`
// (src/repro/kernels/mttkrp_kernel.py:78):
//   mttkrp_fused          (:132, body _ec_kernel :112)          rect
//   mttkrp_fused_compact  (:173, body _compact_ec_kernel :119)  compact
//
// Design (the paper's own GPU design, not the TPU kernel's block walk):
//   * one thread block (CTA) owns one partition: it walks that partition's
//     run of blocks [pstart[j], pstart[j+1]) and keeps the partition's
//     rows_pp x R f32 accumulator in shared memory, zeroed at CTA start
//     (the TPU kernels zero the tile at the partition's first grid step);
//     every output row is owned by exactly one partition (paper
//     Observation 2), so there are no global atomics. The two schedules
//     differ only in pstart (rect: pstart[j] = j * blocks_pp), so one
//     kernel serves both;
//   * the operand stays in device memory, as the baseline intends: each
//     alive slot's thread group reads gathered[slot, w, :] directly
//     (neighbouring threads on neighbouring rank lanes, so the reads
//     coalesce) and adds val * prod_w into row lrow with shared-memory
//     atomics. Pad slots (lrow < 0) are skipped before any operand load.
//
// Bound on an H100 SXM: bytes. Per alive slot the function must read
// (N-1) x R floats of the operand plus val, and lrow for every slot, and
// write the output tile once: ~260 B per alive slot at N = 3, R = 32,
// against ~96 FLOP, so the floor is bytes / 3.35 TB/s (chip_smoke.py
// computes it from each run's data). This first version is simple: a
// partition is never split across CTAs, so a mode whose hottest row holds
// a large share of the nonzeros is bound by that one CTA's walk.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) mttkrp_pregathered_kernel(
    const float* __restrict__ gathered, const float* __restrict__ val,
    const int* __restrict__ lrow, const int* __restrict__ pstart, int nm1,
    int rows_pp, int block_p, int rank, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int tile = rows_pp * rank;
  const int prow = block_p * rank;
  const int part = blockIdx.x;
  const int tid = threadIdx.x;

  for (int t = tid; t < tile; t += kThreads) acc[t] = 0.f;
  __syncthreads();

  const int b0 = pstart[part];
  const int b1 = pstart[part + 1];
  for (int b = b0; b < b1; ++b) {
    const long long base = static_cast<long long>(b) * block_p;
    for (int t = tid; t < prow; t += kThreads) {
      const int i = t / rank;
      const int r = t - i * rank;
      const long long slot = base + i;
      const int lr = lrow[slot];
      if (lr < 0) continue;
      const float* g = gathered + slot * nm1 * rank + r;
      float prod = __ldg(g);
      for (int w = 1; w < nm1; ++w) prod *= __ldg(g + w * rank);
      atomicAdd(&acc[lr * rank + r], prod * val[slot]);
    }
  }
  __syncthreads();
  float* o = out + static_cast<long long>(part) * tile;
  for (int t = tid; t < tile; t += kThreads) o[t] = acc[t];
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch (0 on success); the kernel does not synchronise.
extern "C" int mttkrp_pregathered_launch(
    const void* gathered, const void* val, const void* lrow,
    const void* pstart, int nm1, int kappa, int rows_pp, int block_p,
    int rank, void* out, void* stream) {
  if (nm1 < 1 || kappa < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows_pp) * rank * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mttkrp_pregathered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mttkrp_pregathered_kernel<<<kappa, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gathered), static_cast<const float*>(val),
      static_cast<const int*>(lrow), static_cast<const int*>(pstart), nm1,
      rows_pp, block_p, rank, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
