// What one shared-memory load or shuffle costs an SM, by the pattern of
// addresses a warp's lanes read: the numbers the design of csrc/wkv6.cu
// rests on (which lanes of a warp may share a float4 of r, k and w).
//
// One CTA of 32 warps on each SM runs ITERS rounds of 8 independent
// loads (or shuffles); each loaded value is folded into the thread's
// accumulators with one FADD for two floats and one LOP3 for the other
// two (two pipes, ~1 SM-cycle a warp-load together), so a pattern that
// costs more than that shows its own cost. Prints SM-cycles per warp
// instruction (clock64 around the loop, the slowest CTA), and the f32
// pipe's issue rate with 2, 3 and 8 warps on each scheduler.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o smem_patterns \
//       experiments/smem_patterns.cu && ./smem_patterns
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kWarps = 32;
constexpr int kIters = 4096;

// Float offset (a multiple of 4) that lane `lane` reads, by pattern.
__device__ __forceinline__ int offset(int pattern, int lane) {
  switch (pattern) {
    case 0: return 0;                     // one address for the warp
    case 1: return 4 * (lane / 16);       // 2 addresses, a half-warp each
    case 2: return 4 * (lane / 8);        // 4 addresses, a quarter-warp each
    case 3: return 4 * (lane % 4);        // 4 addresses, lanes interleaved
    case 4: return 4 * (lane % 8);        // 8 addresses, lanes interleaved
    case 5: return 4 * lane;              // 32 addresses, 512 contiguous bytes
    default: return lane;                 // 32 floats, 128 contiguous bytes
  }
}

template <int W>
__global__ void loads(int pattern, unsigned long long* cycles, float* sink) {
  __shared__ __align__(16) float sm[8 * 512 + 128];
  for (int i = threadIdx.x; i < 8 * 512 + 128; i += blockDim.x) sm[i] = i;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int off = offset(pattern, lane);
  float a = 0.f;
  unsigned c = 0;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
    const int base = (it & 7) * 4 + off;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float* p = sm + base + q * 512;
      if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        a += v.x + v.y;
        c ^= __float_as_uint(v.z) ^ __float_as_uint(v.w);
      } else {
        const float v = *p;
        a += v;
      }
    }
  }
  __syncthreads();
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0) atomicMax(cycles, t1 - t0);
  if (a == 1.2345f || c == 7u) sink[threadIdx.x] = a;
}

// 16 independent FFMA chains a thread: the f32 pipe's issue rate at a
// given number of warps a scheduler.
__global__ void ffmas(unsigned long long* cycles, float* sink) {
  float a[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) a[q] = threadIdx.x + q;
  const float m = 1.0001f, c = 0.5f;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int q = 0; q < 16; ++q) a[q] = fmaf(a[q], m, c);
  }
  __syncthreads();
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0) atomicMax(cycles, t1 - t0);
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) t += a[q];
  if (t == 1.2345f) sink[threadIdx.x] = t;
}

__global__ void shuffles(int stride, unsigned long long* cycles, float* sink) {
  float a = threadIdx.x;
  const unsigned long long t0 = clock64();
  for (int it = 0; it < kIters; ++it) {
    float s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      s[q] = __shfl_xor_sync(0xffffffffu, a + q, (q % stride) + 1);
#pragma unroll
    for (int q = 0; q < 8; ++q) a += s[q];
  }
  __syncthreads();
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0) atomicMax(cycles, t1 - t0);
  if (a == 1.2345f) sink[threadIdx.x] = a;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  unsigned long long* cyc;
  float* sink;
  cudaMalloc(&cyc, sizeof(unsigned long long));
  cudaMalloc(&sink, 4096 * sizeof(float));
  const char* names[] = {"1 address", "2 (half-warps)", "4 (quarter-warps)",
                         "4 (lane % 4)", "8 (lane % 8)", "32 (contiguous)"};
  auto run = [&](auto launch, const char* what, double per_round) {
    unsigned long long h = 0;
    for (int rep = 0; rep < 2; ++rep) {   // the first is a warm-up
      cudaMemset(cyc, 0, sizeof h);
      launch();
      cudaDeviceSynchronize();
    }
    cudaMemcpy(&h, cyc, sizeof h, cudaMemcpyDeviceToHost);
    printf("%-28s %.3f SM-cycles a warp instruction\n", what,
           double(h) / (double(kWarps) * kIters * per_round));
  };
  for (int p = 0; p < 6; ++p) {
    char what[64];
    snprintf(what, sizeof what, "LDS.128, %s", names[p]);
    run([&] { loads<4><<<sms, 32 * kWarps>>>(p, cyc, sink); }, what, 8);
  }
  run([&] { loads<1><<<sms, 32 * kWarps>>>(0, cyc, sink); },
      "LDS.32, 1 address", 8);
  run([&] { loads<1><<<sms, 32 * kWarps>>>(6, cyc, sink); },
      "LDS.32, 32 (contiguous)", 8);
  run([&] { shuffles<<<sms, 32 * kWarps>>>(4, cyc, sink); },
      "SHFL.BFLY", 8);
  for (int warps : {8, 12, 32}) {
    unsigned long long h = 0;
    for (int rep = 0; rep < 2; ++rep) {
      cudaMemset(cyc, 0, sizeof h);
      ffmas<<<sms, 32 * warps>>>(cyc, sink);
      cudaDeviceSynchronize();
    }
    cudaMemcpy(&h, cyc, sizeof h, cudaMemcpyDeviceToHost);
    printf("FFMA, %2d warps an SM        %.3f warp instructions a cycle a "
           "scheduler\n", warps, double(warps) / 4 * kIters * 16 / double(h));
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err != cudaSuccess;
}
