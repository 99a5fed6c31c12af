// Throughput of wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulators) with
// both operands in shared memory (K-major, no swizzle), as the bf16 DRB
// kernel issues it: chains of k-steps into one accumulator set, each A start
// moved by a tap-like offset, one commit and wait per chain. Built and run by
// tools/wgmma_rate.py; plain C interface for ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSmemBytes = 96 * 1024;

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t desc(uint32_t start16, uint32_t lbo16, uint32_t sbo16) {
  return static_cast<uint64_t>(start16 & 0x3FFF) | (static_cast<uint64_t>(lbo16 & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo16 & 0x3FFF) << 32);
}

// Each warpgroup runs `chains` chains of `steps` k-steps (A moved by 1, 18 or
// 19 positions per step, as taps move it; its core matrices `sbo` 16-byte
// units apart: 8 = contiguous, 6 = overlapping by two rows). out gets one accumulator so that
// nothing is dead code.
template <int N>
__global__ void wgmma_rate_kernel(int chains, int steps, int sbo, float* out) {
  extern __shared__ __align__(128) uint4 smem[];
  for (int i = threadIdx.x; i < kSmemBytes / 16; i += blockDim.x) smem[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) >> 4;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t a0 = base + 64 + 512 * wg;      // A: positions of 16 B, LBO one 324-position plane
  const uint32_t b0 = base + 4096;               // B: the canonical layout, 128 B / 256 B strides
#pragma unroll 1
  for (int c = 0; c < chains; ++c) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
    for (int k = 0; k < steps; k += 9) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * 18 + tap % 3;
        wgmma<N>(acc, desc(a0 + toff, 324, sbo), desc(b0 + tap * N * 2, 8, 16));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += acc[i];
  if (sum != 0.f) out[blockIdx.x] = sum;
}

template <int N>
cudaError_t run(int ctas, int warpgroups, int chains, int steps, int sbo, float* out,
              cudaStream_t stream) {
  const auto fn = wgmma_rate_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  fn<<<ctas, 128 * warpgroups, kSmemBytes, stream>>>(chains, steps, sbo, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wgmma_rate(int n, int ctas, int warpgroups, int chains, int steps, int sbo, void* out,
                          void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16: return run<16>(ctas, warpgroups, chains, steps, sbo, o, st);
    case 32: return run<32>(ctas, warpgroups, chains, steps, sbo, o, st);
    case 48: return run<48>(ctas, warpgroups, chains, steps, sbo, o, st);
    case 64: return run<64>(ctas, warpgroups, chains, steps, sbo, o, st);
    default: return cudaErrorInvalidValue;
  }
}
