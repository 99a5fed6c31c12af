// Fused DenseResidualBlock (DRB) forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel downgan_tpu/ops/pallas/drb.py::drb_forward
// (pallas_call at drb.py:120). One DRB is five 3x3 SAME convs over growing
// channel concatenations:
//
//   stage s (s = 1..5) reads concat(x, out_1 .. out_{s-1})  (s*F channels)
//   and writes F channels plus bias; stages 1-4 apply LeakyReLU(0.01);
//   the block output is out_5 * 0.2 + x.
//
// Bound on this card: operations. At F = 16 and 16x16 a sample needs
// sum_s 2*9*(s*F)*F*H*W = 17.69 MFLOP against 2*F*H*W*4 = 32 KB of
// activations in and out (plus 138 KB of weights shared by the batch), so
// fp32 FMA throughput, not HBM, is the limit.
//
// Design (the simple first version):
//   * one thread block per sample. The block keeps the sample's whole
//     five-stage concat buffer, 5F channels of (H+2) x (W+2) with a zero
//     border that realises the SAME padding, so the concat never touches
//     HBM. A florida patch needs 18*18*80*4 = 103,680 B of shared memory,
//     which lets two blocks share an SM. When the buffer does not fit in
//     shared memory (a domain band), it lives in a global scratch buffer
//     the wrapper allocates; a block's slice stays hot in L1/L2.
//   * one thread per output pixel (strided over H*W), holding all F output
//     channels in registers; __syncthreads() between stages.
//   * weights are packed once per weight set (see drb.py) as
//     [stage][ci][tap][co] with co innermost, so a thread reads F/4 float4s
//     per (ci, tap); every thread of a warp reads the same address, which
//     the read-only path serves as a broadcast.
//   * fp32 FMA accumulation. Tensor cores (wgmma), TMA and spatial tiling
//     across blocks are left for later work.
//
// The entry points have a plain C interface (bound with ctypes), launch on
// the caller's stream, never synchronise and allocate nothing.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr float kSlope = 0.01f;     // torch nn.LeakyReLU() default
constexpr float kResScale = 0.2f;

template <int F, bool kShared>
__global__ void __launch_bounds__(kThreads)
drb_kernel(const float* __restrict__ x, const float* __restrict__ wpack,
           float* __restrict__ out, float* __restrict__ scratch, int H, int W) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int Wp = W + 2;
  const int plane = (H + 2) * Wp;
  const int HW = H * W;
  float* acts = kShared ? reinterpret_cast<float*>(smem4)
                        : scratch + static_cast<size_t>(b) * (5 * F) * plane;
  const float* xb = x + static_cast<size_t>(b) * F * HW;
  float* ob = out + static_cast<size_t>(b) * F * HW;

  // Channels [0, F) take x in the interior; the border of every channel is
  // the zero padding. Interiors of channels [F, 5F) are written by stages.
  for (int i = threadIdx.x; i < 5 * F * plane; i += blockDim.x) {
    const int c = i / plane;
    const int r = i - c * plane;
    const int py = r / Wp;
    const int px = r - py * Wp;
    float v = 0.f;
    if (c < F && py >= 1 && py <= H && px >= 1 && px <= W) {
      v = xb[c * HW + (py - 1) * W + (px - 1)];
    }
    acts[i] = v;
  }
  __syncthreads();

  const float* wstage = wpack;
  const float* bias = wpack + 9 * F * F * 15;  // after the five stages
#pragma unroll 1
  for (int s = 0; s < 5; ++s) {
    const int cin = (s + 1) * F;
    const float4* w4 = reinterpret_cast<const float4*>(wstage);
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {
      const int y = p / W;
      const int xq = p - y * W;
      float acc[F];
#pragma unroll
      for (int co = 0; co < F; ++co) acc[co] = __ldg(bias + s * F + co);
      const float* a0 = acts + y * Wp + xq;  // window's top-left, padded coords
#pragma unroll 2
      for (int ci = 0; ci < cin; ++ci) {
        const float* a = a0 + ci * plane;
        const float4* wc = w4 + ci * 9 * (F / 4);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float v = a[(t / 3) * Wp + (t % 3)];
#pragma unroll
          for (int q = 0; q < F / 4; ++q) {
            const float4 wv = __ldg(wc + t * (F / 4) + q);
            acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
          }
        }
      }
      if (s < 4) {
        float* o = acts + cin * plane + (y + 1) * Wp + (xq + 1);
#pragma unroll
        for (int co = 0; co < F; ++co) {
          const float r = acc[co];
          o[co * plane] = r >= 0.f ? r : kSlope * r;
        }
      } else {
#pragma unroll
        for (int co = 0; co < F; ++co) {
          ob[co * HW + p] = fmaf(acc[co], kResScale, xb[co * HW + p]);
        }
      }
    }
    wstage += 9 * F * cin;
    __syncthreads();
  }
}

size_t buffer_bytes(int F, int H, int W) {
  return static_cast<size_t>(5) * F * (H + 2) * (W + 2) * sizeof(float);
}

int shared_limit() {
  int dev = 0;
  int limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return limit;
}

template <int F>
cudaError_t launch(const float* x, const float* w, float* out, float* scratch,
                   int B, int H, int W, cudaStream_t stream) {
  if (scratch != nullptr) {
    drb_kernel<F, false><<<B, kThreads, 0, stream>>>(x, w, out, scratch, H, W);
    return cudaGetLastError();
  }
  const size_t smem = buffer_bytes(F, H, W);
  const cudaError_t e = cudaFuncSetAttribute(
      drb_kernel<F, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  drb_kernel<F, true><<<B, kThreads, smem, stream>>>(x, w, out, nullptr, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of global scratch the launch needs: 0 when the concat buffer fits
// in the current device's shared memory, else B * 5F * (H+2) * (W+2).
// Negative when the device cannot be queried.
long long drb_scratch_floats(int B, int F, int H, int W) {
  const int limit = shared_limit();
  if (limit < 0) return -1;
  if (buffer_bytes(F, H, W) <= static_cast<size_t>(limit)) return 0;
  return static_cast<long long>(B) * 5 * F * (H + 2) * (W + 2);
}

// out = DRB(x). x, out: (B, F, H, W) contiguous fp32 on the current device;
// wpack: the packed weights of drb.py::pack_drb_weights; scratch: null, or
// drb_scratch_floats(...) floats. Returns a cudaError_t (0 = launched).
int drb_forward_f32(const void* x, const void* wpack, void* out, void* scratch,
                    int B, int F, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wpack);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 8:
      return launch<8>(xf, wf, of, sf, B, H, W, st);
    case 16:
      return launch<16>(xf, wf, of, sf, B, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* drb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
