// Fused DenseResidualBlock (DRB) forward for Hopper (sm_90a): fp32 in and out
// (drb_kernel, below) and bf16 in and out (drb_kernel_bf16, further down).
//
// Replaces the Pallas TPU kernel downgan_tpu/ops/pallas/drb.py::drb_forward
// (lines 104-128, pallas_call at :120). One DRB is five 3x3 SAME convs over
// growing channel concatenations:
//
//   stage s (s = 1..5) reads concat(x, out_1 .. out_{s-1})  (s*F channels)
//   and writes F channels plus bias; stages 1-4 apply LeakyReLU(0.01);
//   the block output is out_5 * 0.2 + x.    NCHW, F in {8, 16}, any B, H, W.
//
// What bounds it on this card: the tensor cores' TF32 rate. A sample of
// H*W pixels needs sum_s 2*9*(s*F)*F*H*W FLOP (17.69 MFLOP at F = 16,
// 16x16) against 2*F*H*W*4 B of activations in and out. At B = 150 a launch
// is 2.654 GFLOP and 5.05 MB (plus 277 KB of packed weights). Run as three
// TF32 products (below) its floor is 3 * 2.654 GFLOP / 495 TFLOP/s (H100
// SXM) = 0.0161 ms; the bytes take 0.0016 ms at 3.35 TB/s. (The same FLOP
// as scalar fp32 FMAs would take 0.0396 ms at 67 TFLOP/s.)
//
// Design.
//  * Implicit GEMM on the tensor cores. Stage s is a product with
//    M = the stage's output pixels in the tile, N = F, K = 9*s*F. One
//    k-step is 8 input channels at one tap (dy, dx); its A fragment is read
//    straight from the zero-bordered, channel-planar concat in shared memory
//    (pixel offset + tap offset), so the im2col exists only in addresses.
//  * 3xTF32, for fp32 fidelity. a = a_hi + a_lo and b = b_hi + b_lo, each
//    part TF32-exact: hi = rna(v) (cvt.rna.tf32.f32 rounding) and, for the
//    weights, lo = rna(v - hi); for the activations lo = v - hi goes to the
//    MMA as fp32, which reads it truncated to TF32 (split_tf32 below). The
//    kernel accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32 and drops
//    a_lo*b_lo (~2^-22 of a product). That keeps a block within 1e-5 of the
//    fp32 twin; plain TF32 (~2^-11 per operand) does not, and the serving
//    path promises fp32 with TF32 off. The weights are split once, on the
//    host (drb.py::pack_drb_weights), straight into the fragment order the
//    MMA reads; activations are split in registers as they are loaded.
//  * mma.sync.m16n8k8 (tf32) rather than wgmma. wgmma reads B from shared
//    memory in its canonical layout, so the stage's weights (hi and lo, up to
//    92 KB at stage 5) would have to be staged there, which breaks the
//    two-CTAs-per-SM budget below at the serving shape; with N = F = 16 a
//    wgmma m64n16k8 is also a small instruction, and the 3xTF32 split builds
//    the A operand in registers either way. wgmma is left to a later design.
//  * Work units: one CTA per (sample, 16x16 output tile). Stage s is
//    computed over the tile grown by 5 - s pixels on each side, clipped to
//    the image (halo recompute): for an interior tile stage 1 covers 24x24,
//    stage 4 18x18 and stage 5 writes 16x16, so no part of the concat ever
//    leaves shared memory and one code path serves every shape. An image of
//    at most 16x16 (florida) is one tile: every rectangle clips to the image,
//    the SAME border is the zero ring, and nothing is recomputed.
//  * Shared memory: group j (x for j = 0, out_j for j = 1..4) holds F planes
//    of rows_j x pitch floats covering (tile grown by 5 - j) clipped to the
//    image grown by 1, zero outside the image. rows_j = min(16 + 2(5 - j),
//    H + 2); the row pitch is 18 for images at most 16 wide (one tile
//    across) and 26 otherwise, for every group, a template argument so that
//    each tap offset is an immediate; columns past the image are zeros. Each
//    plane's stride is padded to 8 mod 32 floats so the fragment's 4
//    channels x 8 pixels hit 32 distinct banks.
//      florida (F=16, 16x16): 5 groups x 16 x 328 floats = 104,960 B;
//      interior tile of a band: 16 x (680+648+584+520+488) floats = 186,880 B.
//  * Weights stay out of shared memory: the B fragments (hi and lo of b0, b1
//    for a lane, one float4) are read with ld.global.nc in the order the
//    k-steps consume them. The 8 warps of a CTA read the same k-step, so L1
//    serves them, and the whole packed set (276 KB at F = 16) stays in L2
//    for every CTA. That is what lets two florida CTAs share an SM
//    (2 x (104,960 + 1,024 reserved) B <= 228 KB).
//  * CTAs per SM and waves. (150,16,16,16): 150 units, 2 CTAs per SM, so
//    264 slots and one wave; 18 SMs hold two samples and 114 hold one. The
//    tail is left to the pairing: one 8-warp CTA cannot keep an SM's tensor
//    pipes busy on its own (mma.sync latency over 4 independent accumulators
//    a warp), so an SM running two units takes less than twice as long as
//    one (1.76x on the H100, PERF.md). Half-sample tiles would cut the worst
//    SM from 2 to 1.75 samples of work at 1.17x recompute, and 8-row tiles
//    measured slower (PERF.md); a 2-CTA cluster exchanging rows through
//    distributed shared memory would cut it to 1.5 without recompute but
//    with a cluster barrier per stage and half the warps of each CTA idle at
//    16x16, and is left open.
//    (8,16,32,112), a domain band: 8 x 2 x 7 = 112 units, one CTA per SM
//    (186,880 B), one wave on 112 of 132 SMs.
//  * Warps: 8 per CTA. A warp owns pairs of m-tiles (32 pixels) and the
//    whole N and K of a stage, so each thread holds 2 x F/8 accumulators of
//    4 floats and no reduction crosses warps.
//  * Asynchronous copies: the x tile with its halo is copied to shared
//    memory with cp.async (4-byte copies: a halo'd tile starts at any
//    column) while the threads zero the out groups. __syncthreads() runs
//    only after the copy and at the five stage ends.
//  * No explicit weight prefetch. The fragment loads of a group's 9 * F/8
//    k-steps sit in one unrolled body, and the compiler schedules them
//    ahead of the MMAs that use them as registers allow (126 of the 128
//    that two CTAs per SM leave). Loading each k-step's fragments one step
//    ahead into registers measured 1-5 % slower, and loading only each
//    group's first k-step ahead (across the loop the compiler does not
//    unroll) 2-13 % slower (PERF.md). Double-buffering them in shared
//    memory does not fit two florida CTAs per SM.
//
// The bf16 variant (drb_kernel_bf16, entry drb_forward_bf16) computes the
// block of the generator's bf16 compute path (hp.compute_dtype "bfloat16"):
// x, weights and biases bf16; each stage sums its 9 taps x s*F channels and
// the bias in fp32 and rounds the stage output to bf16 once; LeakyReLU is
// applied to that bf16 value in fp32 and rounded to bf16 (the value kept in
// the concat); the block output is out_5 * 0.2 + x in fp32 (multiply, then
// add: no FMA contraction) from the bf16 out_5 and x, rounded to bf16 once.
// drb.py::drb_forward_reference computes the same function, so the two
// differ only by fp32 summation order.
//  * Bound: the tensor cores' bf16 rate. 2.654 GFLOP at B = 150 over the
//    H100 SXM's dense 989 TFLOP/s is 0.0027 ms; x and out in bf16 (2.46 MB)
//    plus 69 KB of packed weights take 0.0007 ms at 3.35 TB/s. B = 128 and
//    a band (8,16,32,112) give ~0.0023 and ~0.0020 ms.
//  * One mma.sync.m16n8k16 (bf16 in, fp32 accumulators) per k-step of 16
//    channels where the fp32 kernel issues three m16n8k8 TF32 products per
//    8 channels. At F = 8 a group has only 8 channels, so that instance
//    takes m16n8k8 (bf16) k-steps of 8 channels instead of padding K.
//  * The A fragment holds two adjacent channels per 32-bit register, so the
//    concat is stored channel-pair-planar: each group is F/2 planes of
//    bf16x2 words (channels 2p and 2p+1 of one pixel in one word, the lower
//    channel in the low half), and one ld.shared.b32 fills a register. The
//    plane stride is padded to 8 mod 32 words, so a fragment's 4 pairs x 8
//    pixels hit 32 distinct banks, as in the fp32 kernel. Half the fp32
//    kernel's bytes: florida 5 x 8 x 328 words = 52,480 B a CTA; an interior
//    band tile 93,440 B.
//  * The stage epilogue writes a thread's two adjacent output channels as
//    one bf16x2 word. x is loaded with plain loads (its two channels of a
//    word lie in two NCHW planes, so cp.async cannot pair them).
//  * Units, halo recompute, warps and the frame geometry are the fp32
//    kernel's. Weights (bf16, packed once per weight set by
//    drb.py::pack_drb_weights_bf16 in the order the B fragments are read)
//    stay in global memory and L1/L2: 69,120 B at F = 16.
//
// The entry points have a plain C interface (bound with ctypes), launch on
// the caller's stream, never synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;  // output tile rows
constexpr int kTileW = 16;  // output tile columns
constexpr int kHalo = 5;   // stage s covers the tile grown by kHalo - s
constexpr float kSlope = 0.01f;  // torch nn.LeakyReLU() default
constexpr float kResScale = 0.2f;

struct Geometry {
  int H, W;
  int tiles_x, tiles_per_sample;
  int pitch;  // row pitch of every group's planes: 18 (W <= 16) or 26
};

// Plane stride for n floats, padded to 8 mod 32 (bank spread, 32-B aligned).
__host__ __device__ __forceinline__ int plane_stride(int n) {
  return n + (8 - n % 32 + 32) % 32;
}

// Rows held for group j (0 = x, 1..4 = out_j).
__host__ __device__ __forceinline__ int group_rows(int j, int H) {
  const int grown = kTileH + 2 * (kHalo - j);
  return grown < H + 2 ? grown : H + 2;
}

// hi = v rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32 for every finite v, in two integer operations (cvt.rna
// lowers to a longer sequence that also guards NaN). lo = v - hi is exact in
// fp32 and goes to the MMA as it is: the tensor core reads its top 19 bits,
// i.e. truncates it to TF32, an error below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a * b for one m16n8k8 tf32 tile (PTX fragment layouts).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// kPitch = g.pitch at compile time, so every tap offset is an immediate.
template <int F, int kPitch>
__global__ void __launch_bounds__(kThreads, 2)
drb_kernel(const float* __restrict__ x, const float4* __restrict__ wfrag,
           const float* __restrict__ bias, float* __restrict__ out, Geometry g) {
  constexpr int NT = F / 8;  // n-tiles of 8 output channels = 8-channel chunks per group
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);

  const int H = g.H, W = g.W, HW = H * W;
  constexpr int P = kPitch;
  const int b = blockIdx.x / g.tiles_per_sample;
  const int tile = blockIdx.x - b * g.tiles_per_sample;
  const int ty0 = (tile / g.tiles_x) * kTileH;
  const int tx0 = (tile % g.tiles_x) * kTileW;
  const float* xb = x + static_cast<size_t>(b) * F * HW;
  float* ob = out + static_cast<size_t>(b) * F * HW;
  // The frame: group 0's rectangle starts at (fy0, fx0); every group shares
  // its pitch and column origin, and group j starts at row oy_j >= fy0.
  const int fy0 = max(ty0 - kHalo, -1);
  const int fx0 = max(tx0 - kHalo, -1);

  // x with its halo (zero outside the image) by cp.async; out groups zeroed.
  const int rows0 = group_rows(0, H);
  const int plane0 = plane_stride(rows0 * P);
  for (int i = threadIdx.x; i < F * rows0 * P; i += kThreads) {
    const int c = i / (rows0 * P);
    const int r = i - c * rows0 * P;
    const int gy = fy0 + r / P;
    const int gx = fx0 + r % P;
    float* dst = sm + c * plane0 + r;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      cp_async4(dst, xb + c * HW + gy * W + gx);
    } else {
      *dst = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  {
    int total = F * plane0;
    for (int j = 1; j < 5; ++j) total += F * plane_stride(group_rows(j, H) * P);
    for (int i = F * plane0 / 4 + threadIdx.x; i < total / 4; i += kThreads) {
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // thread in group

  const float4* wstage = wfrag + lane;
#pragma unroll 1
  for (int s = 1; s <= 5; ++s) {
    // The stage's output rectangle: tile grown by 5 - s, clipped to the image.
    const int e = kHalo - s;
    const int cy0 = max(ty0 - e, 0), cy1 = min(ty0 + kTileH + e, H);
    const int cx0 = max(tx0 - e, 0), cx1 = min(tx0 + kTileW + e, W);
    const int wc = cx1 - cx0;
    const int m_total = (cy1 - cy0) * wc;
    const int ksteps = 9 * s * NT;

    // Where the stage's output group lives (s < 5).
    int out_off = 0;
    for (int j = 0; j < s; ++j) out_off += F * plane_stride(group_rows(j, H) * P);
    const int out_plane = plane_stride(group_rows(s, H) * P);
    const int out_shift = (max(ty0 - (kHalo - s), -1) - fy0) * P;

#pragma unroll 1
    for (int pair = warp; pair * 32 < m_total; pair += kWarps) {
      // Frame offsets (pix) and image offsets (gpix) of the thread's 4 rows.
      int pix[2][2], gpix[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = pair * 32 + mt * 16 + h * 8 + gq;
          m = m < m_total ? m : m_total - 1;  // rows past the end compute, never store
          const int y = cy0 + m / wc;
          const int xx = cx0 + m % wc;
          pix[mt][h] = (y - fy0) * P + (xx - fx0);
          gpix[mt][h] = y * W + xx;
        }
      }
      float acc[2][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = __ldg(bias + (s - 1) * F + nt * 8 + 2 * tq);
        const float b1 = __ldg(bias + (s - 1) * F + nt * 8 + 2 * tq + 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] = b0;
          acc[mt][nt][1] = b1;
          acc[mt][nt][2] = b0;
          acc[mt][nt][3] = b1;
        }
      }

      const float4* wp = wstage;
      int goff = 0;
#pragma unroll 1
      for (int j = 0; j < s; ++j) {
        const int plane = plane_stride(group_rows(j, H) * P);
        const int gbase = goff - (max(ty0 - (kHalo - j), -1) - fy0) * P;
#pragma unroll
        for (int cc = 0; cc < NT; ++cc) {
          const float* ch0 = sm + gbase + (cc * 8 + tq) * plane;  // channel tq of the chunk
          const float* ch4 = ch0 + 4 * plane;                   // channel tq + 4
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int toff = (tap / 3 - 1) * P + (tap % 3 - 1);
            float4 wv[NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) wv[nt] = __ldg(wp + nt * 32);
            wp += NT * 32;
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              split_tf32(ch0[pix[mt][0] + toff], ah[mt][0], al[mt][0]);
              split_tf32(ch0[pix[mt][1] + toff], ah[mt][1], al[mt][1]);
              split_tf32(ch4[pix[mt][0] + toff], ah[mt][2], al[mt][2]);
              split_tf32(ch4[pix[mt][1] + toff], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint32_t bh0 = __float_as_uint(wv[nt].x);
              const uint32_t bh1 = __float_as_uint(wv[nt].y);
              const uint32_t bl0 = __float_as_uint(wv[nt].z);
              const uint32_t bl1 = __float_as_uint(wv[nt].w);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_tf32(acc[mt][nt], al[mt], bh0, bh1);  // small terms first
                mma_tf32(acc[mt][nt], ah[mt], bl0, bl1);
                mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
              }
            }
          }
        }
        goff += F * plane;
      }

      // Epilogue: c0, c1 at (row gq, cols 2tq, 2tq+1); c2, c3 at row gq + 8.
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r >> 1;
          if (pair * 32 + mt * 16 + h * 8 + gq >= m_total) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int co = nt * 8 + 2 * tq + (r & 1);
            const float v = acc[mt][nt][r];
            if (s < 5) {
              sm[out_off + co * out_plane + pix[mt][h] - out_shift] =
                  v >= 0.f ? v : kSlope * v;
            } else {
              ob[co * HW + gpix[mt][h]] = fmaf(v, kResScale, sm[co * plane0 + pix[mt][h]]);
            }
          }
        }
      }
    }
    wstage += ksteps * NT * 32;
    __syncthreads();
  }
}

Geometry make_geometry(int H, int W) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.tiles_x = (W + kTileW - 1) / kTileW;
  g.tiles_per_sample = g.tiles_x * ((H + kTileH - 1) / kTileH);
  g.pitch = W <= kTileW ? kTileW + 2 : kTileW + 2 * kHalo;
  return g;
}

size_t smem_bytes(int F, const Geometry& g) {
  size_t floats = 0;
  for (int j = 0; j < 5; ++j) floats += static_cast<size_t>(F) * plane_stride(group_rows(j, g.H) * g.pitch);
  return floats * sizeof(float);
}

using KernelFn = void (*)(const float*, const float4*, const float*, float*, Geometry);

template <int F>
cudaError_t launch(const float* x, const float* wpack, float* out, int B, int H, int W,
                   cudaStream_t stream) {
  const Geometry g = make_geometry(H, W);
  const size_t smem = smem_bytes(F, g);
  const long long units = static_cast<long long>(B) * g.tiles_per_sample;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const KernelFn fn = g.pitch == kTileW + 2 ? drb_kernel<F, kTileW + 2>
                                             : drb_kernel<F, kTileW + 2 * kHalo>;
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const float4* wfrag = reinterpret_cast<const float4*>(wpack);
  const float* bias = wpack + 2 * 9 * F * F * 15;  // after the five stages' fragments
  fn<<<static_cast<unsigned>(units), kThreads, smem, stream>>>(x, wfrag, bias, out, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16

// d += a * b, m16n8k16 (KC = 16: a[0..3], b[0..1]) or m16n8k8 (KC = 8: a[0..1],
// b[0]), bf16 operands, fp32 accumulators (PTX fragment layouts).
template <int KC>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a, const uint32_t* b);

template <>
__device__ __forceinline__ void mma_bf16<16>(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma_bf16<8>(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

// The fragment words of one k-step for one lane: WPL = 4 (F = 16) as one
// 16-byte load, WPL = 1 (F = 8) as one 4-byte load.
template <int WPL>
__device__ __forceinline__ void load_bfrag(uint32_t (&w)[WPL], const uint32_t* p) {
  if constexpr (WPL == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    static_assert(WPL == 1, "F = 8 or 16");
    w[0] = __ldg(p);
  }
}

// kPitch = g.pitch at compile time, as in drb_kernel. Shared memory holds
// 32-bit words: group j is F/2 pair planes of plane_stride(rows_j * kPitch).
template <int F, int kPitch>
__global__ void __launch_bounds__(kThreads, 2)
drb_kernel_bf16(const unsigned short* __restrict__ x, const uint32_t* __restrict__ wfrag,
                const float* __restrict__ bias, unsigned short* __restrict__ out, Geometry g) {
  constexpr int KC = F >= 16 ? 16 : 8;  // channels per k-step
  constexpr int CPG = F / KC;           // k-steps per group and tap
  constexpr int NT = F / 8;             // n-tiles of 8 output channels
  constexpr int WPL = NT * KC / 8;      // fragment words per lane and k-step
  constexpr int PAIRS = F / 2;          // pair planes per group
  constexpr int AREGS = KC / 4;         // A registers per m-tile
  extern __shared__ uint4 smem_bf16[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem_bf16);

  const int H = g.H, W = g.W, HW = H * W;
  constexpr int P = kPitch;
  const int b = blockIdx.x / g.tiles_per_sample;
  const int tile = blockIdx.x - b * g.tiles_per_sample;
  const int ty0 = (tile / g.tiles_x) * kTileH;
  const int tx0 = (tile % g.tiles_x) * kTileW;
  const unsigned short* xb = x + static_cast<size_t>(b) * F * HW;
  unsigned short* ob = out + static_cast<size_t>(b) * F * HW;
  const int fy0 = max(ty0 - kHalo, -1);
  const int fx0 = max(tx0 - kHalo, -1);

  // x with its halo as bf16x2 words (zero outside the image); out groups zeroed.
  const int rows0 = group_rows(0, H);
  const int plane0 = plane_stride(rows0 * P);
  {
    int total = PAIRS * plane0;
    for (int j = 1; j < 5; ++j) total += PAIRS * plane_stride(group_rows(j, H) * P);
    for (int i = threadIdx.x; i < total; i += kThreads) {
      uint32_t v = 0u;
      if (i < PAIRS * plane0) {
        const int p = i / plane0;
        const int r = i - p * plane0;
        const int gy = fy0 + r / P;
        const int gx = fx0 + r % P;
        if (r < rows0 * P && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const unsigned short* src = xb + (2 * p) * HW + gy * W + gx;
          v = static_cast<uint32_t>(__ldg(src)) | (static_cast<uint32_t>(__ldg(src + HW)) << 16);
        }
      }
      sm[i] = v;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  const uint32_t* wstage = wfrag + lane * WPL;
#pragma unroll 1
  for (int s = 1; s <= 5; ++s) {
    const int e = kHalo - s;
    const int cy0 = max(ty0 - e, 0), cy1 = min(ty0 + kTileH + e, H);
    const int cx0 = max(tx0 - e, 0), cx1 = min(tx0 + kTileW + e, W);
    const int wc = cx1 - cx0;
    const int m_total = (cy1 - cy0) * wc;
    const int ksteps = 9 * s * CPG;

    int out_off = 0;
    for (int j = 0; j < s; ++j) out_off += PAIRS * plane_stride(group_rows(j, H) * P);
    const int out_plane = plane_stride(group_rows(s, H) * P);
    const int out_shift = (max(ty0 - (kHalo - s), -1) - fy0) * P;

#pragma unroll 1
    for (int pair = warp; pair * 32 < m_total; pair += kWarps) {
      int pix[2][2], gpix[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = pair * 32 + mt * 16 + h * 8 + gq;
          m = m < m_total ? m : m_total - 1;  // rows past the end compute, never store
          const int y = cy0 + m / wc;
          const int xx = cx0 + m % wc;
          pix[mt][h] = (y - fy0) * P + (xx - fx0);
          gpix[mt][h] = y * W + xx;
        }
      }
      float acc[2][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = __ldg(bias + (s - 1) * F + nt * 8 + 2 * tq);
        const float b1 = __ldg(bias + (s - 1) * F + nt * 8 + 2 * tq + 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] = b0;
          acc[mt][nt][1] = b1;
          acc[mt][nt][2] = b0;
          acc[mt][nt][3] = b1;
        }
      }

      const uint32_t* wp = wstage;
      int goff = 0;
#pragma unroll 1
      for (int j = 0; j < s; ++j) {
        const int plane = plane_stride(group_rows(j, H) * P);
        const int gbase = goff - (max(ty0 - (kHalo - j), -1) - fy0) * P;
#pragma unroll
        for (int cc = 0; cc < CPG; ++cc) {
          const uint32_t* p0 = sm + gbase + (cc * (KC / 2) + tq) * plane;  // channels 2tq, 2tq+1
          const uint32_t* p4 = p0 + 4 * plane;                           // channels 2tq+8, +9
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int toff = (tap / 3 - 1) * P + (tap % 3 - 1);
            uint32_t bw[WPL];
            load_bfrag<WPL>(bw, wp);
            wp += 32 * WPL;
            uint32_t a[2][AREGS];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              a[mt][0] = p0[pix[mt][0] + toff];
              a[mt][1] = p0[pix[mt][1] + toff];
              if constexpr (KC == 16) {
                a[mt][2] = p4[pix[mt][0] + toff];
                a[mt][3] = p4[pix[mt][1] + toff];
              }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16<KC>(acc[mt][nt], a[mt], bw + nt * (KC / 8));
              }
            }
          }
        }
        goff += PAIRS * plane;
      }

      // Epilogue: a thread holds channels co = nt*8 + 2tq and co + 1 (pair
      // nt*4 + tq) at rows gq (acc[..][0..1]) and gq + 8 (acc[..][2..3]).
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pair * 32 + mt * 16 + h * 8 + gq >= m_total) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int pr = nt * 4 + tq;
            // The stage output, rounded to bf16 once.
            const float2 o = __bfloat1622float2(
                __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
            if (s < 5) {
              const float y0 = o.x >= 0.f ? o.x : kSlope * o.x;
              const float y1 = o.y >= 0.f ? o.y : kSlope * o.y;
              sm[out_off + pr * out_plane + pix[mt][h] - out_shift] =
                  bf16x2_bits(__floats2bfloat162_rn(y0, y1));
            } else {
              const float2 xv = bf16x2_to_float2(sm[pr * plane0 + pix[mt][h]]);
              const __nv_bfloat162 r = __floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(o.x, kResScale), xv.x),
                  __fadd_rn(__fmul_rn(o.y, kResScale), xv.y));
              const uint32_t bits = bf16x2_bits(r);
              ob[(2 * pr) * HW + gpix[mt][h]] = static_cast<unsigned short>(bits & 0xFFFFu);
              ob[(2 * pr + 1) * HW + gpix[mt][h]] = static_cast<unsigned short>(bits >> 16);
            }
          }
        }
      }
    }
    wstage += ksteps * 32 * WPL;
    __syncthreads();
  }
}

size_t smem_bytes_bf16(int F, const Geometry& g) {
  size_t words = 0;
  for (int j = 0; j < 5; ++j) words += static_cast<size_t>(F / 2) * plane_stride(group_rows(j, g.H) * g.pitch);
  return words * sizeof(uint32_t);
}

using KernelFnBf16 = void (*)(const unsigned short*, const uint32_t*, const float*, unsigned short*,
                              Geometry);

template <int F>
cudaError_t launch_bf16(const void* x, const void* wpack, void* out, int B, int H, int W,
                        cudaStream_t stream) {
  const Geometry g = make_geometry(H, W);
  const size_t smem = smem_bytes_bf16(F, g);
  const long long units = static_cast<long long>(B) * g.tiles_per_sample;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const KernelFnBf16 fn = g.pitch == kTileW + 2 ? drb_kernel_bf16<F, kTileW + 2>
                                                 : drb_kernel_bf16<F, kTileW + 2 * kHalo>;
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const uint32_t* wfrag = static_cast<const uint32_t*>(wpack);
  const float* bias = reinterpret_cast<const float*>(wfrag + 9 * F * F * 15 / 2);
  fn<<<static_cast<unsigned>(units), kThreads, smem, stream>>>(
      static_cast<const unsigned short*>(x), wfrag, bias, static_cast<unsigned short*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = DRB(x). x, out: (B, F, H, W) contiguous fp32 on the current device;
// wpack: the packed weights of drb.py::pack_drb_weights, 16-byte aligned.
// Returns a cudaError_t (0 = launched).
int drb_forward_f32(const void* x, const void* wpack, void* out, int B, int F, int H, int W,
                    void* stream) {
  if (B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wpack);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 8:
      return launch<8>(xf, wf, of, B, H, W, st);
    case 16:
      return launch<16>(xf, wf, of, B, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out = DRB(x) in bf16. x, out: (B, F, H, W) contiguous bf16 on the current
// device; wpack: the packed weights of drb.py::pack_drb_weights_bf16 (bf16x2
// fragment words, then the biases as fp32), 16-byte aligned.
int drb_forward_bf16(const void* x, const void* wpack, void* out, int B, int F, int H, int W,
                     void* stream) {
  if (B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 8:
      return launch_bf16<8>(x, wpack, out, B, H, W, st);
    case 16:
      return launch_bf16<16>(x, wpack, out, B, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* drb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
