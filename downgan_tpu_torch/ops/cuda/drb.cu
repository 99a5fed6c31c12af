// Fused DenseResidualBlock (DRB) forward for Hopper (sm_90a): fp32 in and out
// (drb_kernel, below) and bf16 in and out (drb_kernel_bf16, further down);
// ESRGAN's wide block in fp32 (drb_kernel_wide); and the fp32 block's
// backward at 16x16 (drb_backward_kernel and drb_grad_reduce, at the end).
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
//    a band (8,16,32,112) give ~0.0023 and ~0.0020 ms. With N = F = 16
//    every bf16 operand of A feeds only 16 products: a wgmma m64n16k16 with
//    both operands in shared memory takes ~22.5 SM clocks, 38 % of the
//    bf16 peak, where m64n48k16 takes ~31.3 (83 %) and m64n64k16 ~35.8
//    (97 %) (tools/wgmma_rate.py on the H100; PERF.md).
//  * What held the first bf16 kernel back (mma.sync.m16n8k16 on the fp32
//    kernel's frame, stored channel-pair planar): 8 ld.shared.b32 and a 16-byte
//    ld.global.nc of B fragments per warp and k-step feeding 4 small MMAs,
//    every warp reading a stage's whole weight set, 2-byte x loads.
//  * wgmma, A and B in shared memory, K-major, no swizzle. The concat is a
//    channel-last frame: each 8-channel slice of each group is a plane of
//    16-byte positions (one pixel's 8 channels), so every position is a row
//    of a core matrix and a kernel row's shift is the A descriptor's start
//    address moved by dy * pitch positions: the im2col exists only in the
//    descriptor. LBO steps from a k16 chunk's first slice to its second (a
//    group's second slice at F = 16; the next group's slice, or a zero
//    slice at odd s, at F = 8).
//  * The three dx taps side by side in N (N = 3F: m64n48k16 at F = 16,
//    m64n24k16 at F = 8) instead of one wgmma m64n16k16 per tap: a third of
//    the instructions at over twice the rate. The dx shift then applies to
//    the output rows: core matrices step 6 positions (SBO = 96 B), so each
//    covers 8 positions and its rows 1..6 are outputs whose -1 and +1
//    neighbours are in the same core matrix, 4 lanes away in the
//    accumulator layout (two shuffles per value). An M-tile of 64 rows
//    gives 48 outputs; the frame's pitch pad columns are computed and
//    dropped: 6 M-tiles a florida stage. (SBO 6 reads as fast as 8 in
//    tools/wgmma_rate.py.)
//  * One chain of 3 * chunks k-steps per stage and M-tile, one commit and
//    wait. The chunk loop is unrolled (a loop measured 16 % slower); 2
//    warpgroups a CTA (3 measured 9 % slower); two accumulator sets in turn,
//    the next tile's chain issued before an epilogue, measured 27 % slower
//    (ptxas serializes the wgmmas then). tools/drb_bf16_variants.py.
//  * Weights by bulk copies (cp.async.bulk, 1-D TMA) on mbarriers, double
//    buffered: buffer A holds stages 1, 3, 5 (23,040 B at F = 16), buffer B
//    stages 2, 4 (18,432 B); stages 1, 2 and the biases load at the start,
//    stage s + 2 right after stage s. The host packs them in wgmma's
//    canonical B layout (drb.py::pack_drb_weights), so a stage is one copy.
//  * x by bulk copies too, one per channel (or per channel row of a
//    halo'd tile) into the out groups' part of the frame, then transposed
//    into group 0 from shared memory with 16-byte reads: x costs ~1.2 us of
//    a ~16 us launch at B = 128. Rows that are not 16-byte aligned
//    (W % 8 != 0) use 2-byte loads.
//  * Stage outputs go from the accumulators into the frame as bf16x2 words,
//    behind fence.proxy.async; the block output is staged channel-planar in
//    buffer B and written with 16-byte stores.
//  * Units and halo recompute are the fp32 kernel's: one CTA per (sample,
//    16x16 tile). Shared memory: florida (F = 16, 16x16) 94,688 B, 2 CTAs
//    per SM; an interior band tile 134,368 B, 1 CTA per SM. At B = 150, 18
//    SMs run two samples (0.0222 ms against 0.0160 at B = 132; PERF.md).
//
// The wide variant (drb_kernel_wide, entry drb_forward_f32_wide) computes
// ESRGAN's dense block (Wang et al. 2018, RRDBNet_arch.py: nf = 64, gc = 32)
// at 16x16 in fp32: stage s reads 64 + 32(s - 1) channels and writes 32
// (stage 5: 192 -> 64), LeakyReLU(0.2), out = out_5 * 0.2 + x. It replaces no
// TPU kernel: the JAX package has no such block. Same arithmetic as
// drb_kernel (3xTF32 mma.sync.m16n8k8, the weights packed by the same
// pack_drb_weights, read with ld.global.nc); another frame.
//  * Bound: 122.7 MFLOP a sample, 15.70 GFLOP at B = 128: three TF32
//    passes take 0.0952 ms at 495 TFLOP/s; x and out (16.8 MB) plus 1.9 MB
//    of packed weights take 0.0056 ms at 3.35 TB/s.
//  * Why drb_kernel's frame does not serve: it keeps a sample's whole
//    concat with a zero ring in shared memory, 192 planes x 328 floats =
//    251,904 B, over the 232,448 B a block may have. Here a plane holds only
//    a zero row above and below the 16 image rows (pitch 16, 296 floats with
//    the 8 mod 32 pad): 192 planes and a 32-float guard are 227,456 B, one
//    CTA (one sample) per SM. The missing zero columns become two masks: a
//    tap with dx = -1 at column 0 or dx = +1 at column 15 reads the
//    neighbouring row's end, so those operands are zeroed in registers
//    (lane gq = 0 of the left taps, gq = 7 of the right; the guard keeps the
//    read of pixel (0, 0)'s top-left tap inside shared memory).
//  * Units and warps: one CTA per sample, so B = 128 is one wave on 128 of
//    132 SMs. 8 warps; warp w owns image rows 2w and 2w + 1 (two m-tiles)
//    and the whole N of a stage (4 n-tiles, 8 at stage 5: 32 and 64 fp32
//    accumulators a thread). A k-step of a warp reads 8 A values from
//    shared memory and N/8 B float4s from L1 for 6 N/8 MMAs.
//  * Growth 32 is four 8-channel chunks, so the concat's planes are one
//    uniform array and a stage's K loop runs over 8 + 4(s - 1) chunks
//    without regard to groups.

// The entry points have a plain C interface (bound with ctypes), launch on
// the caller's stream, never synchronise and allocate nothing.

#include <cooperative_groups.h>
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

constexpr int kWarpgroups = 2;
constexpr int kThreadsBf16 = 128 * kWarpgroups;
constexpr int kMTile = 64;     // wgmma's M rows: 8 core matrices of 8 frame positions
constexpr int kCoreStep = 6;   // positions between core matrices (the A descriptor's SBO)
constexpr int kMOut = 8 * kCoreStep;  // output positions per M-tile: rows 1..6 of each core matrix
constexpr int kGuard = kMTile;        // zeroed positions after the frame's last plane
constexpr int kStagePlane = kTileH * kTileW + 8;  // bf16 per channel of the output staging

// k16 chunks of stage s's concat (s*F channels; F = 8 pads odd s with the
// zero slice) and the bytes of its packed weights (drb.py::pack_drb_weights:
// per chunk and kernel row one k-step of 3F x 16 bf16).
__host__ __device__ __forceinline__ int bf16_chunks(int F, int s) { return (s * F + 15) / 16; }
__host__ __device__ __forceinline__ int stage_bytes_bf16(int F, int s) {
  return bf16_chunks(F, s) * 3 * 3 * F * 16 * 2;
}
__host__ __device__ __forceinline__ int stage_offset_bf16(int F, int s) {  // stage s's first byte
  int off = 0;
  for (int t = 1; t < s; ++t) off += stage_bytes_bf16(F, t);
  return off;
}

// The frame, in 16-byte positions (8 channels each): group j's F/8 slices
// of rows_j x pitch positions, in order; at F = 8 a zero slice of group 0's
// size; then kGuard zero positions. group_base is slice 0's first position.
__host__ __device__ __forceinline__ int group_base(int j, int F, int H, int P) {
  int pos = 0;
  for (int i = 0; i < j; ++i) pos += (F / 8) * group_rows(i, H) * P;
  return pos;
}

__host__ __device__ __forceinline__ int frame_positions(int F, int H, int P) {
  return group_base(5, F, H, P) + (F == 8 ? group_rows(0, H) * P : 0) + kGuard;
}

// Shared memory: the frame, weight buffer A (stages 1, 3, 5), weight
// buffer B (stages 2, 4, then the block output's staging), three mbarriers
// (odd stages' weights and the biases, even stages' weights, x), the five
// stages' biases (fp32). x arrives NCHW in the out groups' part of the
// frame, which is zeroed only once x has moved into group 0.
struct SmemBf16 {
  int buf_a, buf_b, bars, bias, total;  // byte offsets; total bytes
};

__host__ __device__ __forceinline__ SmemBf16 smem_layout_bf16(int F, int H, int P) {
  SmemBf16 L;
  L.buf_a = frame_positions(F, H, P) * 16;
  L.buf_b = L.buf_a + stage_bytes_bf16(F, 5);
  const int b_bytes = stage_bytes_bf16(F, 4);
  const int staging = F * kStagePlane * 2;
  L.bars = L.buf_b + (b_bytes > staging ? b_bytes : staging);
  L.bias = L.bars + 32;
  L.total = L.bias + 5 * F * 4;
  return L;
}

// A K-major, no-swizzle wgmma descriptor: start address, LBO (the step
// between the two 8-element K halves of a k16 operand) and SBO (the step
// between 8-row core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc_strides(uint32_t lbo16, uint32_t sbo16) {
  return (static_cast<uint64_t>(lbo16 & 0x3FFF) << 16) | (static_cast<uint64_t>(sbo16 & 0x3FFF) << 32);
}

__device__ __forceinline__ uint64_t desc_at(uint64_t strides, uint32_t start16) {
  return strides | static_cast<uint64_t>(start16 & 0x3FFF);
}

// d += A * B for A 64x16 and B (3F)x16, both K-major bf16 in shared memory
// (N = 3F: the three dx taps of a kernel row side by side), d in fp32
// registers: row 16*warp + gq + 8h, column 8*nb + 2*tq + {0, 1} in
// d[4*nb + 2*h + {0, 1}].
template <int F>
__device__ __forceinline__ void wgmma_bf16(float (&d)[3 * F / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[12], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its results land at wgmma_wait, not at the asm).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The arrival of one thread that expects ``bytes`` of bulk copies on ``bar``.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// ``bytes`` from global to shared memory by one bulk copy (1-D TMA),
// completing on ``bar``. Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}


__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

// kPitch = g.pitch at compile time, as in drb_kernel. vec_io: W % 8 == 0 and
// x and out 16-byte aligned, so 8 pixels of a row move as one 16-byte word.
template <int F, int kPitch>
__global__ void __launch_bounds__(kThreadsBf16, 2)
drb_kernel_bf16(const unsigned short* __restrict__ x, const uint8_t* __restrict__ wpack,
                const float* __restrict__ bias, unsigned short* __restrict__ out, Geometry g,
                int vec_io) {
  constexpr int NSL = F / 8;      // 8-channel slices per group (column blocks per dx)
  constexpr int NACC = 3 * F / 2; // accumulators per thread: 64 x 3F over 128 threads
  constexpr int P = kPitch;
  extern __shared__ __align__(128) uint4 smem_bf16[];
  uint32_t* sm32 = reinterpret_cast<uint32_t*>(smem_bf16);

  const int H = g.H, W = g.W, HW = H * W;
  const int b = blockIdx.x / g.tiles_per_sample;
  const int tile = blockIdx.x - b * g.tiles_per_sample;
  const int ty0 = (tile / g.tiles_x) * kTileH;
  const int tx0 = (tile % g.tiles_x) * kTileW;
  const unsigned short* xb = x + static_cast<size_t>(b) * F * HW;
  unsigned short* ob = out + static_cast<size_t>(b) * F * HW;
  // Positions q count from group 0's origin (fy0, fx0); group j holds q at
  // position slice0(j) + i * rows_j * P + q of its slice i.
  const int fy0 = max(ty0 - kHalo, -1);
  const int fx0 = max(tx0 - kHalo, -1);
  auto slice0 = [&](int j) {
    return group_base(j, F, H, P) - (max(ty0 - (kHalo - j), -1) - fy0) * P;
  };

  const SmemBf16 L = smem_layout_bf16(F, H, P);
  const uint32_t frame_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bf16));
  // Weight buffer and mbarrier 0 serve the odd stages, 1 the even ones.
  auto buf_s = [&](int i) { return frame_s + (i ? L.buf_b : L.buf_a); };
  auto bar_s = [&](int i) { return frame_s + L.bars + 8 * i; };

  // x's rows as the frame needs them: rows [r_lo, r_hi), columns [c_first,
  // c_end) widened to whole 16-byte words.
  const int rows0 = group_rows(0, H);
  const int r_lo = max(fy0, 0), r_hi = min(fy0 + rows0, H);
  const int c_lo = max(fx0, 0), c_hi = min(fx0 + P, W);
  const int c_first = c_lo & ~7;
  const int c_end = min((c_hi + 7) & ~7, W);
  const int xrows = r_hi - r_lo, xpitch = c_end - c_first;
  const bool rows_contiguous = c_first == 0 && c_end == W;  // a channel's rows are one block
  unsigned short* x_in = reinterpret_cast<unsigned short*>(smem_bf16 + group_base(1, F, H, P));

  if (threadIdx.x == 0) {
    mbar_init(bar_s(0), 1);
    mbar_init(bar_s(1), 1);
    mbar_init(bar_s(2), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Stages 1 and 2 and the biases in flight from the start; x's bytes
    // expected before any thread issues its copies.
    mbar_expect(bar_s(0), stage_bytes_bf16(F, 1) + 5 * F * 4);
    bulk_copy(buf_s(0), wpack, stage_bytes_bf16(F, 1), bar_s(0));
    bulk_copy(frame_s + L.bias, bias, 5 * F * 4, bar_s(0));
    mbar_expect(bar_s(1), stage_bytes_bf16(F, 2));
    bulk_copy(buf_s(1), wpack + stage_offset_bf16(F, 2), stage_bytes_bf16(F, 2), bar_s(1));
    if (vec_io) mbar_expect(bar_s(2), F * xrows * xpitch * 2);
  }
  __syncthreads();
  if (vec_io) {  // x by bulk copies: one per channel, or per channel row
    const uint32_t dst0 = frame_s + group_base(1, F, H, P) * 16;
    const int copies = rows_contiguous ? F : F * xrows;
    for (int i = threadIdx.x; i < copies; i += kThreadsBf16) {
      const int ch = rows_contiguous ? i : i / xrows;
      const int r = rows_contiguous ? 0 : i - ch * xrows;
      const int n = rows_contiguous ? xrows : 1;
      bulk_copy(dst0 + ((ch * xrows + r) * xpitch) * 2, xb + ch * HW + (r_lo + r) * W + c_first,
                n * xpitch * 2, bar_s(2));
    }
  }
  // Group 0 zeroed (its SAME ring), and the zero slice and the guard.
  const int g1 = group_base(1, F, H, P), g5 = group_base(5, F, H, P);
  for (int i = threadIdx.x; i < g1; i += kThreadsBf16) smem_bf16[i] = make_uint4(0, 0, 0, 0);
  for (int i = g5 + threadIdx.x; i < frame_positions(F, H, P); i += kThreadsBf16) {
    smem_bf16[i] = make_uint4(0, 0, 0, 0);
  }
  if (vec_io) mbar_wait(bar_s(2), 0);
  __syncthreads();
  // x into group 0, channel-last: a thread takes 8 channels x 8 pixels of a
  // row, transposes them in registers and stores 8 positions of 16 bytes.
  {
    const int chunks = xpitch / 8 + (vec_io ? 0 : 1);  // unaligned rows: one chunk more
    const int items = NSL * xrows * chunks;
    for (int it = threadIdx.x; it < items; it += kThreadsBf16) {
      const int sl = it / (xrows * chunks);
      const int rest = it - sl * xrows * chunks;
      const int r = rest / chunks;
      const int gx0 = c_first + 8 * (rest - r * chunks);
      uint32_t v[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (vec_io) {  // from the NCHW copy in shared memory
          const uint4 u = *reinterpret_cast<const uint4*>(x_in + ((8 * sl + c) * xrows + r) * xpitch +
                                                          gx0 - c_first);
          v[c][0] = u.x;
          v[c][1] = u.y;
          v[c][2] = u.z;
          v[c][3] = u.w;
        } else {  // straight from global memory, 2 bytes at a time
          const unsigned short* row = xb + (8 * sl + c) * HW + (r_lo + r) * W;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gx = gx0 + 2 * e;
            const uint32_t lo = gx < W ? __ldg(row + gx) : 0u;
            const uint32_t hi = gx + 1 < W ? __ldg(row + gx + 1) : 0u;
            v[c][e] = lo | (hi << 16);
          }
        }
      }
      uint4* row_frame = smem_bf16 + sl * rows0 * P + (r_lo + r - fy0) * P;  // group 0 starts at 0
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gx = gx0 + e;
        if (gx < c_lo || gx >= c_hi) continue;
        const uint32_t sel = (e & 1) ? 0x7632u : 0x5410u;
        row_frame[gx - fx0] = make_uint4(__byte_perm(v[0][e >> 1], v[1][e >> 1], sel),
                                         __byte_perm(v[2][e >> 1], v[3][e >> 1], sel),
                                         __byte_perm(v[4][e >> 1], v[5][e >> 1], sel),
                                         __byte_perm(v[6][e >> 1], v[7][e >> 1], sel));
      }
    }
  }
  __syncthreads();
  // The out groups zeroed, x's copy with them.
  for (int i = g1 + threadIdx.x; i < g5; i += kThreadsBf16) smem_bf16[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  // Warp-uniform by construction (a shuffle from lane 0): branches on it
  // keep the wgmma chains out of what ptxas treats as divergent code, where
  // it would serialize them.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int warp = (threadIdx.x >> 5) & 3;  // warp within the warpgroup: M rows 16*warp ..
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const uint64_t b_strides = desc_strides(128 / 16, 256 / 16);
  unsigned short* staging = reinterpret_cast<unsigned short*>(smem_bf16) + L.buf_b / 2;
  const float* bias_sm = reinterpret_cast<const float*>(smem_bf16) + L.bias / 4;

#pragma unroll 1
  for (int s = 1; s <= 5; ++s) {
    const int buf = (s - 1) & 1;
    mbar_wait(bar_s(buf), ((s - 1) >> 1) & 1);
    const int e = kHalo - s;
    const int cy0 = max(ty0 - e, 0), cy1 = min(ty0 + kTileH + e, H);
    const int cx0 = max(tx0 - e, 0), cx1 = min(tx0 + kTileW + e, W);
    const int q0 = (cy0 - fy0) * P + (cx0 - fx0);
    const int ntiles = ((cy1 - 1 - fy0) * P + (cx1 - 1 - fx0) - q0) / kMOut + 1;
    const int nch = bf16_chunks(F, s);
    const uint32_t b0 = buf_s(buf) >> 4;
    const int out0 = slice0(s);  // s < 5: where out_s's slice 0 keeps q
    const int out_plane = group_rows(s, H) * P;

#pragma unroll 1
    for (int t = wg; t < ntiles; t += kWarpgroups) {
      // M-tile t: one chain of 3 * nch k-steps (chunk, kernel row), one
      // commit group. Core matrix j covers positions m_first + 6j .. + 7;
      // its rows 1..6 are outputs, rows 0 and 7 their dx = -1 and +1
      // neighbours.
      const int m_first = q0 - 1 + t * kMOut;
      float acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
      for (int nb = 0; nb < NSL; ++nb) {  // the bias rides in the dx = 1 columns
        const float2 bv = *reinterpret_cast<const float2*>(bias_sm + (s - 1) * F + nb * 8 + 2 * tq);
        acc[4 * (NSL + nb)] = acc[4 * (NSL + nb) + 2] = bv.x;
        acc[4 * (NSL + nb) + 1] = acc[4 * (NSL + nb) + 3] = bv.y;
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < (F == 16 ? 5 : 3); ++c) {  // unrolled: a loop measured 16 % slower
        if (c >= nch) break;
        int a_start, lbo;
        if constexpr (F == 16) {  // chunk c = group c's two slices
          a_start = slice0(c);
          lbo = group_rows(c, H) * P;
        } else {  // groups 2c and 2c + 1, or 2c and the zero slice
          a_start = slice0(2 * c);
          lbo = (2 * c + 1 < s ? slice0(2 * c + 1) : group_base(5, F, H, P)) - a_start;
        }
        const uint64_t a_strides = desc_strides(lbo, kCoreStep);
        const uint32_t a0 = (frame_s >> 4) + a_start + m_first;
        const uint32_t bc = b0 + c * 3 * (6 * F);  // a k-step of B is 6F 16-byte rows
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          wgmma_bf16<F>(acc, desc_at(a_strides, a0 + (dy - 1) * P), desc_at(b_strides, bc + dy * 6 * F));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      // out(row r) = dx=1 columns of row r + dx=0 columns of row r - 1 + dx=2
      // columns of row r + 1: rows r -+ 1 sit 4 lanes away (gq -+ 1).
      float o[2][NSL][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nb = 0; nb < NSL; ++nb) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float left = __shfl_up_sync(0xffffffffu, acc[4 * nb + 2 * h + i], 4);
            const float right = __shfl_down_sync(0xffffffffu, acc[4 * (2 * NSL + nb) + 2 * h + i], 4);
            o[h][nb][i] = acc[4 * (NSL + nb) + 2 * h + i] + left + right;
          }
        }
      }
      if (gq != 0 && gq != 7) {  // rows 0 and 7 of a core matrix are neighbours only
        // Epilogue: positions in the stage's rectangle are kept; pitch pad
        // columns and positions past its end were computed and are dropped.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = m_first + kCoreStep * (2 * warp + h) + gq;
          const int fy = q / P;
          const int oy = fy0 + fy;
          const int ox = fx0 + (q - fy * P);
          if (oy < cy0 || oy >= cy1 || ox < cx0 || ox >= cx1) continue;
#pragma unroll
          for (int nb = 0; nb < NSL; ++nb) {
            // The stage output, rounded to bf16 once.
            const float2 r = __bfloat1622float2(__floats2bfloat162_rn(o[h][nb][0], o[h][nb][1]));
            if (s < 5) {
              const float y0 = r.x >= 0.f ? r.x : kSlope * r.x;
              const float y1 = r.y >= 0.f ? r.y : kSlope * r.y;
              sm32[(out0 + nb * out_plane + q) * 4 + tq] = bf16x2_bits(__floats2bfloat162_rn(y0, y1));
            } else {
              const float2 xv = bf16x2_to_float2(sm32[(nb * rows0 * P + q) * 4 + tq]);
              const uint32_t res = bf16x2_bits(__floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(r.x, kResScale), xv.x), __fadd_rn(__fmul_rn(r.y, kResScale), xv.y)));
              unsigned short* st =
                  staging + (8 * nb + 2 * tq) * kStagePlane + (oy - ty0) * kTileW + ox - tx0;
              st[0] = static_cast<unsigned short>(res & 0xFFFFu);
              st[kStagePlane] = static_cast<unsigned short>(res >> 16);
            }
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && s + 2 <= 5) {  // the buffer just read takes stage s + 2
      mbar_expect(bar_s(buf), stage_bytes_bf16(F, s + 2));
      bulk_copy(buf_s(buf), wpack + stage_offset_bf16(F, s + 2), stage_bytes_bf16(F, s + 2), bar_s(buf));
    }
  }

  // The block output, staged channel-planar, out to NCHW.
  const int rows_out = min(ty0 + kTileH, H) - ty0;
  const int cols_out = min(tx0 + kTileW, W) - tx0;
  if (vec_io) {  // cols_out is a multiple of 8
    const int per_row = cols_out / 8;
    for (int i = threadIdx.x; i < F * rows_out * per_row; i += kThreadsBf16) {
      const int co = i / (rows_out * per_row);
      const int rem = i - co * rows_out * per_row;
      const int r = rem / per_row;
      const int c8 = 8 * (rem - r * per_row);
      *reinterpret_cast<uint4*>(ob + co * HW + (ty0 + r) * W + tx0 + c8) =
          *reinterpret_cast<const uint4*>(staging + co * kStagePlane + r * kTileW + c8);
    }
  } else {
    for (int i = threadIdx.x; i < F * rows_out * cols_out; i += kThreadsBf16) {
      const int co = i / (rows_out * cols_out);
      const int rem = i - co * rows_out * cols_out;
      const int r = rem / cols_out;
      const int c = rem - r * cols_out;
      ob[co * HW + (ty0 + r) * W + tx0 + c] = staging[co * kStagePlane + r * kTileW + c];
    }
  }
}

using KernelFnBf16 = void (*)(const unsigned short*, const uint8_t*, const float*, unsigned short*,
                              Geometry, int);

template <int F>
KernelFnBf16 kernel_bf16(const Geometry& g) {
  return g.pitch == kTileW + 2 ? drb_kernel_bf16<F, kTileW + 2> : drb_kernel_bf16<F, kTileW + 2 * kHalo>;
}

template <int F>
cudaError_t launch_bf16(const void* x, const void* wpack, void* out, int B, int H, int W,
                        cudaStream_t stream) {
  const Geometry g = make_geometry(H, W);
  const size_t smem = smem_layout_bf16(F, H, g.pitch).total;
  const long long units = static_cast<long long>(B) * g.tiles_per_sample;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wpack) % 16) return cudaErrorMisalignedAddress;  // bulk copies
  const KernelFnBf16 fn = kernel_bf16<F>(g);
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const uint8_t* wbytes = static_cast<const uint8_t*>(wpack);
  int wtotal = 0;
  for (int s = 1; s <= 5; ++s) wtotal += stage_bytes_bf16(F, s);
  const float* bias = reinterpret_cast<const float*>(wbytes + wtotal);
  const int vec_io = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  fn<<<static_cast<unsigned>(units), kThreadsBf16, smem, stream>>>(
      static_cast<const unsigned short*>(x), wbytes, bias, static_cast<unsigned short*>(out), g,
      vec_io);
  return cudaGetLastError();
}

// Shared memory per CTA and resident CTAs per SM of the bf16 kernel for an
// (F, H, W) input.
template <int F>
cudaError_t occupancy_bf16(int H, int W, int* smem_bytes, int* ctas_per_sm) {
  const Geometry g = make_geometry(H, W);
  const int smem = smem_layout_bf16(F, H, g.pitch).total;
  const KernelFnBf16 fn = kernel_bf16<F>(g);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  *smem_bytes = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kThreadsBf16, smem);
}

// ---------------------------------------------------------------------------
// fp32, wide: ESRGAN's block (nf = 64, gc = 32, LeakyReLU 0.2) at 16x16

constexpr int kWideNF = 64;
constexpr int kWideGC = 32;
constexpr float kWideSlope = 0.2f;
constexpr int kWideSide = 16;                     // H = W = 16: one tile, no halo
constexpr int kWideCh = kWideNF + 4 * kWideGC;    // the concat held: 192 channels
constexpr int kWidePlane = (kWideSide + 2) * kWideSide + 8;  // 296 floats, 8 mod 32
constexpr int kWideGuard = 32;                    // floats before plane 0
constexpr int kWideSmem = (kWideGuard + kWideCh * kWidePlane) * 4;  // 227,456 B

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// One stage of the wide block for a warp's two image rows (m-tiles): NT
// n-tiles of 8 output channels, K = 9 taps x 8 * chunks concat channels from
// plane 0 on. pix[mt][h] is the plane offset of the thread's pixel (row gq
// or gq + 8 of m-tile mt). A tap that leaves the row on the left (dx = 0) or
// on the right (dx = 2) reads the neighbouring row's last or first pixel:
// keep_l / keep_r zero those operands (pixel x = 0 of h = 0 for lane gq = 0;
// x = 15 of h = 1 for gq = 7).
template <int NT>
__device__ __forceinline__ void wide_stage(const float* sm, int chunks, const float4* wp,
                                           const float* __restrict__ bias,
                                           const int (&pix)[2][2], bool keep_l, bool keep_r,
                                           int tq, float (&acc)[2][NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float b0 = __ldg(bias + nt * 8 + 2 * tq);
    const float b1 = __ldg(bias + nt * 8 + 2 * tq + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = b0;
      acc[mt][nt][1] = b1;
      acc[mt][nt][2] = b0;
      acc[mt][nt][3] = b1;
    }
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const float* ch0 = sm + (c * 8 + tq) * kWidePlane;  // channel tq of the chunk
    const float* ch4 = ch0 + 4 * kWidePlane;            // channel tq + 4
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3 - 1) * kWideSide + (tap % 3 - 1);
      float4 wv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) wv[nt] = __ldg(wp + nt * 32);
      wp += NT * 32;
      float a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = ch0[pix[mt][0] + toff];
        a[mt][1] = ch0[pix[mt][1] + toff];
        a[mt][2] = ch4[pix[mt][0] + toff];
        a[mt][3] = ch4[pix[mt][1] + toff];
        if (tap % 3 == 0 && !keep_l) a[mt][0] = a[mt][2] = 0.f;
        if (tap % 3 == 2 && !keep_r) a[mt][1] = a[mt][3] = 0.f;
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[mt][i], ah[mt][i], al[mt][i]);
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
}

// One CTA per sample. Shared memory: kWideGuard zeros, then the concat's 192
// channel planes (x, out_1 .. out_4), each a zero row, 16 rows of 16 pixels,
// a zero row and 8 pad floats. Warp w owns image rows 2w and 2w + 1.
__global__ void __launch_bounds__(kThreads, 1)
drb_kernel_wide(const float* __restrict__ x, const float4* __restrict__ wfrag,
                const float* __restrict__ bias, float* __restrict__ out, int vec_in) {
  constexpr int HW = kWideSide * kWideSide;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + kWideGuard;
  const float* xb = x + static_cast<size_t>(blockIdx.x) * kWideNF * HW;
  float* ob = out + static_cast<size_t>(blockIdx.x) * kWideNF * HW;

  // x into planes 0..63 (rows 1..16) by cp.async; everything else zeroed.
  if (vec_in) {
    for (int i = threadIdx.x; i < kWideNF * HW / 4; i += kThreads) {
      const int c = i / (HW / 4);
      const int p = 4 * (i - c * (HW / 4));
      cp_async16(sm + c * kWidePlane + kWideSide + p, xb + c * HW + p);
    }
  } else {
    for (int i = threadIdx.x; i < kWideNF * HW; i += kThreads) {
      const int c = i / HW;
      cp_async4(sm + c * kWidePlane + kWideSide + (i - c * HW), xb + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < kWideSmem / 16; i += kThreads) {
    const int f = 4 * i - kWideGuard;  // float offset from plane 0
    const int r = f - (f / kWidePlane) * kWidePlane;
    if (f < 0 || f >= kWideNF * kWidePlane || r < kWideSide || r >= kWideSide + HW) {
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  int pix[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[mt][h] = (2 * warp + mt + 1) * kWideSide + gq + 8 * h;
  }
  const bool keep_l = gq != 0;
  const bool keep_r = gq != 7;

  const float4* wp = wfrag + lane;
#pragma unroll 1
  for (int s = 1; s <= 4; ++s) {
    const int chunks = (kWideNF + (s - 1) * kWideGC) / 8;
    float acc[2][4][4];
    wide_stage<4>(sm, chunks, wp, bias + (s - 1) * kWideGC, pix, keep_l, keep_r, tq, acc);
    wp += chunks * 9 * 4 * 32;
    float* dst = sm + (kWideNF + (s - 1) * kWideGC) * kWidePlane;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int co = nt * 8 + 2 * tq + (r & 1);
          const float v = acc[mt][nt][r];
          dst[co * kWidePlane + pix[mt][r >> 1]] = v >= 0.f ? v : kWideSlope * v;
        }
      }
    }
    __syncthreads();
  }
  {
    float acc[2][8][4];
    wide_stage<8>(sm, kWideCh / 8, wp, bias + 4 * kWideGC, pix, keep_l, keep_r, tq, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int co = nt * 8 + 2 * tq + (r & 1);
          const int p = pix[mt][r >> 1];
          ob[co * HW + p - kWideSide] = fmaf(acc[mt][nt][r], kResScale, sm[co * kWidePlane + p]);
        }
      }
    }
  }
}

cudaError_t launch_wide(const float* x, const float* wpack, float* out, int B,
                        cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      drb_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (e != cudaSuccess) return e;
  int frag_floats = 0;
  for (int s = 1; s <= 5; ++s) {
    frag_floats += 2 * 9 * (kWideNF + (s - 1) * kWideGC) * (s < 5 ? kWideGC : kWideNF);
  }
  const int vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  drb_kernel_wide<<<static_cast<unsigned>(B), kThreads, kWideSmem, stream>>>(
      x, reinterpret_cast<const float4*>(wpack), wpack + frag_floats, out, vec_in);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 backward: drb_backward_kernel, then drb_grad_reduce
//
// The gradients of DoWnGAN's block (F in {8, 16}, growth F, LeakyReLU 0.01)
// at 16x16 in fp32: dx and the five weight and bias gradients of
// sum(grad_out * DRB(x)), in one kernel a block and a fixed-order reduction.
// It replaces no TPU kernel: the JAX package differentiates its DRB with XLA
// convolutions. drb.py::drb_backward_reference is its plain twin.
//
// What it computes. The block's stage outputs y_s (s = 1..5) over the concat
// a_s = (x, c_1 .. c_{s-1}), c_s = LeakyReLU(y_s), out = 0.2 y_5 + x. Walking
// back from dy_5 = 0.2 g (g = grad_out):
//   wgrad  dW_s[co, ci, tap] = sum over samples and pixels p of
//          dy_s[co, p] a_s[ci, p + tap];  db_s[co] = sum of dy_s[co, p];
//   dgrad  da_s[ci, q] = sum over co, tap of W_s[co, ci, tap] dy_s[co, q - tap],
//          added to the concat's gradient dc (channels 0 .. sF - 1);
//   mask   dy_s = dc[c_s] where c_s > 0, else 0.01 dc[c_s] (the slope is
//          positive, so the stored activation's sign is the pre-activation's);
//   dx = g + dc[x].
//
// What bounds it. A sample at F = 16 is the recompute of stages 1-4
// (11.80 MFLOP; stage 5's output is not needed), the dgrad (17.69) and the
// wgrad (17.69): 47.19 MFLOP, 6.04 GFLOP at B = 128, as three TF32 products
// 0.0366 ms at 495 TFLOP/s. The bytes: x, g and dx (6.3 MB) and the weight
// partials written and read once (2 x 17.7 MB), 0.0125 ms at 3.35 TB/s. The
// cuDNN recompute it replaces took 0.86-5.12 ms a block and ~40 launches.
//
// Design.
//  * One CTA per sample (B = 128: one wave on 128 of 132 SMs), 8 warps, one
//    CTA per SM. Shared memory (F = 16): the concat x, c_1 .. c_4 as the
//    forward's 18x18 zero-ringed planes (104,960 B), the stage's output
//    gradient dy in the same frame (20,992 B), and two weight buffers, odd
//    and even stages (46,080 + 36,864 B): 208,896 B.
//  * The recompute is drb_kernel's arithmetic in its order (same k-steps,
//    same three products per accumulator, weights split hi = rna(w), lo =
//    rna(w - hi) as pack_drb_weights splits them), so c_1 .. c_4 are the
//    forward kernel's bit for bit and the masks are the forward's sides.
//  * Every product is 3xTF32 (lo*lo dropped), as in the forward: the
//    configuration is fp32 with TF32 off.
//  * dgrad: M = the warp's 32 pixels (image rows 2w, 2w + 1), N = the
//    stage's sF input channels, K = F output channels x 9 taps, the A operand
//    read from dy's frame at q - tap. The concat's gradient stays in
//    registers across the walk (2 x 5F/8 x 4 floats a thread), so each
//    stage adds into it and the mask of c_s reads it where it was summed.
//  * wgrad: M = the F output channels (F = 8 leaves rows 8-15 zero), N = the
//    stage's (8-channel chunk, tap) units, K = the sample's 256 pixels. A
//    warp takes every 8th unit, up to kBwdUnits at a time, and reuses each
//    k-step's dy fragment across them. Per-sample partials go to a scratch
//    buffer ([stage][tap][co][ci], then the biases); drb_grad_reduce sums
//    them over samples in sample order, one thread an entry, into OIHW. No
//    float atomics: two calls agree bit for bit.
//  * The stage is a template argument of the wgrad and dgrad bodies (a
//    switch picks the instance), so their unit and n-tile loops unroll with
//    no branch between a k-step's loads and its MMAs: with a runtime guard
//    per unit the wgrad took 175K of a sample's 340K cycles, without it
//    80K of 207K (clock64 in CTA 0 on the H100; PERF.md).
//  * Weights: read as they are (OIHW fp32) by 4-byte cp.async into shared
//    memory, a stage ahead of its use, in 8x8 (ci, co) blocks a tap with a
//    swizzle (wsw) that serves both fragment patterns without bank
//    conflicts: the forward's (co by lane group, ci by thread) and the
//    dgrad's transpose. No packed copy, no cache.
//  * Frames: plane c starts at c * 328 + 4 ((c >> 2) & 1). The forward's
//    pattern (channel by thread, pixel by lane group) is conflict-free with
//    the 8 mod 32 stride alone; the wgrad's (channel by lane group, pixel by
//    thread) needs the 4-float skew between channel quads.

constexpr int kBwdSide = 16;               // H = W = 16: the whole image, one CTA
constexpr int kBwdPitch = kBwdSide + 2;    // frame rows and columns, zero ring included
constexpr int kBwdFrame = kBwdPitch * kBwdPitch;  // 324 floats
constexpr int kBwdPlane = 328;             // 324 padded to 8 mod 32
static_assert(kBwdPlane % 32 == 8 && kBwdPlane >= kBwdFrame + 4,
              "a plane's stride is 8 mod 32 and holds the frame behind its 4-float skew");
constexpr int kBwdUnits = 9;               // most wgrad units a warp holds at once

struct BwdParams {
  const float* w[5];  // OIHW (F, sF, 3, 3)
  const float* b[5];  // (F,)
};

__device__ __forceinline__ int bwd_plane(int c) { return c * kBwdPlane + 4 * ((c >> 2) & 1); }

// Floats a sample's weight and bias partials take, and where stage s's start.
__host__ __device__ __forceinline__ int bwd_partial_size(int F) { return 135 * F * F + 5 * F; }
__host__ __device__ __forceinline__ int bwd_stage_offset(int F, int s) {
  return 9 * F * F * (s * (s - 1) / 2);
}

// Where w[co, ci, tap] of a stage with cin8 input chunks sits in shared memory.
__device__ __forceinline__ int wsw(int co, int ci, int tap, int cin8, int f8) {
  return ((tap * cin8 + (ci >> 3)) * f8 + (co >> 3)) * 64 + ((ci >> 2) & 1) * 32 + (co & 3) +
         ((ci & 3) << 2) + ((((co >> 2) ^ (ci >> 2)) & 1) << 4);
}

// The forward's weight split: hi = rna(w), lo = rna(w - hi).
__device__ __forceinline__ void split_tf32_w(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);  // small terms first, as drb_kernel
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ const float* stage_w(const BwdParams& p, int s) {
  return s == 1 ? p.w[0] : s == 2 ? p.w[1] : s == 3 ? p.w[2] : s == 4 ? p.w[3] : p.w[4];
}

__device__ __forceinline__ const float* stage_b(const BwdParams& p, int s) {
  return s == 1 ? p.b[0] : s == 2 ? p.b[1] : s == 3 ? p.b[2] : s == 4 ? p.b[3] : p.b[4];
}

// Stage s's OIHW weights into dst (wsw's layout) by 4-byte cp.async: a
// thread a (co, ci) pair, its 9 taps contiguous in w.
template <int F>
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ w, int s) {
  const int cin = s * F;
  for (int pair = threadIdx.x; pair < F * cin; pair += kThreads) {
    const int co = pair / cin;
    const int ci = pair - co * cin;
    float* d = dst + wsw(co, ci, 0, s * F / 8, F / 8);
    const float* src = w + 9 * pair;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) cp_async4(d + tap * cin * F, src + tap);
  }
}

// Frame offset of tap (dy, dx) = (tap / 3 - 1, tap % 3 - 1).
__device__ __forceinline__ int bwd_toff(int tap) { return (tap / 3 - 1) * kBwdPitch + tap % 3 - 1; }

// Stage S's weight gradient partials of one sample: units u = (chunk, tap)
// = (u / 9, u % 9) of the 9 * S * F / 8, u = warp + 8 j. A warp holds its
// units in batches of UB accumulators, every slot computed (a slot past the
// last unit repeats it and is not stored), so no branch stands between a
// k-step's loads and its MMAs. Each k-step's dy fragment serves the batch.
template <int F, int S>
__device__ __forceinline__ void wgrad_stage(const float* act, const float* dyf, float* pw,
                                            int warp, int gq, int tq) {
  constexpr int kUnits = 9 * S * F / 8;
  constexpr int kPerWarp = (kUnits + kWarps - 1) / kWarps;
  constexpr int kBatches = (kPerWarp + kBwdUnits - 1) / kBwdUnits;
  constexpr int UB = (kPerWarp + kBatches - 1) / kBatches;
  constexpr int HW = kBwdSide * kBwdSide;
  constexpr int cin = S * F;
#pragma unroll 1
  for (int j0 = 0; j0 < kBatches * UB; j0 += UB) {
    float wacc[UB][4];
    int boff[UB];
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = min(warp + kWarps * (j0 + i), kUnits - 1);
      boff[i] = bwd_plane(8 * (u / 9) + gq) + bwd_toff(u % 9);
#pragma unroll
      for (int r = 0; r < 4; ++r) wacc[i][r] = 0.f;
    }
#pragma unroll 2
    for (int kk = 0; kk < HW / 8; ++kk) {  // 8 pixels of a row a k-step
      const int base = ((kk >> 1) + 1) * kBwdPitch + (kk & 1) * 8 + 1 + tq;
      uint32_t ah[4], al[4];
      split_tf32(dyf[bwd_plane(gq) + base], ah[0], al[0]);
      split_tf32(dyf[bwd_plane(gq) + base + 4], ah[2], al[2]);
      if (F == 16) {
        split_tf32(dyf[bwd_plane(gq + 8) + base], ah[1], al[1]);
        split_tf32(dyf[bwd_plane(gq + 8) + base + 4], ah[3], al[3]);
      } else {
        ah[1] = al[1] = ah[3] = al[3] = 0u;
      }
#pragma unroll
      for (int i = 0; i < UB; ++i) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(act[boff[i] + base], bh0, bl0);
        split_tf32(act[boff[i] + base + 4], bh1, bl1);
        mma3(wacc[i], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = warp + kWarps * (j0 + i);
      if (u >= kUnits) continue;
      const int ci = 8 * (u / 9) + 2 * tq;
      const int tap = u % 9;
      *reinterpret_cast<float2*>(pw + (tap * F + gq) * cin + ci) =
          make_float2(wacc[i][0], wacc[i][1]);
      if (F == 16) {
        *reinterpret_cast<float2*>(pw + (tap * F + gq + 8) * cin + ci) =
            make_float2(wacc[i][2], wacc[i][3]);
      }
    }
  }
}

// Stage S's input gradient added into the concat's gradient dc (channels
// 0 .. SF - 1, n-tiles 0 .. SF/8 - 1): W_S's transpose times dy_S, the
// tap's shift on dy's side. wd0, wd1: the lane's parts of wsw.
template <int F, int S>
__device__ __forceinline__ void dgrad_stage(const float* wsm, const float* dyf,
                                            const int (&pix)[2][2], int wd0, int wd1, int tq,
                                            float (&dc)[2][5 * F / 8][4]) {
  constexpr int NT = F / 8;
  constexpr int cin8 = S * NT;
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const float* d0 = dyf + bwd_plane(8 * jj + tq);
    const float* d4 = dyf + bwd_plane(8 * jj + tq + 4);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = bwd_toff(tap);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(d0[pix[mt][0] - toff], ah[mt][0], al[mt][0]);
        split_tf32(d0[pix[mt][1] - toff], ah[mt][1], al[mt][1]);
        split_tf32(d4[pix[mt][0] - toff], ah[mt][2], al[mt][2]);
        split_tf32(d4[pix[mt][1] - toff], ah[mt][3], al[mt][3]);
      }
      const float* wt = wsm + (tap * cin8 * NT + jj) * 64;
#pragma unroll
      for (int nt = 0; nt < cin8; ++nt) {
        const float* wb = wt + nt * NT * 64;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_w(wb[wd0], bh0, bl0);
        split_tf32_w(wb[wd1], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(dc[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
drb_backward_kernel(const float* __restrict__ x, const float* __restrict__ gout, BwdParams p,
                    float* __restrict__ dx, float* __restrict__ partial, float* __restrict__ acts) {
  constexpr int NT = F / 8;
  constexpr int HW = kBwdSide * kBwdSide;
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // 5F planes: x, c_1 .. c_4
  float* dyf = act + 5 * F * kBwdPlane;           // F planes: dy of the current stage
  float* w_odd = dyf + F * kBwdPlane;             // stages 1, 3, 5 (45 F^2 floats)
  float* w_even = w_odd + 45 * F * F;             // stages 2, 4 (36 F^2 floats)

  const int b = blockIdx.x;
  const float* xb = x + static_cast<size_t>(b) * F * HW;
  const float* gb = gout + static_cast<size_t>(b) * F * HW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  // The concat's and dy's frames zeroed (the rings stay zero); then x into
  // group 0 by cp.async and 0.2 g into dy's frame. W_1 and W_2 follow, a
  // commit group each.
  for (int i = tid; i < 6 * F * kBwdPlane / 4; i += kThreads) {
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  constexpr int kPerThread = F * HW / kThreads;
  float gv[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) gv[k] = __ldg(gb + k * kThreads + tid);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = k * kThreads + tid;  // (channel, pixel) of the sample
    const int c = i / HW;
    const int pos = ((i - c * HW) / kBwdSide + 1) * kBwdPitch + i % kBwdSide + 1;
    cp_async4(act + bwd_plane(c) + pos, xb + i);
    dyf[bwd_plane(c) + pos] = kResScale * gv[k];
  }
  stage_weights<F>(w_odd, p.w[0], 1);
  cp_async_commit();
  stage_weights<F>(w_even, p.w[1], 2);
  cp_async_commit();

  // The thread's 4 pixels (m-tile rows gq, gq + 8 of image rows 2w, 2w + 1).
  int pix[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[mt][h] = (2 * warp + mt + 1) * kBwdPitch + 8 * h + gq + 1;
  }
  // Lane parts of wsw: the forward's B fragment (co = 8nt + gq, ci = 8c + tq
  // and + 4) and the dgrad's (co = 8j + tq and + 4, ci = 8nt + gq).
  const int wf0 = (gq & 3) + (tq << 2) + ((gq >> 2) << 4);
  const int wf1 = 32 + (gq & 3) + (tq << 2) + (((gq >> 2) ^ 1) << 4);
  const int wd0 = ((gq >> 2) << 5) + tq + ((gq & 3) << 2) + ((gq >> 2) << 4);
  const int wd1 = ((gq >> 2) << 5) + tq + ((gq & 3) << 2) + (((gq >> 2) ^ 1) << 4);

  // Recompute c_1 .. c_4: drb_kernel's stages at 16x16, k-steps in its order.
#pragma unroll 1
  for (int s = 1; s <= 4; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const float* wsm = (s & 1) ? w_odd : w_even;
    const int cin8 = s * NT;
    const float* bias = stage_b(p, s);
    float acc[2][NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = __ldg(bias + nt * 8 + 2 * tq);
      const float b1 = __ldg(bias + nt * 8 + 2 * tq + 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][nt][0] = b0;
        acc[mt][nt][1] = b1;
        acc[mt][nt][2] = b0;
        acc[mt][nt][3] = b1;
      }
    }
#pragma unroll 1
    for (int c8 = 0; c8 < cin8; ++c8) {
      const float* ch0 = act + bwd_plane(8 * c8 + tq);
      const float* ch4 = act + bwd_plane(8 * c8 + tq + 4);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = bwd_toff(tap);
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
          const float* wb = wsm + ((tap * cin8 + c8) * NT + nt) * 64;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_w(wb[wf0], bh0, bl0);
          split_tf32_w(wb[wf1], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int co = nt * 8 + 2 * tq + (r & 1);
          const float v = acc[mt][nt][r];
          const float c = v >= 0.f ? v : kSlope * v;
          act[bwd_plane(s * F + co) + pix[mt][r >> 1]] = c;
          if (acts) {
            acts[(static_cast<size_t>(b) * 4 * F + (s - 1) * F + co) * HW +
                 (2 * warp + mt) * kBwdSide + 8 * (r >> 1) + gq] = c;
          }
        }
      }
    }
    __syncthreads();
    if (s <= 3) stage_weights<F>((s & 1) ? w_odd : w_even, stage_w(p, s + 2), s + 2);
    cp_async_commit();  // empty after stage 4: the walk starts with W_5, W_4 is in place
  }

  // The walk back, stage 5 to 1. dc: the concat's gradient, 5F channels at
  // the thread's pixels, in the dgrad's accumulator layout.
  float dc[2][5 * NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 5 * NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dc[mt][nt][r] = 0.f;
    }
  }
  float* pb = partial ? partial + static_cast<size_t>(b) * bwd_partial_size(F) : nullptr;

#pragma unroll 1
  for (int s = 5; s >= 1; --s) {
    if (s < 5) {  // c_s's gradient is whole: mask it into dy's frame
#pragma unroll
      for (int g = 1; g <= 4; ++g) {
        if (g != s) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int co = nt * 8 + 2 * tq + (r & 1);
              const int pos = pix[mt][r >> 1];
              const float v = dc[mt][g * NT + nt][r];
              dyf[bwd_plane(co) + pos] = act[bwd_plane(g * F + co) + pos] > 0.f ? v : kSlope * v;
            }
          }
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* wsm = (s & 1) ? w_odd : w_even;

    if (pb) {
      float* pw = pb + bwd_stage_offset(F, s);
      switch (s) {
        case 5: wgrad_stage<F, 5>(act, dyf, pw, warp, gq, tq); break;
        case 4: wgrad_stage<F, 4>(act, dyf, pw, warp, gq, tq); break;
        case 3: wgrad_stage<F, 3>(act, dyf, pw, warp, gq, tq); break;
        case 2: wgrad_stage<F, 2>(act, dyf, pw, warp, gq, tq); break;
        default: wgrad_stage<F, 1>(act, dyf, pw, warp, gq, tq); break;
      }
      // db_s: kThreads / F threads a channel sum its pixels, then a butterfly.
      {
        constexpr int T = kThreads / F;
        constexpr int PX = HW / T;
        const int co = tid / T;
        const int first = (tid % T) * PX;
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < PX; ++q) {
          const int px = first + q;
          sum += dyf[bwd_plane(co) + (px / kBwdSide + 1) * kBwdPitch + px % kBwdSide + 1];
        }
#pragma unroll
        for (int o = T / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (tid % T == 0) pb[135 * F * F + (s - 1) * F + co] = sum;
      }
    }

    if (s > 1 || dx) {
      switch (s) {
        case 5: dgrad_stage<F, 5>(wsm, dyf, pix, wd0, wd1, tq, dc); break;
        case 4: dgrad_stage<F, 4>(wsm, dyf, pix, wd0, wd1, tq, dc); break;
        case 3: dgrad_stage<F, 3>(wsm, dyf, pix, wd0, wd1, tq, dc); break;
        case 2: dgrad_stage<F, 2>(wsm, dyf, pix, wd0, wd1, tq, dc); break;
        default: dgrad_stage<F, 1>(wsm, dyf, pix, wd0, wd1, tq, dc); break;
      }
    }
    __syncthreads();
    if (s >= 3) stage_weights<F>((s & 1) ? w_odd : w_even, stage_w(p, s - 2), s - 2);
    cp_async_commit();
  }

  if (dx) {
    float* dxb = dx + static_cast<size_t>(b) * F * HW;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int co = nt * 8 + 2 * tq + (r & 1);
          const int px = (2 * warp + mt) * kBwdSide + 8 * (r >> 1) + gq;
          dxb[co * HW + px] = __ldg(gb + co * HW + px) + dc[mt][nt][r];
        }
      }
    }
  }
}

// out[j] = sum over b = 0 .. B-1, in that order, of the partials' entry i
// (one thread an entry), j = i moved from [tap][co][ci] to OIHW within its
// stage; the biases keep their place.
__global__ void __launch_bounds__(kThreads)
drb_grad_reduce(const float* __restrict__ partial, int B, int F, float* __restrict__ out) {
  const int size = bwd_partial_size(F);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= size) return;
  const float* p = partial + i;
  float sum = 0.f;
  int b = 0;
  for (; b + 16 <= B; b += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = __ldg(p + static_cast<size_t>(b + k) * size);
#pragma unroll
    for (int k = 0; k < 16; ++k) sum += v[k];
  }
  for (; b < B; ++b) sum += __ldg(p + static_cast<size_t>(b) * size);
  int j = i;
  if (i < 135 * F * F) {
    int s = 1;
    while (i >= bwd_stage_offset(F, s + 1)) ++s;
    const int cin = s * F;
    const int k = i - bwd_stage_offset(F, s);
    const int tap = k / (F * cin);
    const int co = (k - tap * F * cin) / cin;
    const int ci = k - (tap * F + co) * cin;
    j = bwd_stage_offset(F, s) + (co * cin + ci) * 9 + tap;
  }
  out[j] = sum;
}

template <int F>
cudaError_t launch_backward(const float* x, const float* gout, const BwdParams& p, float* dx,
                            float* partial, float* dparams, float* acts, int B,
                            cudaStream_t stream) {
  const int smem = ((6 * kBwdPlane + 81 * F) * F) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(drb_backward_kernel<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  drb_backward_kernel<F><<<static_cast<unsigned>(B), kThreads, smem, stream>>>(
      x, gout, p, dx, partial, acts);
  e = cudaGetLastError();
  if (e != cudaSuccess || partial == nullptr) return e;
  const int blocks = (bwd_partial_size(F) + kThreads - 1) / kThreads;
  drb_grad_reduce<<<blocks, kThreads, 0, stream>>>(partial, B, F, dparams);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 backward, wide: drb_backward_kernel_wide, then drb_grad_reduce_wide
//
// The gradients of ESRGAN's block (nf = 64, gc = 32, LeakyReLU 0.2, 16x16,
// fp32) in one launch a block and a fixed-order reduction: what
// drb_backward_kernel computes for DoWnGAN's block (same recompute, mask,
// wgrad and dgrad; see there), at widths where a sample's concat (192
// planes) and its gradient no longer fit one CTA. drb.py::
// drb_backward_reference (growth 32, slope 0.2) is its plain twin.
//
// What bounds it. A sample is the recompute of stages 1-4 (66.06 MFLOP),
// the dgrad (122.68) and the wgrad (122.68): 311.4 MFLOP, 39.86 GFLOP at B =
// 128, as three TF32 products 0.2416 ms at 495 TFLOP/s. The bytes: x, g and
// dx (25.2 MB) and the per-CTA partials written and read once (2 x 122.8
// MB), 0.081 ms at 3.35 TB/s.
//
// Design.
//  * A cluster of two CTAs a sample, split by image rows: rank r owns rows
//    8r .. 8r + 7 (warp w row 8r + w) and holds them with a halo row above
//    and below, zero outside the image. min(B, 64) clusters of 8-warp CTAs,
//    one CTA per SM, cluster c taking samples c, c + 64, .. in turn: at B =
//    128 two samples each, the time of one wave of whole samples.
//  * Shared memory: 256 planes of 10 frame rows x 18 (the zero columns of
//    drb_backward_kernel's frame): x, c_1 .. c_4 (channels 0 .. 191, as the
//    concat), then dy_5 (64). Plane c starts at c * 184 + 4 ((c >> 2) & 1):
//    the stride is 24 mod 32, so the recompute's and dgrad's pattern
//    (channel by thread, pixel by lane group) hit 32 banks, and the 4-float
//    skew does it for the wgrad's (channel by lane group, pixel by thread).
//    256 x 184 floats = 188,416 B.
//  * Halo rows cross by distributed shared memory: the warp whose row is
//    the peer's halo row writes each value it stores there too, and a
//    cluster barrier follows. x's and dy_5 = 0.2 g's halo rows are read
//    from global memory.
//  * The recompute is drb_kernel_wide's arithmetic in its order: the packed
//    fragments of pack_drb_weights (the forward's own argument), the same
//    k-steps, the same three products per accumulator, an image row an
//    m-tile. So c_1 .. c_4 are the forward kernel's bit for bit and the
//    masks are the forward's sides. A warp takes two rows and two of the
//    four n-tiles (one row and all four: 5 % slower end to end).
//  * The walk pulls each group's gradient instead of pushing each stage's:
//    dc[c_j] = sum over t > j of W_t[:, c_j]^T * dy_t, in registers (a warp
//    two rows x 16 channels, x: x 32), masked by c_j into dy_j, which takes
//    c_j's planes (stage j + 1's wgrad, the last reader of c_j, is behind
//    a cluster barrier). Every dy_t stays for the later groups; x's
//    gradient is the last pull, and dx = g + dc[x]. Registers hold one
//    group's gradient, not all 192 channels'.
//  * dgrad's B fragments are the packed forward fragments transposed, one
//    float4 a lane as the forward reads its own: drb_dgrad_frags_wide (one
//    small launch before the kernel) moves W[8k + tq][8n + gq] and W[8k + tq
//    + 4][8n + gq] to lane (gq, tq) from forward lanes (tq, gq & 3) and (tq +
//    4, gq & 3). Reading the forward's float4s and picking the components in
//    the dgrad cost two loads and four selects a fragment.
//  * wgrad: drb_backward_kernel's (M = output channels, N = (chunk, tap)
//    units, K = the CTA's 128 pixels, units batched per warp so each dy
//    fragment serves up to 8; 4 at stage 5, whose 64 outputs are 4 m-tiles).
//    Each CTA sums its partials over its own rows and its samples, in
//    sample order, in a slot of its own (its blockIdx, [stage][tap][co][ci],
//    then the biases; the first sample stores, the next ones add), so the
//    scratch is 2 min(B, 64) slots: 122.8 MB at B >= 64. drb_grad_reduce_
//    wide sums the slots in slot order, one thread an entry, into OIHW. No
//    float atomics: two calls agree bit for bit.
//  * Every product is 3xTF32 (lo*lo dropped), as in the forward: the
//    configuration is fp32 with TF32 off.
//  * ptxas: 254 registers, no spills; one CTA an SM. CTA 0's clock64 split
//    over its two samples at B = 128 (H100): set-up 36K, recompute 268K,
//    wgrad and bias sums 723K, the groups' dgrads 293K, x's dgrad 227K,
//    masks and cluster barriers 31K cycles. The wgrad takes 3.8 cycles an
//    MMA, the rest about 2.7 (the forward kernel 2.1): holding 6 or 4 units
//    a warp, one k-step at a time, or each product pass over every
//    accumulator before the next measured no faster.

namespace cg = cooperative_groups;

constexpr int kWbRows = 8;                       // image rows a CTA owns
constexpr int kWbPitch = kWideSide + 2;          // a frame row with its two zero columns
constexpr int kWbFrame = (kWbRows + 2) * kWbPitch;  // 180 floats: own rows and a halo row each side
constexpr int kWbPlane = 184;                    // 24 mod 32
static_assert(kWbPlane % 32 == 24 && kWbPlane >= kWbFrame + 4,
              "a plane's stride is 24 mod 32 and holds the frame behind its 4-float skew");
constexpr int kWbPlanes = kWideCh + kWideNF;     // the concat, then dy_5
constexpr int kWbSmem = kWbPlanes * kWbPlane * 4;  // 188,416 B
constexpr int kWbHalo = kWbRows * kWbPitch;      // an edge row's offset to the peer's halo row
constexpr int kWbUnits = 8;                      // most wgrad units a warp holds at once
constexpr int kWbClusters = 64;                  // most clusters a launch (one CTA an SM)

__host__ __device__ constexpr int wb_cin(int s) { return kWideNF + (s - 1) * kWideGC; }
__host__ __device__ constexpr int wb_cout(int s) { return s < 5 ? kWideGC : kWideNF; }
// The first concat channel of stage s's output (s < 5) or of dy_5's planes.
__host__ __device__ constexpr int wb_out_plane(int s) { return s < 5 ? wb_cin(s) : kWideCh; }

// Floats before stage s's weight partials in a slot ([tap][co][ci] a stage).
__host__ __device__ constexpr int wb_stage_offset(int s) {
  int off = 0;
  for (int t = 1; t < s; ++t) off += 9 * wb_cin(t) * wb_cout(t);
  return off;
}
constexpr int kWbWeights = wb_stage_offset(6);               // 239,616
constexpr int kWbPartial = kWbWeights + 4 * kWideGC + kWideNF;  // and the biases: 239,808

// Float4s of packed fragments before stage s's (pack_drb_weights' layout).
__host__ __device__ constexpr int wb_frag_offset(int s) {
  int off = 0;
  for (int t = 1; t < s; ++t) off += 2 * 9 * wb_cin(t) * wb_cout(t) / 4;
  return off;
}

__device__ __forceinline__ int wb_plane(int c) { return c * kWbPlane + 4 * ((c >> 2) & 1); }
__device__ __forceinline__ int wb_toff(int tap) { return (tap / 3 - 1) * kWbPitch + tap % 3 - 1; }

// Stage S's weight gradient partials over the CTA's rows: units u = (chunk,
// tap) = (u / 9, u % 9) of 9 cin / 8, u = warp + 8 j, as wgrad_stage.
// The first sample of a slot stores its partials, the next ones add to them.
__device__ __forceinline__ void wb_put(float* p, float x, float y, bool first) {
  float2* q = reinterpret_cast<float2*>(p);
  if (first) {
    *q = make_float2(x, y);
  } else {
    const float2 o = *q;
    *q = make_float2(o.x + x, o.y + y);
  }
}

template <int S>
__device__ __forceinline__ void wide_wgrad(const float* sm, float* pw, bool first, int warp, int gq,
                                           int tq) {
  constexpr int cin = wb_cin(S), cout = wb_cout(S);
  constexpr int MT = cout / 16;
  constexpr int kUnits = 9 * cin / 8;
  constexpr int kPerWarp = (kUnits + kWarps - 1) / kWarps;
  constexpr int kMaxUB = kWbUnits * 2 / MT;
  constexpr int kBatches = (kPerWarp + kMaxUB - 1) / kMaxUB;
  constexpr int UB = (kPerWarp + kBatches - 1) / kBatches;
  constexpr int dyp = wb_out_plane(S);
#pragma unroll 1
  for (int j0 = 0; j0 < kBatches * UB; j0 += UB) {
    float wacc[MT][UB][4];
    int boff[UB];
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = min(warp + kWarps * (j0 + i), kUnits - 1);
      boff[i] = wb_plane(8 * (u / 9) + gq) + wb_toff(u % 9);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) wacc[mt][i][r] = 0.f;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < kWbRows * kWideSide / 8; ++kk) {  // 8 pixels of a row a k-step
      const int base = ((kk >> 1) + 1) * kWbPitch + (kk & 1) * 8 + 1 + tq;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* d0 = sm + wb_plane(dyp + 16 * mt + gq) + base;
        const float* d8 = sm + wb_plane(dyp + 16 * mt + gq + 8) + base;
        split_tf32(d0[0], ah[mt][0], al[mt][0]);
        split_tf32(d8[0], ah[mt][1], al[mt][1]);
        split_tf32(d0[4], ah[mt][2], al[mt][2]);
        split_tf32(d8[4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int i = 0; i < UB; ++i) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(sm[boff[i] + base], bh0, bl0);
        split_tf32(sm[boff[i] + base + 4], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(wacc[mt][i], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int u = warp + kWarps * (j0 + i);
      if (u >= kUnits) continue;
      const int ci = 8 * (u / 9) + 2 * tq;
      float* pt = pw + (u % 9) * cout * cin + ci;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int co = 16 * mt + gq;
        wb_put(pt + co * cin, wacc[mt][i][0], wacc[mt][i][1], first);
        wb_put(pt + (co + 8) * cin, wacc[mt][i][2], wacc[mt][i][3], first);
      }
    }
  }
}

// The gradient of concat group j (x for j = 0, c_j otherwise) at the warp's
// two rows (pix) and NTD n-tiles of its channels from chunk0 on: dy_t for t
// = 5 down to j + 1, each through W_t's transpose (tfrag, laid out by
// drb_dgrad_frags_wide), the tap's shift on dy's side.
template <int NTD>
__device__ __forceinline__ void wide_dgrad(const float* sm, const float4* __restrict__ tfrag, int j,
                                           const int (&pix)[2][2], int chunk0, int lane, int gq,
                                           int tq, float (&dc)[2][NTD][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dc[mt][nt][r] = 0.f;
    }
  }
#pragma unroll 1
  for (int t = 5; t > j; --t) {
    const int ntf = wb_cout(t) / 8;  // the forward's n-tiles: stage t's 8-output chunks
    const float4* wt = tfrag + wb_frag_offset(t) + lane;
#pragma unroll 1
    for (int k = 0; k < ntf; ++k) {
      const float* d0 = sm + wb_plane(wb_out_plane(t) + 8 * k + tq);
      const float* d4 = sm + wb_plane(wb_out_plane(t) + 8 * k + tq + 4);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = wb_toff(tap);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          split_tf32(d0[pix[mt][0] - toff], ah[mt][0], al[mt][0]);
          split_tf32(d0[pix[mt][1] - toff], ah[mt][1], al[mt][1]);
          split_tf32(d4[pix[mt][0] - toff], ah[mt][2], al[mt][2]);
          split_tf32(d4[pix[mt][1] - toff], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NTD; ++nt) {
          const float4 v = __ldg(wt + (((chunk0 + nt) * 9 + tap) * ntf + k) * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma3(dc[mt][nt], ah[mt], al[mt], __float_as_uint(v.x), __float_as_uint(v.y),
                 __float_as_uint(v.z), __float_as_uint(v.w));
          }
        }
      }
    }
  }
}

// Grid 2 min(B, kWbClusters), clusters of 2: CTA 2c + r is rank r of
// samples c, c + gridDim.x / 2, ..; its partials' slot is its blockIdx.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
drb_backward_kernel_wide(const float* __restrict__ x, const float* __restrict__ gout,
                         const float4* __restrict__ wfrag, const float* __restrict__ bias,
                         const float4* __restrict__ tfrag, float* __restrict__ dx,
                         float* __restrict__ partial, float* __restrict__ acts, int B) {
  constexpr int HW = kWideSide * kWideSide;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float* peer = cluster.map_shared_rank(sm, rank ^ 1);
  const int row0 = kWbRows * rank;  // frame row f holds image row row0 - 1 + f
  const int halo = rank == 0 ? -kWbHalo : kWbHalo;  // an edge row to the peer's halo row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  float* pb = partial ? partial + static_cast<size_t>(blockIdx.x) * kWbPartial : nullptr;
  // A warp's two rows 2 rp, 2 rp + 1 of the CTA (its m-tiles; rp = warp / 2)
  // and its half of a stage's or group's channels (warp % 2), in the
  // recompute and the dgrad.
  const int rp = warp >> 1;
  const int chalf = warp & 1;
  int pix[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) pix[mt][h] = (2 * rp + mt + 1) * kWbPitch + 1 + gq + 8 * h;
  }

  // Every plane zeroed once: the zero columns and the image's border rows
  // are never written, and every sample writes the rest before reading it.
  for (int i = tid; i < kWbSmem / 16; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll 1
  for (int b = blockIdx.x >> 1; b < B; b += gridDim.x >> 1) {
    const bool first = b == static_cast<int>(blockIdx.x >> 1);
    const float* xb = x + static_cast<size_t>(b) * kWideNF * HW;
    const float* gb = gout + static_cast<size_t>(b) * kWideNF * HW;

    // x and dy_5 = 0.2 g on the 9 frame rows inside the image, once every
    // warp has left the last sample (or the zeroing). The cluster barrier:
    // the peer is as far before a halo row lands in its frame (no CTA reads
    // the other's shared memory).
    __syncthreads();
    {
      const int f0 = rank == 0 ? 1 : 0;
      constexpr int kRows = kWbRows + 1;
      for (int i = tid; i < kWideNF * kRows * kWideSide; i += kThreads) {
        const int c = i / (kRows * kWideSide);
        const int rem = i - c * kRows * kWideSide;
        const int f = f0 + rem / kWideSide;
        const int col = rem % kWideSide;
        const int src = c * HW + (row0 - 1 + f) * kWideSide + col;
        const int pos = f * kWbPitch + 1 + col;
        sm[wb_plane(c) + pos] = __ldg(xb + src);
        sm[wb_plane(kWideCh + c) + pos] = kResScale * __ldg(gb + src);
      }
    }
    cluster.sync();

    // Recompute c_1 .. c_4: drb_kernel_wide's stages and k-steps, a warp two
    // rows (its m-tiles) and half the n-tiles, as the dgrad's warps below.
    {
      const float4* wp = wfrag + lane + 2 * chalf * 32;
#pragma unroll 1
      for (int s = 1; s <= 4; ++s) {
        float acc[2][2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = 2 * chalf + nt;
          const float b0 = __ldg(bias + (s - 1) * kWideGC + n * 8 + 2 * tq);
          const float b1 = __ldg(bias + (s - 1) * kWideGC + n * 8 + 2 * tq + 1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][nt][0] = b0;
            acc[mt][nt][1] = b1;
            acc[mt][nt][2] = b0;
            acc[mt][nt][3] = b1;
          }
        }
        const int chunks = wb_cin(s) / 8;
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) {
          const float* ch0 = sm + wb_plane(8 * c + tq);
          const float* ch4 = sm + wb_plane(8 * c + tq + 4);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int toff = wb_toff(tap);
            float4 wv[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) wv[nt] = __ldg(wp + nt * 32);
            wp += 4 * 32;
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              split_tf32(ch0[pix[mt][0] + toff], ah[mt][0], al[mt][0]);
              split_tf32(ch0[pix[mt][1] + toff], ah[mt][1], al[mt][1]);
              split_tf32(ch4[pix[mt][0] + toff], ah[mt][2], al[mt][2]);
              split_tf32(ch4[pix[mt][1] + toff], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma3(acc[mt][nt], ah[mt], al[mt], __float_as_uint(wv[nt].x),
                     __float_as_uint(wv[nt].y), __float_as_uint(wv[nt].z),
                     __float_as_uint(wv[nt].w));
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bool edge = rank == 0 ? (rp == kWbRows / 2 - 1 && mt == 1) : (rp == 0 && mt == 0);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int co = (2 * chalf + nt) * 8 + 2 * tq + (r & 1);
              const float v = acc[mt][nt][r];
              const float c = v >= 0.f ? v : kWideSlope * v;
              const int at = wb_plane(wb_out_plane(s) + co) + pix[mt][r >> 1];
              sm[at] = c;
              if (edge) peer[at + halo] = c;
              if (acts) {
                acts[(static_cast<size_t>(b) * 4 * kWideGC + (s - 1) * kWideGC + co) * HW +
                     (row0 + 2 * rp + mt) * kWideSide + gq + 8 * (r >> 1)] = c;
              }
            }
          }
        }
        cluster.sync();
      }
    }
    if (partial == nullptr && dx == nullptr) continue;  // both CTAs: only the recompute was asked

    // The walk back, stage 5 to 1.

#pragma unroll 1
    for (int s = 5; s >= 1; --s) {
      if (pb) {
        switch (s) {
          case 5: wide_wgrad<5>(sm, pb + wb_stage_offset(5), first, warp, gq, tq); break;
          case 4: wide_wgrad<4>(sm, pb + wb_stage_offset(4), first, warp, gq, tq); break;
          case 3: wide_wgrad<3>(sm, pb + wb_stage_offset(3), first, warp, gq, tq); break;
          case 2: wide_wgrad<2>(sm, pb + wb_stage_offset(2), first, warp, gq, tq); break;
          default: wide_wgrad<1>(sm, pb + wb_stage_offset(1), first, warp, gq, tq); break;
        }
        // db_s over the CTA's rows: kThreads / cout threads a channel, a row or
        // two each, then a butterfly.
        const int T = kThreads / wb_cout(s);
        const int co = tid / T;
        const int rows = kWbRows / T;
        const float* d =
            sm + wb_plane(wb_out_plane(s) + co) + (1 + (tid % T) * rows) * kWbPitch + 1;
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) {
#pragma unroll
          for (int col = 0; col < kWideSide; ++col) sum += d[r * kWbPitch + col];
        }
        for (int o = T / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (tid % T == 0) {
          float* pbias = pb + kWbWeights + (s - 1) * kWideGC + co;
          *pbias = first ? sum : *pbias + sum;
        }
      }
      if (s > 1) {  // c_{s-1}'s gradient, masked into dy_{s-1} in c_{s-1}'s planes
        const int j = s - 1;
        float dc[2][2][4];
        wide_dgrad<2>(sm, tfrag, j, pix, wb_cin(j) / 8 + 2 * chalf, lane, gq, tq, dc);
        cluster.sync();  // stage s's wgrad, c_j's last reader, is done in both CTAs
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bool edge = rank == 0 ? (rp == kWbRows / 2 - 1 && mt == 1) : (rp == 0 && mt == 0);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int ch = wb_cin(j) + 16 * chalf + 8 * nt + 2 * tq + (r & 1);
              const int at = wb_plane(ch) + pix[mt][r >> 1];
              const float v = dc[mt][nt][r];
              const float d = sm[at] > 0.f ? v : kWideSlope * v;
              sm[at] = d;
              if (edge) peer[at + halo] = d;
            }
          }
        }
        cluster.sync();
      } else if (dx) {  // dx = g + dc[x]
        float dc[2][4][4];
        wide_dgrad<4>(sm, tfrag, 0, pix, 4 * chalf, lane, gq, tq, dc);
        float* dxb = dx + static_cast<size_t>(b) * kWideNF * HW;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int co = 32 * chalf + 8 * nt + 2 * tq + (r & 1);
              const int px = (row0 + 2 * rp + mt) * kWideSide + gq + 8 * (r >> 1);
              dxb[co * HW + px] = __ldg(gb + co * HW + px) + dc[mt][nt][r];
            }
          }
        }
      }
    }
  }
}

// The dgrad's B fragments from the packed forward ones, one thread a
// float4: at the index where pack_drb_weights keeps stage t's fragment for
// (input chunk n, tap, output chunk k), lane (gq, tq) of the result holds
// W_t[8k + tq][8n + gq] and W_t[8k + tq + 4][8n + gq], hi then lo, as
// (hi, hi, lo, lo). Forward lanes (tq, gq & 3) and (tq + 4, gq & 3) of that
// fragment hold them, hi at component gq >> 2 and lo at 2 + (gq >> 2).
__global__ void __launch_bounds__(kThreads)
drb_dgrad_frags_wide(const float4* __restrict__ wfrag, float4* __restrict__ tfrag) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= wb_frag_offset(6)) return;
  const int lane = i & 31;
  const int gq = lane >> 2;
  const bool upper = gq >= 4;
  const float4* src = wfrag + (i - lane) + 4 * (lane & 3) + (gq & 3);
  const float4 v0 = __ldg(src);
  const float4 v1 = __ldg(src + 16);
  tfrag[i] = make_float4(upper ? v0.y : v0.x, upper ? v1.y : v1.x, upper ? v0.w : v0.z,
                         upper ? v1.w : v1.z);
}

// out[j] = sum over slots k = 0 .. slots - 1, in that order, of the
// partials' entry i (one thread an entry), j = i moved from [tap][co][ci]
// to OIHW within its stage; the biases keep their place.
__global__ void __launch_bounds__(kThreads)
drb_grad_reduce_wide(const float* __restrict__ partial, int slots, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kWbPartial) return;
  const float* p = partial + i;
  float sum = 0.f;
  int k = 0;
  for (; k + 16 <= slots; k += 16) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = __ldg(p + static_cast<size_t>(k + q) * kWbPartial);
#pragma unroll
    for (int q = 0; q < 16; ++q) sum += v[q];
  }
  for (; k < slots; ++k) sum += __ldg(p + static_cast<size_t>(k) * kWbPartial);
  int j = i;
  if (i < kWbWeights) {
    int s = 1;
    while (i >= wb_stage_offset(s + 1)) ++s;
    const int cin = wb_cin(s), cout = wb_cout(s);
    const int e = i - wb_stage_offset(s);
    const int tap = e / (cout * cin);
    const int co = (e - tap * cout * cin) / cin;
    const int ci = e - (tap * cout + co) * cin;
    j = wb_stage_offset(s) + (co * cin + ci) * 9 + tap;
  }
  out[j] = sum;
}

cudaError_t launch_backward_wide(const float* x, const float* gout, const float* wpack,
                                 float* tfrag, float* dx, float* partial, float* dparams,
                                 float* acts, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(drb_backward_kernel_wide,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWbSmem);
  if (e != cudaSuccess) return e;
  const float4* wfrag = reinterpret_cast<const float4*>(wpack);
  float4* tf = reinterpret_cast<float4*>(tfrag);
  drb_dgrad_frags_wide<<<(wb_frag_offset(6) + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      wfrag, tf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int slots = 2 * (B < kWbClusters ? B : kWbClusters);
  drb_backward_kernel_wide<<<static_cast<unsigned>(slots), kThreads, kWbSmem, stream>>>(
      x, gout, wfrag, wpack + 4 * wb_frag_offset(6), tf, dx, partial, acts, B);
  e = cudaGetLastError();
  if (e != cudaSuccess || partial == nullptr) return e;
  drb_grad_reduce_wide<<<(kWbPartial + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, slots, dparams);
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
// device; wpack: the packed weights of drb.py::pack_drb_weights for bf16
// (the stages in wgmma's canonical B layout, then the biases as fp32),
// 16-byte aligned.
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

// out = DRB(x) for ESRGAN's block: x, out (B, 64, 16, 16) contiguous fp32;
// wpack: drb.py::pack_drb_weights of its five convs (64+32(s-1) -> 32, and
// 192 -> 64), 16-byte aligned. Takes (NF, GC, H, W) = (64, 32, 16, 16) only.
int drb_forward_f32_wide(const void* x, const void* wpack, void* out, int B, int NF, int GC,
                         int H, int W, void* stream) {
  if (B < 1 || NF != kWideNF || GC != kWideGC || H != kWideSide || W != kWideSide) {
    return cudaErrorInvalidValue;
  }
  return launch_wide(static_cast<const float*>(x), static_cast<const float*>(wpack),
                     static_cast<float*>(out), B, static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's dynamic shared memory per CTA and its resident CTAs per
// SM (the occupancy API) for an (F, H, W) input.
int drb_bf16_occupancy(int F, int H, int W, int* smem_bytes, int* ctas_per_sm) {
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  switch (F) {
    case 8:
      return occupancy_bf16<8>(H, W, smem_bytes, ctas_per_sm);
    case 16:
      return occupancy_bf16<16>(H, W, smem_bytes, ctas_per_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

// The gradients of sum(gout * DRB(x)) for DoWnGAN's block in fp32 at 16x16:
// x, gout (B, F, 16, 16) contiguous fp32; params: 10 device pointers, the
// five OIHW weights (F, sF, 3, 3) then the five biases (F,), contiguous fp32.
// dx (B, F, 16, 16) or null (not wanted); partial (B x (135 F^2 + 5 F)
// floats of scratch) and dparams (135 F^2 + 5 F floats: the five weight
// gradients in OIHW, then the five bias gradients) or both null (not
// wanted); acts (B, 4F, 16, 16), the recomputed c_1 .. c_4, or null.
// Launches drb_backward_kernel and, for the parameters, drb_grad_reduce.
int drb_backward_f32(const void* x, const void* gout, const void* const* params, void* dx,
                     void* partial, void* dparams, void* acts, int B, int F, int H, int W,
                     void* stream) {
  if (B < 1 || H != kBwdSide || W != kBwdSide || (partial == nullptr) != (dparams == nullptr)) {
    return cudaErrorInvalidValue;
  }
  BwdParams p;
  for (int s = 0; s < 5; ++s) {
    p.w[s] = static_cast<const float*>(params[s]);
    p.b[s] = static_cast<const float*>(params[5 + s]);
  }
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gout);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(partial);
  float* df = static_cast<float*>(dparams);
  float* af = static_cast<float*>(acts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 8:
      return launch_backward<8>(xf, gf, p, dxf, pf, df, af, B, st);
    case 16:
      return launch_backward<16>(xf, gf, p, dxf, pf, df, af, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The gradients of sum(gout * DRB(x)) for ESRGAN's block in fp32 at 16x16:
// x, gout (B, 64, 16, 16) contiguous fp32; wpack: pack_drb_weights of the
// block (the forward's argument), 16-byte aligned; tfrag: 479,232 floats of
// scratch, 16-byte aligned. dx (B, 64, 16, 16) or null (not wanted);
// partial (2 min(B, 64) x 239,808 floats of scratch) and dparams (239,808
// floats: the five weight gradients in OIHW, then the five bias gradients)
// or both null (not wanted); acts (B, 128, 16, 16), the recomputed c_1 ..
// c_4, or null. Takes (NF, GC, H, W) = (64, 32, 16, 16) only. Launches
// drb_dgrad_frags_wide, drb_backward_kernel_wide and, for the parameters,
// drb_grad_reduce_wide.
int drb_backward_f32_wide(const void* x, const void* gout, const void* wpack, void* tfrag,
                          void* dx, void* partial, void* dparams, void* acts, int B, int NF,
                          int GC, int H, int W, void* stream) {
  if (B < 1 || B > (1 << 30) || NF != kWideNF || GC != kWideGC || H != kWideSide ||
      W != kWideSide || (partial == nullptr) != (dparams == nullptr)) {
    return cudaErrorInvalidValue;
  }
  return launch_backward_wide(static_cast<const float*>(x), static_cast<const float*>(gout),
                              static_cast<const float*>(wpack), static_cast<float*>(tfrag),
                              static_cast<float*>(dx),
                              static_cast<float*>(partial), static_cast<float*>(dparams),
                              static_cast<float*>(acts), B, static_cast<cudaStream_t>(stream));
}

const char* drb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
