// 3x3, stride-1, SAME conv in NHWC as an implicit GEMM, for sm_90a.
//
// Replaces the Pallas slab kernel dpm_solver_tpu/ops/conv3x3.py::_pallas_conv3x3
// (kernel body `_kernel`). That kernel streamed full-width row slabs through
// VMEM with neighbour-indexed halo copies and a 128-channel-group accumulator
// carried across the sequential grid. On Hopper blocks run in parallel and in
// no order, so nothing is carried between them: each block owns one output
// tile and walks the reduction (9 taps x C channels) itself, or (fp32, on
// small grids) one contiguous range of it, summed by a second pass.
//
//   out[m, n] = bias[n] + sum_{tap, c} x[pixel(m) + offset(tap), c] * w[tap, c, n]
//   m = (b, oh, ow) over B*H*W output pixels, n over CO, tap = dy*3 + dx.
//
// What bounds it on the H100: at the paths' shapes (C, CO >= 128) the conv
// does 2*9*C*CO flops per output pixel against about 2*C + 2*CO bytes, far
// above the card's ~295 flop/byte bf16 ridge, so it is compute-bound: the
// products belong on the tensor cores at their full rate, which only `wgmma`
// fed by TMA reaches. Three kernels, by route (chosen on the host,
// ops/conv3x3.py::conv3x3_plan):
//
// - "wgmma" (bf16 with C % 8 == 0 and CO % 8 == 0: every conv of paths A-D
//   but the VAE's two ends): `conv3x3_wgmma`. A block owns a spatial patch
//   of 128 output pixels (w_t x h_t x b_t, chosen on the host per map size
//   as the box that tiles it in the fewest patches: 16x8x1 on wide maps,
//   8x8x2 at 8x8 and 24x24, 4x4x8 at 4x4 and 12x12) by 128 output channels.
//   One producer warp streams the reduction, 9 taps x ceil(C/64) channel
//   chunks, through a ring of STAGES shared-memory stages guarded by full
//   and empty mbarriers: tap (dy, dx)'s input tile is ONE 4-D TMA box
//   (64 channels, w_t, h_t, b_t) at (c0, w0+dx-1, h0+dy-1, b0), which lands
//   as 128 rows of 128 bytes, the K-major 128-byte-swizzled layout `wgmma`
//   reads, and TMA fills the coordinates outside the image (SAME padding)
//   and the channels past C with zeros, so no load carries a mask. The
//   weight tile is two boxes (64 output channels, 64 input channels) of the
//   (3,3,C,CO) weight seen as a 3-D (CO, C, 9) map, read MN-major through
//   the descriptor's transpose bit. Two consumer warpgroups each own 64
//   pixels x 128 channels as `wgmma` m64n128k16 fp32 accumulators in
//   registers, keep one group of products in flight while the next stage
//   is waited for, and release each stage when its products are done. The
//   epilogue adds the bias in fp32 and rounds once to bf16 straight from
//   the registers, masking the patch's ragged edges and the CO tail. Two
//   blocks fit on an SM (96 KB of shared memory each), so one block's
//   epilogue and ramp overlap the other's products.
// - "narrow" (bf16 with C or CO not a multiple of 8, or a tensor off a
//   16-byte boundary, where TMA cannot stride: the SD VAE's conv_in, x
//   (4,96,96,4) -> 512, and conv_out, x (4,768,768,128) -> 3, and ragged
//   shapes): `conv3x3_narrow`. Both VAE convs are bound by bytes, not by
//   products: conv_out reads 604 MB to write 14 MB, conv_in writes 37.7 MB
//   from 74 KB. So the kernel streams units of (16 x 16 output patch, 64- or
//   8-column pass) through a persistent grid (as many blocks as the SMs
//   hold, each walking every gridDim-th unit, its ring running on from one
//   to the next), and copies each patch with its one-pixel halo (18 x 18
//   pixels) into shared memory once per chunk of channels, by cp.async
//   (16-, 8- or 4-byte copies as C and the alignment allow; SAME padding
//   and the channel tail as zero fill); all 9 taps read it there at their
//   offsets through ldmatrix (each lane gives the address of its pixel
//   shifted by the tap), feeding `mma.sync`: m16n8k16, or m16n8k8 where
//   C <= 8 (conv_in's 4 channels pad to 8, not 32). The output tile fits the
//   narrow side: N is padded to 8 where CO <= 8 (conv_out's 3), and a wide
//   CO is cut into 64-column passes that neighbouring blocks run at once
//   (conv_in's 512 channels: x read from device memory once, then from L2).
//   A two-stage cp.async ring of (patch chunk, weight tile) keeps the next
//   copies in flight under the products; the weight is laid out by the
//   wrapper (zero-padded, each output channel's inputs contiguous) so its
//   copies are unmasked 16-byte ones. The epilogue adds the bias in fp32
//   and rounds once to bf16, masking the patch's edges and the CO tail.
// - "f32" (fp32: path E's bits/dim, whose RK45 step control rides fp32
//   rounding, so no TF32 and no 3xTF32): `conv3x3_f32`, exact on the CUDA
//   cores (67 TFLOP/s of FMA). At path E's shapes (M = B*H*W 128-8,192
//   pixels, 128-512 channels) it is bound by the FMAs where the grid fills
//   the card and by latency where it does not (4x4 and 8x8 maps: 2-8
//   output tiles, each walking 9*C of reduction). Three parts answer that:
//   * a 128-pixel x 128-channel tile a block, an 8x8 register patch a
//     thread, float4 shared-memory reads: 24 reads feed 256 FMAs;
//   * a cp.async ring of STAGES stages (a tap's 16 input channels: the
//     128 x 16 input tile, 16-byte copies with SAME padding, ragged pixels
//     and the channel tail as zero fill; and the weight's 16 x 128), one
//     barrier a stage, the next stages' copies in flight under this one's
//     FMAs; C or CO not a multiple of 4 (C = 3 at the image convs, the VAE's
//     C = 4 / CO = 3 ends) or an unaligned tensor take 4-byte copies, the
//     same kernel;
//   * a split reduction where the output tiles fill the 132 SMs badly
//     (one block an SM: 2-64 tiles at path E's maps, or 192, a wave and a
//     half): the 9 * ceil(C/16) steps cut into contiguous ranges, each a
//     block (grid.z) writing its partial tile to a float32 workspace the
//     wrapper allocates, then `conv3x3_f32_sum` adds the partials in split
//     order and the bias. The host picks the split
//     (ops/conv3x3.py::f32_split) so that every wave of blocks keeps at
//     least 90% of the SMs busy: 128 blocks at the 8x8 to 32x32 maps, not
//     the 136-160 that a "reach 132" rule gives, whose few blocks past the
//     wave nearly double a launch. No atomics: the result is bitwise the
//     same on every launch (bits/dim's RK45 takes its steps on it).
//   The input gradient is the same kernel in its DX mode, which reads the
//   (3,3,C,CO) weight in place as flipped taps with the channels swapped,
//   so no flipped copy is made before a launch.
//
// Accumulation is fp32 for every route; the bias is added in fp32 before
// the one rounding to the output type.

#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- fp32 on the CUDA cores ------------------------------------------------

constexpr int F32_BM = 128;     // output pixels a block
constexpr int F32_BN = 128;     // output channels a block
constexpr int F32_BK = 16;      // input channels of one tap a stage
constexpr int F32_STAGES = 4;   // cp.async ring depth
constexpr int F32_THREADS = 256;
constexpr int F32_PITCH = F32_BK + 4;  // floats a k-contiguous row (16-byte aligned)
// a stage: the input tile [BM][PITCH], then the weight tile, [BK][BN]
// (forward) or [BN][PITCH] (dx)
constexpr int F32_A_FLOATS = F32_BM * F32_PITCH;
constexpr int F32_B_FLOATS = F32_BN * F32_PITCH;
constexpr int F32_STAGE_FLOATS = F32_A_FLOATS + F32_B_FLOATS;
constexpr size_t F32_SMEM = (size_t)F32_STAGES * F32_STAGE_FLOATS * 4;
static_assert(F32_BK * F32_BN <= F32_B_FLOATS && F32_SMEM <= 232448, "227 KB a block");

// The input gradient's weight, read in place: dx = conv(g, w') with
// w'[t][co][c] = w[8 - t][c][co] (the flipped, in/out-swapped weight), so in
// DX mode the kernel's input has the weight's output channels (Cin = CO of
// w) and its output the weight's input channels.
//
// A stage (tap, c0) of the reduction: input channels [c0, c0 + BK) of tap
// `tap`. Step s of 9 * ceil(Cin / BK) is tap s / nch, chunk s % nch.
template <bool DX>
__device__ __forceinline__ void f32_load_stage(float* st, const float* __restrict__ x,
                                               const float* __restrict__ w, int tap, int c0,
                                               long long m0, int n0, int B, int H, int W,
                                               int Cin, int Cout, bool vec_a, bool vec_b,
                                               const int (&pb)[2], const int (&ph)[2],
                                               const int (&pw)[2]) {
  using hopper::cp_async;
  const int tid = threadIdx.x;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  float* as = st;
  float* bs = st + F32_A_FLOATS;
  const long long M = (long long)B * H * W;
  // the input tile: pixel m0 + row, channels c0 + k, SAME padding as zero fill
  if (vec_a) {  // 4 channels a copy: rows tid/4 and tid/4 + 64, chunk tid % 4
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = tid / 4 + 64 * u, c = c0 + 4 * (tid % 4);
      const int ih = ph[u] + dy, iw = pw[u] + dx;
      const bool ok = pb[u] >= 0 && ih >= 0 && ih < H && iw >= 0 && iw < W && c < Cin;
      const float* src = ok ? x + (((long long)pb[u] * H + ih) * W + iw) * Cin + c : x;
      cp_async<16>(as + row * F32_PITCH + 4 * (tid % 4), src, ok);
    }
  } else {
    for (int e = tid; e < F32_BM * F32_BK; e += F32_THREADS) {
      const int row = e / F32_BK, k = e % F32_BK, c = c0 + k;
      const long long m = m0 + row;
      bool ok = m < M && c < Cin;
      const float* src = x;
      if (ok) {
        const int ow = (int)(m % W), oh = (int)(m / W % H), ob = (int)(m / ((long long)W * H));
        const int ih = oh + dy, iw = ow + dx;
        ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
        if (ok) src = x + (((long long)ob * H + ih) * W + iw) * Cin + c;
      }
      cp_async<4>(as + row * F32_PITCH + k, src, ok);
    }
  }
  // the weight tile: input channel c0 + k, output channel n0 + n
  if constexpr (!DX) {  // w[tap][k][n]: [BK][BN], n contiguous
    if (vec_b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + F32_THREADS * u, k = e / 32, n = 4 * (e % 32);
        const int c = c0 + k, co = n0 + n;
        const bool ok = c < Cin && co < Cout;
        cp_async<16>(bs + k * F32_BN + n, ok ? w + ((long long)tap * Cin + c) * Cout + co : w,
                     ok);
      }
    } else {
      for (int e = tid; e < F32_BK * F32_BN; e += F32_THREADS) {
        const int k = e / F32_BN, n = e % F32_BN, c = c0 + k, co = n0 + n;
        const bool ok = c < Cin && co < Cout;
        cp_async<4>(bs + k * F32_BN + n, ok ? w + ((long long)tap * Cin + c) * Cout + co : w,
                    ok);
      }
    }
  } else {  // w[8 - tap][n][k]: [BN][PITCH], k contiguous
    if (vec_b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + F32_THREADS * u, n = e / 4, k = 4 * (e % 4);
        const int c = c0 + k, co = n0 + n;
        const bool ok = c < Cin && co < Cout;
        cp_async<16>(bs + n * F32_PITCH + k,
                     ok ? w + ((long long)(8 - tap) * Cout + co) * Cin + c : w, ok);
      }
    } else {
      for (int e = tid; e < F32_BK * F32_BN; e += F32_THREADS) {
        const int n = e / F32_BK, k = e % F32_BK, c = c0 + k, co = n0 + n;
        const bool ok = c < Cin && co < Cout;
        cp_async<4>(bs + n * F32_PITCH + k,
                    ok ? w + ((long long)(8 - tap) * Cout + co) * Cin + c : w, ok);
      }
    }
  }
}

// One (128-pixel, 128-channel) output tile, over steps [it0, it1) of the
// reduction (blockIdx.z of `split` contiguous ranges). A thread owns an 8x8
// patch of the tile in registers: pixel rows 4ty + i and 64 + 4ty + i
// (i < 4); output channels 4tx + j and 64 + 4tx + j in the forward, tx +
// 16j in dx, which keeps each mode's weight reads on distinct banks. A
// stage is four k-quads, each in two halves of the channels: per half a
// thread reads its 4 x 4 weight values (4 float4 reads), then per pixel row
// one float4 of 4 input channels, and makes 16 FMAs of it: 24 shared reads
// feed 256 FMAs. One block an SM: capped at the 128 registers two blocks
// would allow, ptxas spills the copies' addresses (96 and 180 bytes) and a
// block runs 13% slower. With `split` 1 the
// tile is written with the bias; else its partial sum goes to
// ws[blockIdx.z] and conv3x3_f32_sum adds the partials in split order.
template <bool DX>
__global__ void __launch_bounds__(F32_THREADS, 1)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ ws,
            int B, int H, int W, int Cin, int Cout, int split, int vec_a, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * F32_BM;
  const int n0 = blockIdx.y * F32_BN;
  const int nch = (Cin + F32_BK - 1) / F32_BK, steps = 9 * nch;
  const int it0 = (int)((long long)steps * blockIdx.z / split);
  const int it1 = (int)((long long)steps * (blockIdx.z + 1) / split);

  // the two pixels this thread copies for the 16-byte input path (-1: past M)
  int pb[2], ph[2], pw[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long m = m0 + tid / 4 + 64 * u;
    const bool in = m < M;
    const long long mm = in ? m : 0;
    pw[u] = (int)(mm % W);
    ph[u] = (int)(mm / W % H);
    pb[u] = in ? (int)(mm / ((long long)W * H)) : -1;
  }

  auto load = [&](int slot, int it) {
    f32_load_stage<DX>(smem + slot * F32_STAGE_FLOATS, x, w, it / nch, (it % nch) * F32_BK, m0,
                       n0, B, H, W, Cin, Cout, vec_a != 0, vec_b != 0, pb, ph, pw);
  };
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (it0 + s < it1) load(s, it0 + s);
    hopper::cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = it0; it < it1; ++it) {
    hopper::cp_async_wait<F32_STAGES - 2>();
    __syncthreads();  // step it's stage is visible; the stage read last step is free
    const int next = it + F32_STAGES - 1;
    if (next < it1) load((next - it0) % F32_STAGES, next);
    hopper::cp_async_commit();

    const float* as = smem + ((it - it0) % F32_STAGES) * F32_STAGE_FLOATS;
    const float* bs = as + F32_A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < F32_BK; kq += 4) {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {  // output channels j = 4 jh .. 4 jh + 3
        float b[4][4];  // [k][output channel j - 4 jh]
        if constexpr (!DX) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 v =
                *reinterpret_cast<const float4*>(bs + (kq + kk) * F32_BN + 64 * jh + 4 * tx);
            b[kk][0] = v.x, b[kk][1] = v.y, b[kk][2] = v.z, b[kk][3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(bs + (tx + 16 * (4 * jh + j)) * F32_PITCH + kq);
            b[0][j] = v.x, b[1][j] = v.y, b[2][j] = v.z, b[3][j] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = 4 * ty + (i % 4) + 64 * (i / 4);
          const float4 a = *reinterpret_cast<const float4*>(as + row * F32_PITCH + kq);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * jh + j] = fmaf(av[kk], b[kk][j], acc[i][4 * jh + j]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block (the empty tail groups)

  float* dst = split == 1 ? out : ws + (long long)blockIdx.z * M * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + 4 * ty + (i % 4) + 64 * (i / 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (DX ? tx + 16 * j : 4 * tx + (j % 4) + 64 * (j / 4));
      if (n >= Cout) continue;
      dst[m * Cout + n] = split == 1 && bias != nullptr ? acc[i][j] + bias[n] : acc[i][j];
    }
  }
}

// out = (((0 + ws[0]) + ws[1]) + ... + ws[split - 1]) + bias: the partial
// sums of a split reduction in split order, so a launch's result does not
// depend on which block finished first
__global__ void __launch_bounds__(256)
conv3x3_f32_sum(const float* __restrict__ ws, const float* __restrict__ bias,
                float* __restrict__ out, long long MN, int Cout, int split) {
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < MN; e += (long long)gridDim.x * 256) {
    float acc = 0.f;
    for (int z = 0; z < split; ++z) acc += ws[z * MN + e];
    out[e] = bias != nullptr ? acc + bias[e % Cout] : acc;
  }
}

// ---- bf16, narrow channels: mma.sync over a halo patch in shared memory ----

// A block owns an output patch of NR_PH rows x NR_PW pixels of one image;
// its input is that patch with a one-pixel halo (NR_PH + 2 rows of NR_XW pixels).
constexpr int NR_THREADS = 256;  // 8 warps
constexpr int NR_PH = 16;        // output rows a patch
constexpr int NR_PW = 16;        // output pixels a row: one m16 tile
constexpr int NR_MT = NR_PH / (NR_THREADS / 32);  // patch rows (m16 tiles) a warp
static_assert(NR_MT * (NR_THREADS / 32) == NR_PH, "whole rows a warp");
constexpr int NR_STAGES = 2;     // cp.async ring depth
constexpr int NR_XW = NR_PW + 2;                  // the halo patch's row
constexpr int NR_XPIX = (NR_PH + 2) * NR_XW;      // its 324 pixels
// bf16 a row of KC reduction values in shared memory (a pixel's channels, a
// weight row's): an odd multiple of 16 bytes, so the 8 rows one ldmatrix
// reads (8 neighbouring pixels, or 8 output channels) fall on distinct banks
template <int KC>
__host__ __device__ constexpr int nr_pitch() { return KC == 8 ? 8 : KC + 8; }
// a stage: the halo patch's KC channels, then the weight tile [9][8 NT][KC]
template <int KC, int NT>
__host__ __device__ constexpr int nr_stage_elems() { return (NR_XPIX + 9 * 8 * NT) * nr_pitch<KC>(); }
template <int KC, int NT>
constexpr size_t nr_smem() { return (size_t)NR_STAGES * nr_stage_elems<KC, NT>() * 2; }
static_assert(nr_smem<64, 1>() <= 232448 && nr_smem<32, 8>() <= 232448, "227 KB a block");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x1(uint32_t& r0, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r0) : "r"(addr));
}
// d += a (16 x 16, rows) * b (16 x 8, columns), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16 x 8) * b (8 x 8): the 8-deep reduction of a narrow C
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The "narrow" route: out (B,H,W,Cout) = bias + conv(x (B,H,W,Cin), w) for
// any Cin, Cout >= 1 and any base alignment. wp is the weight in the layout
// a stage reads, made by the wrapper (ops/conv3x3.py::narrow_weight):
// [9][npad][cpad] bf16, tap-major, a row of each output channel's input
// channels (k contiguous), zero past Cin and Cout, cpad = ceil(Cin/KC) KC and
// npad = ceil(Cout/8NT) 8NT; so its copies are whole 16-byte cp.asyncs with
// no mask. KC: input channels a stage (8: Cin <= 8, one m16n8k8 a tap;
// else 64 where Cout <= 8, four m16n8k16, and 32 beside a wide Cout, whose
// 64-column weight tile would not fit twice at 64), NT: 8-column output
// tiles a pass (1: Cout <= 8; 8: 64 columns a pass).
//
// The work is units (output patch, pass of 8 NT output channels), patch-major,
// each walking the ceil(Cin / KC) channel chunks. The grid is persistent: at
// most the blocks the SMs hold at once, block i taking units i, i +
// gridDim.x, ... So the ring runs on from one unit to the next and the next
// unit's copies overlap this one's products, and the passes of one patch
// (conv_in's 8) run in neighbouring blocks at once, its input read from
// device memory once and from L2 by the rest. A step's stage holds the halo
// patch's channels [cc KC, cc KC + KC) and the weight tile of (pass, cc), and
// every tap reads the patch at its offset, so an input pixel is copied into
// shared memory once a pass and read there by all 9 taps, not fetched once
// per tap. Lane l of a warp gives ldmatrix the address of patch pixel (row,
// l % 16 + dx) of tap (dy, dx), so one A fragment is 16 output pixels
// shifted by the tap. `vec`: bf16 a copy of x (8, 4, 2: 16-, 8-, 4-byte
// cp.async; 1: a plain load), the largest that divides Cin and x's
// alignment; a thread copies the same channels of every NR_THREADS /
// (KC / vec)-th pixel. The shape of the block (16 x 16 patches, 8 warps of
// two m16 rows, two stages of 64 channels) is what a sweep on the card
// found fastest at conv_out, against 8- and 32-row patches, 4 or 16 warps,
// three or four stages and 16 or 32 channels a stage: a deeper ring leaves
// fewer blocks on an SM to hide the copies, and a taller patch re-copies
// fewer halo pixels (18 x 18 for 256 outputs, not 10 x 18 for 128) and
// spreads each B fragment over more rows.
template <int KC, int NT>
__global__ void __launch_bounds__(NR_THREADS)
conv3x3_narrow(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
               int Cin, int Cout, int vec, int tiles_h, int tiles_w, int units) {
  using hopper::cp_async;
  constexpr int P = nr_pitch<KC>(), NB = 8 * NT, XE = NR_XPIX * P;
  constexpr int SE = nr_stage_elems<KC, NT>();
  constexpr int KSTEP = KC == 8 ? 8 : 16;
  extern __shared__ __align__(16) uint8_t nsm_raw[];
  __nv_bfloat16* nsm = reinterpret_cast<__nv_bfloat16*>(nsm_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_c = (Cin + KC - 1) / KC, n_n = (Cout + NB - 1) / NB;
  const int cpad = n_c * KC, npad = n_n * NB;
  const int steps = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * n_c;
  // this thread's copies of x: channels [kx, kx + vec) of the chunk at the
  // patch pixels tid / parts + j * pstep
  const int parts = KC / vec, kx = tid % parts * vec, pstep = NR_THREADS / parts;

  struct Step { int b, h0, w0, nn, cc; };
  auto decode = [&](int s) {
    const int u = (int)blockIdx.x + s / n_c * (int)gridDim.x, p = u / n_n;
    return Step{p / (tiles_w * tiles_h), p / tiles_w % tiles_h * NR_PH, p % tiles_w * NR_PW,
                u % n_n, s % n_c};
  };
  auto load = [&](int slot, int s) {
    const Step t = decode(s);
    __nv_bfloat16* st = nsm + slot * SE;
    // the halo patch, channels [c0, c0 + KC); SAME padding and the channel tail as zeros
    const int c = t.cc * KC + kx;
    for (int pix = tid / parts; pix < NR_XPIX; pix += pstep) {
      const int ih = t.h0 + pix / NR_XW - 1, iw = t.w0 + pix % NR_XW - 1;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < Cin;
      const __nv_bfloat16* src = ok ? x + (((long long)t.b * H + ih) * W + iw) * Cin + c : x;
      __nv_bfloat16* dst = st + pix * P + kx;
      if (vec == 8) cp_async<16>(dst, src, ok);
      else if (vec == 4) cp_async<8>(dst, src, ok);
      else if (vec == 2) cp_async<4>(dst, src, ok);
      else *dst = ok ? *src : __float2bfloat16(0.f);
    }
    // the weight tile: rows (tap, n) of pass nn, k in chunk cc, 8 bf16 a copy
    constexpr int WPARTS = KC / 8;
    for (int e = tid; e < 9 * NB * WPARTS; e += NR_THREADS) {
      const int row = e / WPARTS, k = (e % WPARTS) * 8, tap = row / NB, n = row % NB;
      cp_async<16>(st + XE + row * P + k,
                   wp + ((long long)tap * npad + t.nn * NB + n) * cpad + t.cc * KC + k, true);
    }
  };

  // ldmatrix rows of this lane: A, output pixel column l % 16 of patch rows
  // NR_MT warp + mt (k8: lanes 0-15 give the addresses; k16: lanes 16-31 the
  // second 8 channels); B, output channel l % 8 of each 8-column tile (k16:
  // lanes 8-15 the second 8 channels)
  const int a_k = KC == 8 ? 0 : (lane / 16) * 8, b_k = KC == 8 ? 0 : (lane / 8 % 2) * 8;
  int a_off[NR_MT];
#pragma unroll
  for (int mt = 0; mt < NR_MT; ++mt)
    a_off[mt] = ((NR_MT * warp + mt) * NR_XW + lane % 16) * P + a_k;
  const int b_off = (lane % 8) * P + b_k;

  float acc[NR_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < NR_MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < NR_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    hopper::cp_async_wait<NR_STAGES - 2>();
    __syncthreads();  // step it's stage is visible; the stage read last step is free
    const int next = it + NR_STAGES - 1;
    if (next < steps) load(next % NR_STAGES, next);
    hopper::cp_async_commit();

    const uint32_t xs = hopper::smem_u32(nsm + it % NR_STAGES * SE);
    const uint32_t ws = xs + 2 * XE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int t_off = ((tap / 3) * NR_XW + tap % 3) * P;
#pragma unroll
      for (int kk = 0; kk < KC; kk += KSTEP) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t addr = ws + 2 * ((tap * NB + 8 * j) * P + b_off + kk);
          if constexpr (KC == 8) ldsm_x1(bf[j][0], addr);
          else ldsm_x2(bf[j][0], bf[j][1], addr);
        }
#pragma unroll
        for (int mt = 0; mt < NR_MT; ++mt) {
          const uint32_t addr = xs + 2 * (a_off[mt] + t_off + kk);
          if constexpr (KC == 8) {
            uint32_t a0, a1;
            ldsm_x2(a0, a1, addr);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k8(acc[mt][j], a0, a1, bf[j][0]);
          } else {
            uint32_t a[4];
            ldsm_x4(a, addr);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_k16(acc[mt][j], a, bf[j][0], bf[j][1]);
          }
        }
      }
    }
    const Step t = decode(it);
    if (t.cc != n_c - 1) continue;
    // the pass is done: + bias in fp32, one rounding to bf16; this thread
    // holds pixels (NR_MT warp + mt, l / 4 and l / 4 + 8), columns 2 (l % 4)
    // (+1) of every 8
    const int n_base = t.nn * NB + 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < NR_MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int oh = t.h0 + NR_MT * warp + mt, ow = t.w0 + lane / 4 + 8 * r;
        if (oh >= H || ow >= W) continue;
        __nv_bfloat16* dst = out + (((long long)t.b * H + oh) * W + ow) * Cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n_base + 8 * j;
          const float v0 = acc[mt][j][2 * r] + (bias != nullptr && n < Cout ? bias[n] : 0.f);
          const float v1 =
              acc[mt][j][2 * r + 1] + (bias != nullptr && n + 1 < Cout ? bias[n + 1] : 0.f);
          if (Cout % 2 == 0 && n + 1 < Cout) {  // 4-byte aligned pair
            *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < Cout) dst[n] = __float2bfloat16(v0);
            if (n + 1 < Cout) dst[n + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < NR_MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block (the empty tail groups)
}

// ---- bf16 on the tensor cores: TMA + wgmma ---------------------------------

constexpr int WG_BN = 128;                // output channels per block
constexpr int WG_STAGES = 3;              // ring depth
constexpr int WG_THREADS = 2 * 128 + 32;  // two consumer warpgroups + the producer warp
constexpr uint32_t WG_A_BYTES = 128 * 128;          // 128 pixels x 64 channels
constexpr uint32_t WG_B_BYTES = 64 * WG_BN * 2;     // 64 channels x 128 outputs
constexpr uint32_t WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
constexpr size_t WG_SMEM = 1024 + WG_STAGES * (size_t)WG_STAGE_BYTES + 16 * WG_STAGES;

__global__ void __launch_bounds__(WG_THREADS, 2)
conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              int B, int H, int W, int C, int CO, int pw, int ph, int pb,
              int tiles_w, int tiles_h, int tiles_n) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;

  // block -> (output-channel tile, patch); channel tiles of one patch are
  // neighbours, so the patch's input is read from L2 by all of them
  const int nt = blockIdx.x % tiles_n;
  const int patch = blockIdx.x / tiles_n;
  const int w0 = (patch % tiles_w) * pw;
  const int h0 = (patch / tiles_w % tiles_h) * ph;
  const int b0 = patch / (tiles_w * tiles_h) * pb;
  const int n0 = nt * WG_BN;
  const int cch = (C + 63) / 64;
  const int niter = 9 * cch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane starts every load
    if (lane == 0) {
      for (int it = 0; it < niter; ++it) {
        const int s = it % WG_STAGES;
        mbar_wait(&empty[s], ((it / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        const int tap = it / cch, c0 = (it % cch) * 64;
        uint8_t* a = ring + s * WG_STAGE_BYTES;
        uint8_t* bt = a + WG_A_BYTES;
        tma_load_4d(a, &xmap, &full[s], c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b0);
        tma_load_3d(bt, &wmap, &full[s], n0, c0, tap);
        tma_load_3d(bt + 64 * 128, &wmap, &full[s], n0 + 64, c0, tap);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns patch pixels [64 wg, 64 wg + 64)
  const int wg = warp / 4;
  float acc[WG_BN / 2];
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int it = 0; it < niter; ++it) {
    const int s = it % WG_STAGES;
    mbar_wait(&full[s], (it / WG_STAGES) & 1);
    const uint32_t a = smem_u32(ring + s * WG_STAGE_BYTES) + wg * 64 * 128;
    const uint32_t bt = smem_u32(ring + s * WG_STAGE_BYTES + WG_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<WG_BN>::ss<1>(acc, desc(a + kk * 32, 16, 1024), desc(bt + kk * 2048, 64 * 128, 1024), 1);
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % WG_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: this thread holds rows (pixels) r and r + 8 of its warp's 16,
  // columns 2(lane%4) (+1) of every 8
  const int quad = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
    const int ow = w0 + m % pw, oh = h0 + m / pw % ph, ob = b0 + m / (pw * ph);
    if (ow >= W || oh >= H || ob >= B) continue;
    __nv_bfloat16* dst = out + (((long long)ob * H + oh) * W + ow) * CO;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * quad;
      if (n >= CO) continue;  // CO % 8 == 0: a pair is in or out as a whole
      const float b0v = bias != nullptr ? bias[n] : 0.f;
      const float b1v = bias != nullptr ? bias[n + 1] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + n) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] + b0v, acc[4 * j + 2 * r + 1] + b1v);
    }
  }
}

int launch_f32(const void* x, const void* w, const void* bias, void* out, void* ws, int B,
               int H, int W, int Cin, int Cout, bool dx, int split, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const int steps = 9 * ((Cin + F32_BK - 1) / F32_BK);
  const long long tiles_m = (M + F32_BM - 1) / F32_BM;
  if (split < 1 || split > steps || split > 65535 || (split > 1 && ws == nullptr) ||
      tiles_m >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies: rows of whole float4s from 16-byte aligned tensors; the
  // input's channels (and, in dx, the weight's k) run along Cin, the
  // forward weight's along Cout
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w);
  const int vec_a = Cin % 4 == 0 && xa % 16 == 0;
  const int vec_b = (dx ? Cin : Cout) % 4 == 0 && wa % 16 == 0;
  cudaError_t err = dx ? hopper::set_smem_once<conv3x3_f32<true>>(F32_SMEM)
                       : hopper::set_smem_once<conv3x3_f32<false>>(F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles_m, (unsigned)((Cout + F32_BN - 1) / F32_BN), (unsigned)split);
  auto* kernel = dx ? conv3x3_f32<true> : conv3x3_f32<false>;
  kernel<<<grid, F32_THREADS, F32_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(ws), B, H,
      W, Cin, Cout, split, vec_a, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long MN = M * Cout;
  const long long blocks = (MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096;
  conv3x3_f32_sum<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias), static_cast<float*>(out),
      MN, Cout, split);
  return (int)cudaGetLastError();
}

template <int KC, int NT>
int launch_narrow_tile(const void* x, const void* wp, const void* bias, void* out, int B,
                       int H, int W, int Cin, int Cout, int vec, cudaStream_t stream) {
  constexpr size_t smem = nr_smem<KC, NT>();
  cudaError_t err = hopper::set_smem_once<conv3x3_narrow<KC, NT>>(smem);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid: as many blocks as the SMs hold at once, or the units
  static int resident[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_narrow<KC, NT>,
                                                        NR_THREADS, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sms;
  }
  const int tiles_h = (H + NR_PH - 1) / NR_PH, tiles_w = (W + NR_PW - 1) / NR_PW;
  const long long units = (long long)B * tiles_h * tiles_w * ((Cout + 8 * NT - 1) / (8 * NT));
  if (units * ((Cin + KC - 1) / KC) >= (1ll << 31) || resident[dev] < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = units < resident[dev] ? (int)units : resident[dev];
  conv3x3_narrow<KC, NT><<<blocks, NR_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, vec,
      tiles_h, tiles_w, (int)units);
  return (int)cudaGetLastError();
}

int launch_narrow(const void* x, const void* wp, const void* bias, void* out, int B, int H,
                  int W, int Cin, int Cout, int kc, int nt, cudaStream_t stream) {
  // the host's tile must be the one its shape takes (ops/conv3x3.py::narrow_tile)
  if (kc != (Cin <= 8 ? 8 : Cout <= 8 ? 64 : 32) || nt != (Cout <= 8 ? 1 : 8) ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // bf16 a copy of x: the largest of 8, 4, 2 that divides Cin and x's
  // alignment, else single values
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int vec = 8;
  while (vec > 1 && (Cin % vec != 0 || xa % (2 * vec) != 0)) vec /= 2;
  if (kc == 8)
    return nt == 1 ? launch_narrow_tile<8, 1>(x, wp, bias, out, B, H, W, Cin, Cout, vec, stream)
                   : launch_narrow_tile<8, 8>(x, wp, bias, out, B, H, W, Cin, Cout, vec, stream);
  return nt == 1 ? launch_narrow_tile<64, 1>(x, wp, bias, out, B, H, W, Cin, Cout, vec, stream)
                 : launch_narrow_tile<32, 8>(x, wp, bias, out, B, H, W, Cin, Cout, vec, stream);
}

int launch_wgmma(const void* x, const void* w, const void* bias, void* out, int B, int H,
                 int W, int C, int CO, int pw, int ph, int pb, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and byte strides; the patch is one 128-pixel box
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out);
  if (C % 8 != 0 || CO % 8 != 0 || any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (pw < 1 || ph < 1 || pb < 1 || pw * ph * pb != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  const uint64_t xdims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xstr[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const uint32_t xbox[4] = {64, (uint32_t)pw, (uint32_t)ph, (uint32_t)pb};
  const uint64_t wdims[3] = {(uint64_t)CO, (uint64_t)C, 9};
  const uint64_t wstr[2] = {2ull * CO, 2ull * CO * C};
  const uint32_t wbox[3] = {64, 64, 1};
  int code = hopper::make_map(&xm, x, 4, xdims, xstr, xbox);
  if (code == 0) code = hopper::make_map(&wm, w, 3, wdims, wstr, wbox);
  if (code != 0) return code;
  cudaError_t err = hopper::set_smem_once<conv3x3_wgmma>(WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + pw - 1) / pw, tiles_h = (H + ph - 1) / ph, tiles_b = (B + pb - 1) / pb;
  const int tiles_n = (CO + WG_BN - 1) / WG_BN;
  const long long blocks = (long long)tiles_n * tiles_w * tiles_h * tiles_b;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  conv3x3_wgmma<<<(unsigned)blocks, WG_THREADS, WG_SMEM, stream>>>(
      xm, wm, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H, W, C, CO,
      pw, ph, pb, tiles_w, tiles_h, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// route (ops/conv3x3.py::conv3x3_plan): 2 = "wgmma", bfloat16 with C % 8 ==
// 0, CO % 8 == 0 and 16-byte aligned tensors (other bf16 shapes take
// dpm_conv3x3_narrow, fp32 dpm_conv3x3_f32). bias is float32 or null. All
// tensors contiguous: x (B,H,W,C), w (3,3,C,CO), out (B,H,W,CO). pw, ph, pb:
// the output patch (pw*ph*pb == 128). Returns the cudaError_t of the launch,
// or a TMA-encoding error code (>= 10000).
extern "C" int dpm_conv3x3_fwd(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C, int CO,
                               int route, int pw, int ph, int pb, void* stream) {
  if (route != 2) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, w, bias, out, B, H, W, C, CO, pw, ph, pb,
                      static_cast<cudaStream_t>(stream));
}

// The "narrow" route, bfloat16, any Cin, Cout and alignment: out (B,H,W,Cout)
// = bias + conv(x (B,H,W,Cin), w), w given as wp, the [9][npad][cpad] layout
// of ops/conv3x3.py::narrow_weight (the forward's weight transposed, or the
// input gradient's flipped one), 16-byte aligned. kc, nt, patch_h, patch_w
// and stages are the host's tile (ops/conv3x3.py::narrow_tile), refused
// unless they are the compiled one for this Cin and Cout. Returns the
// cudaError_t of the launch.
extern "C" int dpm_conv3x3_narrow(const void* x, const void* wp, const void* bias, void* out,
                                  int B, int H, int W, int Cin, int Cout, int kc, int nt,
                                  int patch_h, int patch_w, int stages, void* stream) {
  if (patch_h != NR_PH || patch_w != NR_PW || stages != NR_STAGES)
    return (int)cudaErrorInvalidValue;  // the host's plan is not the compiled one
  return launch_narrow(x, wp, bias, out, B, H, W, Cin, Cout, kc, nt,
                       static_cast<cudaStream_t>(stream));
}

// The "f32" route, x, w and out float32, contiguous. dx = 0: out (B,H,W,
// Cout) = conv(x (B,H,W,Cin), w (3,3,Cin,Cout)) + bias. dx = 1: the input
// gradient, out (B,H,W,Cout) = conv(x, flipped w) for w (3,3,Cout,Cin) read
// in place (x is the cotangent, Cin the forward's output channels). block_m,
// block_n, block_k and stages are the host's tile (ops/conv3x3.py::
// conv3x3_plan), refused unless they are the compiled one; split: the
// reduction's ranges (ops/conv3x3.py::f32_split), 1 .. 9 * ceil(Cin /
// block_k); ws: float32 scratch of
// split * B*H*W * Cout values when split > 1, else null. Returns the
// cudaError_t of the launches.
extern "C" int dpm_conv3x3_f32(const void* x, const void* w, const void* bias, void* out,
                               void* ws, int B, int H, int W, int Cin, int Cout, int dx,
                               int block_m, int block_n, int block_k, int stages, int split,
                               void* stream) {
  if (block_m != F32_BM || block_n != F32_BN || block_k != F32_BK || stages != F32_STAGES)
    return (int)cudaErrorInvalidValue;  // the host's plan is not the compiled one
  return launch_f32(x, w, bias, out, ws, B, H, W, Cin, Cout, dx != 0, split,
                    static_cast<cudaStream_t>(stream));
}
