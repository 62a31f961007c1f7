// 3x3, stride-1, SAME conv in NHWC as an implicit GEMM, for sm_90a.
//
// Replaces the Pallas slab kernel dpm_solver_tpu/ops/conv3x3.py::_pallas_conv3x3
// (kernel body `_kernel`). That kernel streamed full-width row slabs through
// VMEM with neighbour-indexed halo copies and a 128-channel-group accumulator
// carried across the sequential grid. On Hopper blocks run in parallel and in
// no order, so nothing is carried between them: each block owns one output
// tile and walks the whole reduction (9 taps x C channels) itself.
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
// - "wmma" (bf16 with C or CO not a multiple of 8, where TMA cannot stride:
//   the VAE's conv_in with C = 4, its conv_out with CO = 3, ragged shapes):
//   `conv3x3_bf16_mma`, a 128x64 output tile per block, 8 warps each owning
//   32x32 of it as 2x2 WMMA 16x16x16 bf16 fragments with fp32 accumulators
//   (`mma.sync`), the reduction staged through shared memory 32 deep.
// - "f32": `conv3x3_f32`, the exact form on the CUDA cores (67 TFLOP/s peak):
//   a 64x64 tile per block with a 4x4 micro-tile per thread, so each value
//   read from shared memory feeds four FMAs, the reduction staged 16 deep.
//
// In the two older kernels SAME padding is the load's own halo mask: a tap
// that falls outside the image loads 0, so no padded copy of x is ever made
// in device memory; ragged C, CO and pixel counts are masked the same way.
// Accumulation is fp32 for every route; the bias is added in fp32 before
// the one rounding to the output type.

#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction depth staged per step
constexpr int TM = 4;    // micro-tile rows per thread
constexpr int TN = 4;    // micro-tile cols per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out,
            int B, int H, int W, int C, int CO) {
  // [k][pixel]; rows padded by 4 floats so the transposing stores below
  // spread over banks while rows stay 16-byte aligned for float4 reads
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];  // [k][out channel]

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: thread -> (k lane, 4 pixel rows); consecutive threads read
  // consecutive channels of one pixel, which are contiguous in NHWC.
  const int a_k = tid % BK;
  const int a_m = tid / BK;  // 0..15, rows a_m + 16*i
  int pb[BM / 16], ph[BM / 16], pw[BM / 16];
  bool pvalid[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    long long m = m0 + a_m + 16 * i;
    pvalid[i] = m < M;
    long long mm = pvalid[i] ? m : 0;
    pw[i] = (int)(mm % W);
    long long r = mm / W;
    ph[i] = (int)(r % H);
    pb[i] = (int)(r / H);
  }
  // B loads: thread -> (k row, 4 channels); consecutive threads read
  // consecutive output channels, contiguous in the (3,3,C,CO) weight.
  const int b_n = tid % BN;
  const int b_k = tid / BN;  // 0..3, rows b_k + 4*i

  const int ty = tid / (BN / TN);  // micro-tile row group
  const int tx = tid % (BN / TN);  // micro-tile col group
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    // base offset of each of this thread's A pixels for this tap (-1 = halo)
    long long abase[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      int ih = ph[i] + dy, iw = pw[i] + dx;
      bool in = pvalid[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      abase[i] = in ? (((long long)pb[i] * H + ih) * W + iw) * C : -1;
    }
    for (int c0 = 0; c0 < C; c0 += BK) {
      const int c = c0 + a_k;
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        float v = 0.f;
        if (abase[i] >= 0 && c < C) v = x[abase[i] + c];
        As[a_k][a_m + 16 * i] = v;
      }
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int kk = b_k + 4 * i;
        const int cc = c0 + kk;
        const int n = n0 + b_n;
        float v = 0.f;
        if (cc < C && n < CO) v = w[((long long)tap * C + cc) * CO + n];
        Bs[kk][b_n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
        const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= CO) continue;
      out[m * CO + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------

namespace mma = nvcuda::wmma;
constexpr int MM = 128;           // output pixels per block
constexpr int MN = 64;            // output channels per block
constexpr int MK = 32;            // reduction depth staged per step
constexpr int LDA = MK + 8;       // smem row pitch (bf16) of the A tile
constexpr int LDB = MN + 8;       // smem row pitch (bf16) of the B tile
constexpr int LDC = MN + 4;       // smem row pitch (fp32) of the output tile
constexpr int MMA_THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int A_BYTES = MM * LDA * 2, B_BYTES = MK * LDB * 2, C_BYTES = MM * LDC * 4;
constexpr int MMA_SMEM = (A_BYTES + B_BYTES > C_BYTES) ? A_BYTES + B_BYTES : C_BYTES;

__global__ void __launch_bounds__(MMA_THREADS)
conv3x3_bf16_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int B, int H, int W, int C, int CO, bool vec_x, bool vec_w) {
  // the A/B staging tiles and the fp32 output tile share one buffer
  __shared__ __align__(128) unsigned char smem[MMA_SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);            // [MM][LDA]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);  // [MK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                            // [MM][LDC]

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // this warp's 32x32 sub-tile
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * MM;
  const int n0 = blockIdx.y * MN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // A rows this thread stages in the vector path: r = tid/4 and r + 64,
  // 8 channels each at k offset 8*(tid%4) (4 threads cover 32 channels)
  const int a_row = tid / 4, a_k = 8 * (tid % 4);
  int pb[2], ph[2], pw[2];
  bool pvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + a_row + 64 * i;
    pvalid[i] = m < M;
    const long long mm = pvalid[i] ? m : 0;
    pw[i] = (int)(mm % W);
    ph[i] = (int)((mm / W) % H);
    pb[i] = (int)(mm / ((long long)W * H));
  }
  // B: this thread stages 8 output channels of one k row in the vector path
  const int b_k = tid / 8, b_n = 8 * (tid % 8);

  mma::fragment<mma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) mma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    long long abase[2];  // NHWC offset of each staged pixel for this tap, -1 = halo
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = ph[i] + dy, iw = pw[i] + dx;
      const bool in = pvalid[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      abase[i] = in ? (((long long)pb[i] * H + ih) * W + iw) * C : -1;
    }
    for (int c0 = 0; c0 < C; c0 += MK) {
      if (vec_x) {  // C % 8 == 0: a chunk of 8 channels is in or out as a whole
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint4 v = make_uint4(0, 0, 0, 0);
          const int c = c0 + a_k;
          if (abase[i] >= 0 && c < C) v = *reinterpret_cast<const uint4*>(x + abase[i] + c);
          *reinterpret_cast<uint4*>(As + (a_row + 64 * i) * LDA + a_k) = v;
        }
      } else {
        for (int e = tid; e < MM * MK; e += MMA_THREADS) {
          const int r = e / MK, kk = e % MK, c = c0 + kk;
          const long long m = m0 + r;
          __nv_bfloat16 v = zero;
          if (m < M && c < C) {
            const int ow = (int)(m % W), oh = (int)((m / W) % H);
            const int ih = oh + dy, iw = ow + dx;
            const long long b = m / ((long long)W * H);
            if (ih >= 0 && ih < H && iw >= 0 && iw < W)
              v = x[((b * H + ih) * W + iw) * C + c];
          }
          As[r * LDA + kk] = v;
        }
      }
      if (vec_w) {  // CO % 8 == 0
        uint4 v = make_uint4(0, 0, 0, 0);
        const int c = c0 + b_k, n = n0 + b_n;
        if (c < C && n < CO)
          v = *reinterpret_cast<const uint4*>(w + ((long long)tap * C + c) * CO + n);
        *reinterpret_cast<uint4*>(Bs + b_k * LDB + b_n) = v;
      } else {
        for (int e = tid; e < MK * MN; e += MMA_THREADS) {
          const int kk = e / MN, nn = e % MN, c = c0 + kk, n = n0 + nn;
          Bs[kk * LDB + nn] =
              (c < C && n < CO) ? w[((long long)tap * C + c) * CO + n] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MK; kk += 16) {
        mma::fragment<mma::matrix_a, 16, 16, 16, __nv_bfloat16, mma::row_major> fa[2];
        mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue through shared memory: + bias in fp32, one rounding to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                             LDC, mma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < MM * MN; e += MMA_THREADS) {
    const int r = e / MN, nn = e % MN;
    const long long m = m0 + r;
    const int n = n0 + nn;
    if (m < M && n < CO)
      out[m * CO + n] = __float2bfloat16(Cs[r * LDC + nn] + (bias != nullptr ? bias[n] : 0.f));
  }
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

int launch_f32(const void* x, const void* w, const void* bias, void* out,
               int B, int H, int W, int C, int CO, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((CO + BN - 1) / BN));
  conv3x3_f32<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, CO);
  return (int)cudaGetLastError();
}

int launch_wmma(const void* x, const void* w, const void* bias, void* out,
                int B, int H, int W, int C, int CO, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + MM - 1) / MM), (unsigned)((CO + MN - 1) / MN));
  // 16-byte vector loads need 8-channel rows and 16-byte aligned bases
  const bool vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = CO % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  conv3x3_bf16_mma<<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H, W, C, CO,
      vec_x, vec_w);
  return (int)cudaGetLastError();
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

// route (ops/conv3x3.py::conv3x3_plan): 0 = "f32" (x, w, out float32),
// 1 = "wmma" and 2 = "wgmma" (bfloat16; "wgmma" needs C % 8 == 0, CO % 8 == 0
// and 16-byte aligned tensors). bias is float32 or null. All tensors
// contiguous: x (B,H,W,C), w (3,3,C,CO), out (B,H,W,CO). pw, ph, pb: the
// "wgmma" route's output patch (pw*ph*pb == 128), ignored by the others.
// Returns the cudaError_t of the launch, or a TMA-encoding error code (>= 10000).
extern "C" int dpm_conv3x3_fwd(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C, int CO,
                               int route, int pw, int ph, int pb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) return launch_f32(x, w, bias, out, B, H, W, C, CO, s);
  if (route == 1) return launch_wmma(x, w, bias, out, B, H, W, C, CO, s);
  if (route == 2) return launch_wgmma(x, w, bias, out, B, H, W, C, CO, pw, ph, pb, s);
  return (int)cudaErrorInvalidValue;
}
