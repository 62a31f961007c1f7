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
// What bounds it on the H100: at the CIFAR shapes (C, CO >= 128) the conv does
// 2*9*C*CO flops per output pixel against about 2*C + 2*CO bytes, far above
// the card's ~295 flop/byte bf16 ridge, so it is compute-bound: the products
// belong on the tensor cores. Two kernels, chosen by the input dtype:
//
// - bf16 (the model's compute dtype): `conv3x3_bf16_mma`, a 128x64 output
//   tile per block, 8 warps each owning 32x32 of it as 2x2 WMMA 16x16x16
//   bf16 fragments with fp32 accumulators (`mma.sync` on the tensor cores).
//   The reduction is staged through shared memory 32 deep, with 16-byte
//   vector loads where C and CO are multiples of 8. `wgmma` with TMA-fed,
//   multi-stage tiles (the card's full rate) is the later step.
// - fp32: `conv3x3_f32`, the exact form on the CUDA cores (67 TFLOP/s peak):
//   a 64x64 tile per block with a 4x4 micro-tile per thread, so each value
//   read from shared memory feeds four FMAs, the reduction staged 16 deep.
//
// SAME padding is the load's own halo mask: a tap that falls outside the image
// loads 0, so no padded copy of x is ever made in device memory. Ragged C, CO
// and pixel counts are masked the same way, so any width works (the tiny test
// config has C = 32). Accumulation is fp32 for both fp32 and bf16 inputs; the
// bias is added in fp32 before the one rounding to the output type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

int launch_f32(const void* x, const void* w, const void* bias, void* out,
               int B, int H, int W, int C, int CO, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((CO + BN - 1) / BN));
  conv3x3_f32<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, CO);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const void* bias, void* out,
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); bias is float32
// or null. All tensors contiguous: x (B,H,W,C), w (3,3,C,CO), out (B,H,W,CO).
// Returns the cudaError_t of the launch.
extern "C" int dpm_conv3x3_fwd(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C, int CO,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(x, w, bias, out, B, H, W, C, CO, s);
  if (dtype == 1) return launch_bf16(x, w, bias, out, B, H, W, C, CO, s);
  return (int)cudaErrorInvalidValue;
}
