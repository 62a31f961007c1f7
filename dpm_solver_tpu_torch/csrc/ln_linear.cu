// LayerNorm -> Linear, out = LN(x; gamma, beta) . W^T (+ bias), for sm_90a.
//
// Replaces the Pallas kernel dpm_solver_tpu/ops/ln_linear.py::_fused_call
// (bodies `_kernel_core`, `_kernel_bias`, `_kernel_nobias`). That kernel
// normalised a row tile once into VMEM scratch on the first step of a
// sequential grid axis and streamed weight column tiles against it on the
// later steps. Hopper blocks run in parallel and in no order, so nothing is
// carried between them: a block normalises its own row tile into shared
// memory and then walks a run of weight column tiles against it itself.
//
//   xn = (x - mean) * rsqrt(var + eps) * gamma + beta   (fp32 statistics,
//        two-pass variance E[(x - mean)^2], then one rounding to W's dtype)
//   out[m, n] = sum_k xn[m, k] * W[n, k] (+ bias[n])    (fp32 accumulator)
//
// W is in torch's Linear layout, (n, d) row-major, so a module passes its
// weight as it holds it, with no transpose. This is the rounding of
// ln_linear_reference exactly; the normalised tile never reaches device
// memory.
//
// What bounds it on the H100: the product does 2 d n flops a row against
// 2 (d + n) bytes of x and out. At the SD-2.1 qkv site with d = 320
// (n = 960) that is 240 flops a byte, under the card's ~295 bf16 ridge:
// byte-bound, so x must be read once and the output written once, at
// HBM rate; at d = 640 and 1,280 (n = d or 3d) it is compute-bound, so the
// products belong on the tensor cores at their full rate, which only `wgmma`
// fed by TMA reaches. Three kernels, by route (ops/ln_linear.py::ln_linear_plan):
//
// - "wgmma" (bf16, d % 8 == 0, n % 8 == 0, the row tile within the
//   resident budget, 16-byte aligned tensors): `ln_linear_wgmma`. A block
//   owns BM rows (64 at d <= 320, two blocks an SM; 128 at d <= 640; 64
//   above, or where 128-row tiles leave the card short of blocks) and a run
//   of 128-column output tiles.
//   1. TMA brings the raw bf16 rows in as ceil(d/64) 128-byte-swizzled
//      64-column tiles, the layout `wgmma` reads, and stays resident:
//      BM x d x 2 bytes, 160 KB at d = 640 (BM 128) and 1,280 (BM 64). At
//      d = 320 the plan takes BM = 64 (40 KB): two blocks share an SM, so
//      one's statistics and stores run under the other's products.
//   2. The consumer warps take each row's fp32 mean and two-pass variance
//      from shared memory and overwrite the tile in place with the
//      normalised bf16 values, eight lanes a row and four rows a warp at
//      once. The swizzle permutes the 16-byte chunks of a row (chunk q of
//      row r sits at q ^ (r % 8)), so a lane takes one logical chunk of
//      every 64-column tile, reads it where the swizzle put it, and keeps
//      its gamma and beta columns from row to row; columns past d are
//      written as 0. Eight lanes a row keep four rows' reductions in
//      flight a warp, and float4 loads of gamma and beta serve every row.
//   3. Those are generic-proxy writes that `wgmma` (the async proxy) reads:
//      each writer runs `fence.proxy.async.shared::cta` and a named barrier
//      over the consumers orders them before the first product. Without the
//      fence the products may read the raw rows.
//   4. Meanwhile the producer warp has started streaming W (n, d) tiles,
//      128 rows by 64 along d, through a ring of stages guarded by full and
//      empty mbarriers; the ring runs on across the block's column tiles,
//      so the next tile's loads overlap this tile's epilogue. Two consumer
//      warpgroups split the block's rows (m64n128k16 each) or, at BM = 64,
//      its columns (m64n64k16), against the resident A.
//   5. The epilogue adds the fp32 bias and writes bf16 pairs straight from
//      the accumulators, masking the ragged n (960 = 7.5 tiles) and M.
//   Where the row tiles alone leave the card short of blocks, the column
//   tiles split into runs across blockIdx.y, each block renormalising its
//   rows (x is read once per run, mostly from L2).
//   Where the row tile is wider than the budget beside two W stages (64
//   rows of d = 1,792, the retrieval LDM's middle block: 224 KB), the same
//   kernel keeps it in segments of `seg` 64-column tiles (SEG): the
//   consumers first take each row's statistics from device memory (x is
//   read twice, mostly from L2), then for every output tile each segment
//   is loaded by TMA, normalised in place and multiplied; an `aempty`
//   barrier hands the segment's buffer back to the producer once every
//   consumer warp's products on it are done. The resident form's code and
//   layout are unchanged (SEG = false).
// - "wmma" (bf16 with widths TMA cannot stride, d <= 1,536):
//   `ln_linear_bf16_mma`, the first kernel: a 64-row tile
//   normalised in padded shared memory, 64x64 output tiles from 4 warps of
//   WMMA 16x16x16 fragments (`mma.sync`), W staged 32 deep, synchronously.
// - "f32": `ln_linear_f32`, the exact form on the CUDA cores: 16 rows per
//   block, normalised in fp32 shared memory (d <= 3,632), each thread four
//   rows of one column.

#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over each aligned group of eight lanes
__device__ __forceinline__ float row8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
  }
  return n;
}

// split `col_tiles` column tiles into runs so that row_tiles * runs covers
// the SMs about twice; returns the run length
int tiles_per_run(long long row_tiles, int col_tiles) {
  const long long want = 2LL * sm_count();
  long long runs = (want + row_tiles - 1) / row_tiles;
  if (runs < 1) runs = 1;
  if (runs > col_tiles) runs = col_tiles;
  return (int)((col_tiles + runs - 1) / runs);
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int BM = 64;            // rows per block
constexpr int BN = 64;            // output columns per tile
constexpr int BK = 32;            // weight rows staged per step
constexpr int THREADS = 128;      // 4 warps, 2x2 over the 64x64 tile
constexpr int LDW = BK + 8;       // bf16 weight tile pitch: [BN][LDW], one row of W each
constexpr int LDC = BN + 4;       // fp32 output tile pitch

struct Layout {                   // byte offsets into dynamic shared memory
  int kpad, lda;
  size_t a, w, c, bytes;
};

__host__ __device__ inline Layout layout(int d) {
  Layout s;
  s.kpad = (d + BK - 1) / BK * BK;
  s.lda = s.kpad + 8;
  s.a = 0;
  s.w = s.a + (size_t)BM * s.lda * 2;
  s.c = s.w + (size_t)BN * LDW * 2;
  s.bytes = s.c + (size_t)BM * LDC * 4;
  return s;
}

__global__ void __launch_bounds__(THREADS)
ln_linear_bf16_mma(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out, int M, int d,
                   int n, int run, float eps, bool vec_x, bool vec_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d);
  bf16* As = reinterpret_cast<bf16*>(smem + L.a);   // [BM][lda] rows, then normalised
  bf16* Ws = reinterpret_cast<bf16*>(smem + L.w);   // [BN][LDW]: W[n0 + c, k0 + kk]
  float* Cs = reinterpret_cast<float*>(smem + L.c); // [BM][LDC]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const bf16 zero = __float2bfloat16(0.f);

  // 1. the raw rows, zero past M and in the columns [d, kpad)
  if (vec_x) {
    const int chunks = L.kpad / 8;
    for (int e = tid; e < BM * chunks; e += THREADS) {
      const int r = e / chunks, c = 8 * (e % chunks);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && c < d) v = *reinterpret_cast<const uint4*>(x + (m0 + r) * d + c);
      *reinterpret_cast<uint4*>(As + r * L.lda + c) = v;
    }
  } else {
    for (int e = tid; e < BM * L.kpad; e += THREADS) {
      const int r = e / L.kpad, c = e % L.kpad;
      As[r * L.lda + c] = (m0 + r < M && c < d) ? x[(m0 + r) * d + c] : zero;
    }
  }
  __syncthreads();

  // 2. fp32 statistics per row (warp w takes rows w, w+4, ...), normalised in place
  for (int r = warp; r < BM; r += THREADS / 32) {
    bf16* row = As + r * L.lda;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += __bfloat162float(row[c]);
    const float mean = warp_sum(s) / d;
    float var = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = __bfloat162float(row[c]) - mean;
      var += t * t;
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
    __syncwarp();
    for (int c = lane; c < d; c += 32)
      row[c] = __float2bfloat16((__bfloat162float(row[c]) - mean) * rstd * gamma[c] + beta[c]);
  }
  __syncthreads();

  // 3. this block's run of 64-wide column tiles
  const int wr = warp % 2, wc = warp / 2;  // this warp's 32x32 sub-tile
  const int col_tiles = (n + BN - 1) / BN;
  const int t_end = min(col_tiles, (int)(blockIdx.y + 1) * run);
  for (int t = blockIdx.y * run; t < t_end; ++t) {
    const int n0 = t * BN;
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < L.kpad; k0 += BK) {
      if (vec_w) {  // d % 8 == 0: a chunk of 8 along d is in or out as a whole
        for (int e = tid; e < BN * BK / 8; e += THREADS) {
          const int c = e / (BK / 8), kk = 8 * (e % (BK / 8));
          uint4 v = make_uint4(0, 0, 0, 0);
          if (n0 + c < n && k0 + kk < d)
            v = *reinterpret_cast<const uint4*>(w + (long long)(n0 + c) * d + k0 + kk);
          *reinterpret_cast<uint4*>(Ws + c * LDW + kk) = v;
        }
      } else {
        for (int e = tid; e < BN * BK; e += THREADS) {
          const int c = e / BK, kk = e % BK;
          Ws[c * LDW + kk] =
              (n0 + c < n && k0 + kk < d) ? w[(long long)(n0 + c) * d + k0 + kk] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa[2];
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wm::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * L.lda + k0 + kk, L.lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wm::load_matrix_sync(fb[j], Ws + (wc * 32 + j * 16) * LDW + kk, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue through shared memory: + bias in fp32, one rounding to bf16
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
                              LDC, wm::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const long long m = m0 + r;
      const int nn = n0 + c;
      if (m < M && nn < n)
        out[m * n + nn] = __float2bfloat16(Cs[r * LDC + c] + (bias != nullptr ? bias[nn] : 0.f));
    }
    __syncthreads();  // Cs is rewritten by the next tile
  }
}

// ---- fp32 on the CUDA cores -------------------------------------------------

constexpr int FM = 16;            // rows per block
constexpr int FN = 64;            // output columns per tile
constexpr int FTHREADS = 256;     // tid % 64: column; tid / 64: four rows

__global__ void __launch_bounds__(FTHREADS)
ln_linear_f32(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int M, int d, int n,
              int run, float eps) {
  extern __shared__ __align__(16) float xs[];  // [FM][d]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * FM;
  const long long rows = min((long long)FM, (long long)M - m0);
  for (int e = tid; e < FM * d; e += FTHREADS) xs[e] = e < rows * d ? x[m0 * d + e] : 0.f;
  __syncthreads();
  for (int r = warp; r < FM; r += FTHREADS / 32) {
    float* row = xs + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += row[c];
    const float mean = warp_sum(s) / d;
    float var = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float t = row[c] - mean;
      var += t * t;
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
    __syncwarp();
    for (int c = lane; c < d; c += 32) row[c] = (row[c] - mean) * rstd * gamma[c] + beta[c];
  }
  __syncthreads();

  const int col = tid % FN, rg = tid / FN;
  const int col_tiles = (n + FN - 1) / FN;
  const int t_end = min(col_tiles, (int)(blockIdx.y + 1) * run);
  for (int t = blockIdx.y * run; t < t_end; ++t) {
    const int nn = t * FN + col;
    if (nn >= n) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < d; ++k) {
      const float wv = w[(long long)nn * d + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[(rg * 4 + i) * d + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + rg * 4 + i;
      if (m < M) out[m * n + nn] = acc[i] + (bias != nullptr ? bias[nn] : 0.f);
    }
  }
}

// ---- bf16 on the tensor cores: TMA + wgmma ---------------------------------

constexpr int LN_THREADS = 2 * 128 + 32;        // two consumer warpgroups + the producer warp
constexpr int LN_BN = 128;                      // output columns of one tile
constexpr uint32_t LN_STAGE = LN_BN * 128;      // 128 W rows x 64 along d
constexpr size_t LN_SMEM_MAX = 232448;          // what a block may use on the H100

__host__ __device__ inline size_t ln_smem(int bm, int d, int stages) {
  return 1024 + (size_t)bm * 128 * ((d + 63) / 64) + (size_t)stages * LN_STAGE + 8 + 16 * stages;
}

// the segmented form: `seg` 64-column tiles of the row tile resident, one
// more barrier (the segment buffer's empty one)
__host__ __device__ inline size_t ln_seg_smem(int bm, int seg, int stages) {
  return 1024 + (size_t)bm * 128 * seg + (size_t)stages * LN_STAGE + 16 + 16 * stages;
}

// WM = 2: 128 rows, the warpgroups split them (m64n128k16 each); WM = 1: 64
// rows, they split the 128 columns (m64n64k16 each), and two blocks may
// share an SM where their shared memory fits (d <= 320)
// the segmented form's producer and consumers (ln_linear_wgmma with SEG)
template <int BM, int N, int WM>
__device__ __forceinline__ void ln_linear_segments(
    const CUtensorMap& xmap, const CUtensorMap& wmap, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ bias, bf16* __restrict__ out,
    int M, int d, int n, int t0, int t1, int kch, int seg, int stages, float eps,
    const bf16* __restrict__ x, uint8_t* A, uint8_t* ring, uint64_t* abar, uint64_t* aempty,
    uint64_t* full, uint64_t* empty, int m0) {
  using namespace hopper;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nseg = (kch + seg - 1) / seg;
  if (warp == 8) {  // the producer warp: per output tile, each segment, then its W tiles
    if (lane == 0) {
      int it = 0, j = 0;
      for (int t = t0; t < t1; ++t)
        for (int h = 0; h < nseg; ++h, ++j) {
          const int c0 = h * seg, c1 = min(kch, c0 + seg);
          mbar_wait(aempty, (j & 1) ^ 1);  // every consumer is done with the last segment
          mbar_expect_tx(abar, (uint32_t)BM * 128 * (c1 - c0));
          for (int c = c0; c < c1; ++c) tma_load_2d(A + (c - c0) * BM * 128, &xmap, abar, 64 * c, m0);
          for (int c = c0; c < c1; ++c, ++it) {
            const int s = it % stages;
            mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            mbar_expect_tx(&full[s], LN_STAGE);
            tma_load_2d(ring + s * LN_STAGE, &wmap, &full[s], 64 * c, t * LN_BN);
          }
        }
    }
    return;
  }

  // each row's statistics from device memory, by the eight lanes that
  // normalise it (rows warp * 4 + lane / 8 + 32 i, as the resident form);
  // rows past M (zero filled by TMA) take mean 0, as there
  const int sub = lane % 8;
  float mean[BM / 32], rstd[BM / 32];
#pragma unroll
  for (int i = 0; i < BM / 32; ++i) {
    const int m = m0 + warp * 4 + lane / 8 + 32 * i;
    const bf16* xr = x + (long long)min(m, M - 1) * d;
    const bool in = m < M;
    float s = 0.f;
    for (int col = 8 * sub; in && col < d; col += 64) {  // d % 8 == 0
      const uint4 v = *reinterpret_cast<const uint4*>(xr + col);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s += f.x + f.y;
      }
    }
    mean[i] = row8_sum(s) / d;
    float var = 0.f;
    for (int col = 8 * sub; in && col < d; col += 64) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + col);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        var += (f.x - mean[i]) * (f.x - mean[i]) + (f.y - mean[i]) * (f.y - mean[i]);
      }
    }
    rstd[i] = rsqrtf(row8_sum(var) / d + eps);
  }

  const int wg = warp / 4, wm = wg % WM, wn = wg / WM;
  const int quad = lane % 4;
  float acc[N / 2];
  int it = 0, j = 0;
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int h = 0; h < nseg; ++h, ++j) {
      const int c0 = h * seg, c1 = min(kch, c0 + seg);
      mbar_wait(abar, j & 1);
      // the segment's tiles normalised in place (the resident form's step)
#pragma unroll
      for (int i = 0; i < BM / 32; ++i) {
        const int r = warp * 4 + lane / 8 + 32 * i;
        uint8_t* row = A + r * 128 + ((sub ^ (r % 8)) * 16);
        for (int c = c0; c < c1; ++c) {
          const int col = 64 * c + 8 * sub;
          uint4* dst = reinterpret_cast<uint4*>(row + (c - c0) * BM * 128);
          uint4 v = make_uint4(0, 0, 0, 0);  // columns past d: zero, for the padded K
          if (col < d) {
            v = *dst;
            __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
            const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
            const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
            const float4 b0 = *reinterpret_cast<const float4*>(beta + col);
            const float4 b1 = *reinterpret_cast<const float4*>(beta + col + 4);
            const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
            const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(hv[e]);
              hv[e] = __floats2bfloat162_rn((f.x - mean[i]) * rstd[i] * gs[2 * e] + bs[2 * e],
                                            (f.y - mean[i]) * rstd[i] * gs[2 * e + 1] + bs[2 * e + 1]);
            }
          }
          *dst = v;
        }
      }
      fence_proxy_async();
      named_sync(1, 256);
      for (int kc = c0; kc < c1; ++kc, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t a = smem_u32(A + (kc - c0) * BM * 128) + wm * 64 * 128;
        const uint32_t bt = smem_u32(ring + s * LN_STAGE) + wn * N * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<N>::template ss<0>(acc, desc(a + kk * 32, 16, 1024), desc(bt + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (kc > c0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {  // the last stage and the segment's buffer go back to the producer
        mbar_arrive(&empty[(it - 1) % stages]);
        mbar_arrive(aempty);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
      if (m >= M) continue;
      bf16* dst = out + (long long)m * n;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int c = t * LN_BN + wn * N + 8 * jj + 2 * quad;
        if (c >= n) continue;  // n % 8 == 0: a pair is in or out as a whole
        const float bb0 = bias != nullptr ? bias[c] : 0.f;
        const float bb1 = bias != nullptr ? bias[c + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * r] + bb0, acc[4 * jj + 2 * r + 1] + bb1);
      }
    }
  }
}

// SEG: the row tile in segments of `seg` 64-column tiles (the header), x
// (the raw rows in device memory) read for the statistics; else resident
template <int WM, bool SEG>
__global__ void __launch_bounds__(LN_THREADS, WM == 1 ? 2 : 1)
ln_linear_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ bias, bf16* __restrict__ out, int M, int d, int n,
                int run, int stages, float eps, const bf16* __restrict__ x, int seg) {
  using namespace hopper;
  constexpr int BM = 64 * WM, WN = 2 / WM, N = LN_BN / WN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* A = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kch = (d + 63) / 64;
  const uint32_t a_bytes = (uint32_t)BM * 128 * (SEG ? seg : kch);
  uint8_t* ring = A + a_bytes;
  uint64_t* abar = reinterpret_cast<uint64_t*>(ring + (size_t)stages * LN_STAGE);
  uint64_t* aempty = abar + 1;  // SEG only
  uint64_t* full = abar + (SEG ? 2 : 1);
  uint64_t* empty = full + stages;

  const int m0 = blockIdx.x * BM;
  const int tiles = (n + LN_BN - 1) / LN_BN;
  const int t0 = blockIdx.y * run, t1 = min(tiles, t0 + run);
  const int niter = (t1 - t0) * kch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(abar, 1);
    if (SEG) mbar_init(aempty, 8);  // lane 0 of every consumer warp
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if constexpr (SEG) {
    ln_linear_segments<BM, N, WM>(xmap, wmap, gamma, beta, bias, out, M, d, n, t0, t1, kch, seg,
                                  stages, eps, x, A, ring, abar, aempty, full, empty, m0);
    return;
  }

  if (warp == 8) {  // the producer warp: the row tile once, then the W ring
    if (lane == 0) {
      mbar_expect_tx(abar, a_bytes);
      for (int c = 0; c < kch; ++c) tma_load_2d(A + c * BM * 128, &xmap, abar, 64 * c, m0);
      for (int it = 0; it < niter; ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], LN_STAGE);
        tma_load_2d(ring + s * LN_STAGE, &wmap, &full[s], 64 * (it % kch),
                    (t0 + it / kch) * LN_BN);
      }
    }
    return;
  }

  // statistics and normalisation in place. Eight lanes take a row, four
  // rows a warp at once: lane l of the eight the 16-byte chunk l of every
  // 64-column tile (columns 64 i + 8 l ..), which the swizzle stores at
  // chunk l ^ (r % 8) of the row, so a lane's columns, and its gamma and
  // beta, are the same on every row, and the eight lanes read the eight
  // chunks of a row: no bank conflict.
  mbar_wait(abar, 0);
  const int sub = lane % 8;
  for (int r = warp * 4 + lane / 8; r < BM; r += 32) {
    uint8_t* row = A + r * 128 + ((sub ^ (r % 8)) * 16);
    float s = 0.f;
    for (int i = 0; i < kch && 64 * i + 8 * sub < d; ++i) {  // d % 8 == 0
      const uint4 v = *reinterpret_cast<const uint4*>(row + i * BM * 128);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s += f.x + f.y;
      }
    }
    const float mean = row8_sum(s) / d;
    float var = 0.f;
    for (int i = 0; i < kch && 64 * i + 8 * sub < d; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + i * BM * 128);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        var += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
    const float rstd = rsqrtf(row8_sum(var) / d + eps);
    for (int i = 0; i < kch; ++i) {
      const int col = 64 * i + 8 * sub;
      uint4* dst = reinterpret_cast<uint4*>(row + i * BM * 128);
      uint4 v = make_uint4(0, 0, 0, 0);  // columns past d: zero, for the padded K
      if (col < d) {
        v = *dst;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
        const float4 c0 = *reinterpret_cast<const float4*>(beta + col);
        const float4 c1 = *reinterpret_cast<const float4*>(beta + col + 4);
        const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn((f.x - mean) * rstd * gs[2 * e] + bs[2 * e],
                                       (f.y - mean) * rstd * gs[2 * e + 1] + bs[2 * e + 1]);
        }
      }
      *dst = v;
    }
  }
  // the normalised tile, written through the generic proxy, is read by wgmma
  fence_proxy_async();
  named_sync(1, 256);

  const int wg = warp / 4, wm = wg % WM, wn = wg / WM;
  const int quad = lane % 4;
  float acc[N / 2];
  int it = 0;
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kc = 0; kc < kch; ++kc, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const uint32_t a = smem_u32(A + kc * BM * 128) + wm * 64 * 128;
      const uint32_t bt = smem_u32(ring + s * LN_STAGE) + wn * N * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<N>::template ss<0>(acc, desc(a + kk * 32, 16, 1024), desc(bt + kk * 32, 16, 1024), 1);
      wgmma_commit();
      // the previous stage's products are done: hand its buffer back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);

    // epilogue: rows r and r + 8 of this warp's 16, columns 2(lane%4) (+1) of every 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
      if (m >= M) continue;
      bf16* dst = out + (long long)m * n;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = t * LN_BN + wn * N + 8 * j + 2 * quad;
        if (c >= n) continue;  // n % 8 == 0: a pair is in or out as a whole
        const float b0 = bias != nullptr ? bias[c] : 0.f;
        const float b1 = bias != nullptr ? bias[c + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] + b0, acc[4 * j + 2 * r + 1] + b1);
      }
    }
  }
}

template <int WM, bool SEG>
int launch_wgmma_rows(const void* x, const void* gamma, const void* beta, const void* w,
                      const void* bias, void* out, int M, int d, int n, int run, int stages,
                      int seg, float eps, cudaStream_t stream) {
  constexpr int BM = 64 * WM;
  const int kch = (d + 63) / 64;
  const size_t smem = SEG ? ln_seg_smem(BM, seg, stages) : ln_smem(BM, d, stages);
  if (stages < 2 || smem > LN_SMEM_MAX || (SEG && (seg < 1 || seg >= kch)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)M}, xstr[1] = {2ull * d};
  const uint64_t wdims[2] = {(uint64_t)d, (uint64_t)n}, wstr[1] = {2ull * d};
  const uint32_t xbox[2] = {64, (uint32_t)BM}, wbox[2] = {64, (uint32_t)LN_BN};
  int code = hopper::make_map(&xm, x, 2, xdims, xstr, xbox);
  if (code == 0) code = hopper::make_map(&wm, w, 2, wdims, wstr, wbox);
  if (code != 0) return code;
  cudaError_t err = hopper::set_smem_once<ln_linear_wgmma<WM, SEG>>(LN_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + LN_BN - 1) / LN_BN;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((tiles + run - 1) / run));
  ln_linear_wgmma<WM, SEG><<<grid, LN_THREADS, smem, stream>>>(
      xm, wm, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(bias), static_cast<bf16*>(out), M, d, n, run, stages, eps,
      static_cast<const bf16*>(x), seg);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const void* gamma, const void* beta, const void* w,
                 const void* bias, void* out, int M, int d, int n, int rows, int run,
                 int stages, int seg, float eps, cudaStream_t s) {
  // TMA: 16-byte aligned bases and byte strides; bf16 pairs stored whole;
  // gamma and beta read as float4
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(gamma) |
                        reinterpret_cast<uintptr_t>(beta);
  if (d % 8 != 0 || n % 8 != 0 || any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (run < 1) return (int)cudaErrorInvalidValue;
  if (seg > 0) {  // the segmented form: 64 rows
    if (rows != 64) return (int)cudaErrorInvalidValue;
    return launch_wgmma_rows<1, true>(x, gamma, beta, w, bias, out, M, d, n, run, stages, seg, eps, s);
  }
  if (rows == 128)
    return launch_wgmma_rows<2, false>(x, gamma, beta, w, bias, out, M, d, n, run, stages, 0, eps, s);
  if (rows == 64)
    return launch_wgmma_rows<1, false>(x, gamma, beta, w, bias, out, M, d, n, run, stages, 0, eps, s);
  return (int)cudaErrorInvalidValue;  // the host's tile is not a compiled one
}

int launch_wmma(const void* x, const void* gamma, const void* beta, const void* w,
                const void* bias, void* out, int M, int d, int n, float eps,
                cudaStream_t stream) {
  const Layout L = layout(d);
  cudaError_t err = cudaFuncSetAttribute(ln_linear_bf16_mma,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (M + BM - 1) / BM;
  const int col_tiles = (n + BN - 1) / BN;
  const int run = tiles_per_run(row_tiles, col_tiles);
  dim3 grid((unsigned)row_tiles, (unsigned)((col_tiles + run - 1) / run));
  const bool vec_x = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = d % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  ln_linear_bf16_mma<<<grid, THREADS, L.bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), M, d, n, run, eps, vec_x,
      vec_w);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* gamma, const void* beta, const void* w,
               const void* bias, void* out, int M, int d, int n, float eps,
               cudaStream_t stream) {
  const size_t bytes = (size_t)FM * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_linear_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (M + FM - 1) / FM;
  const int col_tiles = (n + FN - 1) / FN;
  const int run = tiles_per_run(row_tiles, col_tiles);
  dim3 grid((unsigned)row_tiles, (unsigned)((col_tiles + run - 1) / run));
  ln_linear_f32<<<grid, FTHREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), M, d, n, run, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// route (ops/ln_linear.py::ln_linear_plan): 0 = "f32" (x, w, out float32),
// 1 = "wmma" and 2 = "wgmma" (bfloat16). gamma, beta and bias are float32
// (bias may be null). All contiguous: x (M, d), w (n, d) (torch's Linear
// layout), out (M, n). "wgmma" needs d % 8 == 0, n % 8 == 0 and 16-byte
// aligned x, w, out, gamma and beta, and takes the host's tile: rows (128 or 64) a block,
// run (128-column output tiles a block), stages (of the W ring), seg (0: the
// row tile resident; else 64-column tiles of it a resident segment, 64
// rows); the other routes ignore them. Returns the cudaError_t of the
// launch, or a TMA-encoding error code (>= 10000).
extern "C" int dpm_ln_linear_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w, const void* bias, void* out, int M, int d,
                                 int n, float eps, int route, int rows, int run, int stages,
                                 int seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || d <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (route == 0) return launch_f32(x, gamma, beta, w, bias, out, M, d, n, eps, s);
  if (route == 1) return launch_wmma(x, gamma, beta, w, bias, out, M, d, n, eps, s);
  if (route == 2)
    return launch_wgmma(x, gamma, beta, w, bias, out, M, d, n, rows, run, stages, seg, eps, s);
  return (int)cudaErrorInvalidValue;
}
