// LayerNorm -> Linear, out = LN(x; gamma, beta) . W (+ bias), for sm_90a.
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
// weight as it holds it, with no transpose.
//
// This is the rounding of ln_linear_reference exactly: the normalised tile
// is rounded once to the weight dtype, and never reaches device memory.
//
// What bounds it on the H100: at the SD-2.1 sites (M = 1,152 .. 73,728 rows,
// d = 320 .. 1,280, n = d or 3d) the product does 2*d*n flops per row
// against (d + n) * 2 bytes, a few hundred flops per byte: near the bf16
// ridge (~295), so both the tensor cores and the bytes matter. The design
// reads x once per column run and writes the output once; the normalised
// tile stays in shared memory. Two kernels, by dtype:
//
// - bf16: `ln_linear_bf16_mma`. A block owns 64 rows. It stages the raw rows
//   in shared memory (16-byte loads where d % 8 == 0), each warp computes
//   the mean and the two-pass variance of 16 rows in fp32 and overwrites
//   them in place with the normalised bf16 values. The row tile is
//   64 x (d rounded up to 32, + 8) bf16: 164,864 bytes at d = 1,280, so
//   the whole tile stays resident and is read from shared memory for every
//   column tile. The block then walks 64-wide column tiles: 4 warps each own
//   32x32 of the 64x64 output tile as 2x2 WMMA 16x16x16 fragments with fp32
//   accumulators (`mma.sync`). The weight is staged as 64 rows of W (output
//   columns) by 32 along d, and read as column-major B fragments. The epilogue
//   adds the fp32 bias and rounds once to bf16; the ragged edges of m and n
//   (n = 960 at the 320-wide qkv site is no multiple of 128) are masked,
//   and rows or columns past d are zero-filled. To fill the card at small m,
//   the column tiles are split across blockIdx.y, each block re-normalising
//   its rows (x is read once per split, not once per tile). `wgmma`, TMA
//   and a multi-stage weight pipeline are the later steps.
// - fp32: `ln_linear_f32`, the exact form on the CUDA cores: 16 rows per
//   block, normalised in fp32 shared memory, each thread four rows of one
//   column.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

int launch_bf16(const void* x, const void* gamma, const void* beta, const void* w,
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

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); gamma, beta and
// bias are float32 (bias may be null). All contiguous: x (M, d), w (n, d)
// (torch's Linear layout), out (M, n). Returns the cudaError_t of the launch.
extern "C" int dpm_ln_linear_fwd(const void* x, const void* gamma, const void* beta,
                                 const void* w, const void* bias, void* out, int M, int d,
                                 int n, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || d <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(x, gamma, beta, w, bias, out, M, d, n, eps, s);
  if (dtype == 1) return launch_bf16(x, gamma, beta, w, bias, out, M, d, n, eps, s);
  return (int)cudaErrorInvalidValue;
}
