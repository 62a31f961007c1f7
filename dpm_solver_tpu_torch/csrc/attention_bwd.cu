// Attention backward: dq, and dk/dv, for sm_90a, recompute-free.
//
// Replaces the two Pallas kernels of dpm_solver_tpu/ops/attention.py::
// _mha_backward: the dq kernel (`_dq_kernel`, `_dq_kernel_T`) and the dk/dv
// kernel (`_dkv_kernel`, `_dkv_kernel_T`). As there, P is rebuilt from the
// logits and the forward's base-2 log-sum-exp (attention.cu writes it), so
// no (T, S) tensor ever reaches device memory:
//
//   z  = q k^T (fp32)            p  = exp2(z * scale*log2(e) - lse)
//   dp = dO v^T                  ds = p * (dp - delta),  delta = rowsum(dO * O)
//   dq = scale * ds k            dk = scale * ds^T q     dv = p^T dO
//
// delta is elementwise work the JAX package also leaves outside its kernels;
// the wrapper computes it in torch. On a TPU the grid is sequential and each
// Pallas kernel carries its accumulator across the streamed axis in VMEM
// scratch. Here blocks run in parallel and in no order, so each block owns
// its output rows and streams the other side itself, and two kernels split
// the work the same way the Pallas pair does, with no atomics anywhere:
//
// - dq: a block owns one (batch*head, query tile) and streams K/V tiles;
// - dk/dv: a block owns one (batch*head, key tile) and streams Q/dO tiles.
//
// Each kernel recomputes z and dp for its tile pair, so the pair does 7
// products of T*S*D (the forward does 2): about 14*T*S*D flops per head
// against 2 bytes * D * (4*T + 4*S) of bf16 inputs and outputs, hundreds of
// flops per byte once T = S >= 64. Compute-bound: the products belong on the
// tensor cores, the exponentials in fp32.
//
// Two forms by dtype, as the forward has, at every head dim the forward
// takes (32, 40, 64, 80, 128, 160, 256, 512), but bf16 at 512:
// - bf16: 64 owned rows a block in four 16-row groups; all products are
//   WMMA 16x16x16 bf16 with fp32 accumulators (`mma.sync`); z and dp go
//   through fp32 shared memory for the elementwise step (a WMMA fragment's
//   element order is opaque), p and ds are rounded to bf16 for the second
//   products, as the Pallas kernels round them; the dq, dk and dv sums stay
//   in fp32 fragments across the whole stream and are rounded once.
//   * The reduction over the head dim runs in k16 steps, so the q, k, v and
//     dO tiles are staged d_pad = dh rounded up to 16 columns wide, the
//     columns past dh zero-filled in shared memory (dh 40 -> 48; the
//     forward's 64-column TMA tiles pad the same way, with zeros).
//   * Registers. A warp's fp32 sums are 16 x d_pad: 8 registers a thread a
//     16-wide fragment, two sums (dk and dv) in the dk/dv kernel, i.e. 256
//     registers a thread at dh 256, which would spill. From d_pad 160 on,
//     two warps share each 16-row group ("split" 2, 8 warps a block): each
//     owns half of the group's output columns, one computes the group's z
//     and the other its dp into shared memory, where both read them. z and
//     dp are built one 16x16 fragment at a time, so their accumulators cost
//     8 registers, not 32.
//   * Shared memory: four [64][d_pad + 8] bf16 tiles, z and dp [64][68] fp32,
//     p and ds [64][72] bf16: 188,928 bytes at dh 256. bf16 dh 512 would need
//     320,000, over the 232,448 (227 KB) a block may have, and the fp32 dk/dv
//     sums of a 64-key block alone are 256 KB: it is refused; only VAE
//     training needs it.
//   `wgmma`, TMA-fed stages and keeping z in registers are the later steps.
// - fp32: exact on the CUDA cores, 16 owned rows per block, 32-row streamed
//   tiles, 16 threads per owned row, each owning the columns col + 16 i
//   (masked past dh, so dh 40 and 80 need no padding); streamed rows padded
//   by one float so the 16 threads of a row read 16 different banks.
//   201,216 bytes of shared memory at dh 512.
//
// The tile of each head dim and dtype is chosen on the host
// (ops/attention.py::attention_bwd_plan) and handed to the C entries, which
// refuse any other. Ragged T and S are masked: keys >= S and queries >= T get
// p = 0, so they add nothing to any sum, and their rows are never written.
// Layout: q, k, v (B, T|S, H*D) with unit channel stride and any batch and
// token strides (the forward's); dO, dq, dk, dv contiguous (B, T|S, H*D);
// lse and delta float32 (B*H, T).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

struct Strides {  // element strides of q, k and v
  long long qb, qt, kb, kt, vb, vt;
};

// the host's tile (ops/attention.py::AttentionBwdTile)
struct Plan {
  int rows, tile, d_pad, split;
  long long smem;
};

// ---- fp32, exact, on the CUDA cores ----------------------------------------

constexpr int FB = 16;         // owned rows per block
constexpr int FS = 32;         // streamed rows per tile
constexpr int FTHREADS = 256;  // 16 threads per owned row

template <int D>
constexpr size_t f32_smem_bytes() {
  // owned [FB][D] x2, streamed [FS][D+1] x2, two [FB][FS] tiles, two [FS] rows
  return 4 * ((size_t)2 * FB * D + (size_t)2 * FS * (D + 1) + 2 * FB * FS + 2 * FS);
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int Tq, int S, int H, float qscale, float scale,
            Strides st) {
  constexpr int NC = (D + 15) / 16;  // the columns col + 16 i a thread owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [FB][D]
  float* gs = qs + FB * D;         // [FB][D] dO
  float* ks = gs + FB * D;         // [FS][D+1]
  float* vs = ks + FS * (D + 1);   // [FS][D+1]
  float* dss = vs + FS * (D + 1);  // [FB][FS] ds
  float* rl = dss + FB * FS;       // [FB] lse
  float* rd = rl + FB;             // [FB] delta

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * FB;
  const long long tok = (long long)H * D;
  const float* qb = q + b * st.qb + (long long)h * D;
  const float* kb = k + b * st.kb + (long long)h * D;
  const float* vb = v + b * st.vb + (long long)h * D;
  const float* gb = dout + (long long)b * Tq * tok + (long long)h * D;
  float* dqb = dq + (long long)b * Tq * tok + (long long)h * D;

  for (int idx = tid; idx < FB * D; idx += FTHREADS) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    qs[idx] = t < Tq ? qb[t * st.qt + d] : 0.f;
    gs[idx] = t < Tq ? gb[t * tok + d] : 0.f;
  }
  if (tid < FB) {
    const int t = q0 + tid;
    rl[tid] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    rd[tid] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
  }

  const int row = tid / 16, col = tid % 16;
  const bool row_ok = q0 + row < Tq;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < S; k0 += FS) {
    __syncthreads();  // previous tile consumed; owned rows visible
    for (int idx = tid; idx < FS * D; idx += FTHREADS) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      const bool valid = key < S;
      ks[j * (D + 1) + d] = valid ? kb[key * st.kt + d] : 0.f;
      vs[j * (D + 1) + d] = valid ? vb[key * st.vt + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = col + 16 * jj;
      float z = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        z = fmaf(qs[row * D + d], ks[j * (D + 1) + d], z);
        dp = fmaf(gs[row * D + d], vs[j * (D + 1) + d], dp);
      }
      const float p = (row_ok && k0 + j < S) ? exp2f(z * qscale - rl[row]) : 0.f;
      dss[row * FS + j] = p * (dp - rd[row]);
    }
    __syncthreads();
    for (int j = 0; j < FS; ++j) {
      const float ds = dss[row * FS + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = col + 16 * i;
        if (D % 16 == 0 || c < D) acc[i] = fmaf(ds, ks[j * (D + 1) + c], acc[i]);
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = col + 16 * i;
      if (D % 16 == 0 || c < D) dqb[(q0 + row) * tok + c] = acc[i] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int H,
             float qscale, float scale, Strides st) {
  constexpr int NC = (D + 15) / 16;  // the columns col + 16 i a thread owns
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [FB][D] owned keys
  float* vs = ks + FB * D;         // [FB][D]
  float* qs = vs + FB * D;         // [FS][D+1] streamed queries
  float* gs = qs + FS * (D + 1);   // [FS][D+1] dO
  float* ps = gs + FS * (D + 1);   // [FB][FS] p
  float* dss = ps + FB * FS;       // [FB][FS] ds
  float* rl = dss + FB * FS;       // [FS] lse
  float* rd = rl + FS;             // [FS] delta

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * FB;
  const long long tok = (long long)H * D;
  const float* qb = q + b * st.qb + (long long)h * D;
  const float* kb = k + b * st.kb + (long long)h * D;
  const float* vb = v + b * st.vb + (long long)h * D;
  const float* gb = dout + (long long)b * Tq * tok + (long long)h * D;
  float* dkb = dk + (long long)b * S * tok + (long long)h * D;
  float* dvb = dv + (long long)b * S * tok + (long long)h * D;

  for (int idx = tid; idx < FB * D; idx += FTHREADS) {
    const int r = idx / D, d = idx % D, key = k0 + r;
    ks[idx] = key < S ? kb[key * st.kt + d] : 0.f;
    vs[idx] = key < S ? vb[key * st.vt + d] : 0.f;
  }

  const int row = tid / 16, col = tid % 16;
  const bool key_ok = k0 + row < S;
  float dk_acc[NC], dv_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < Tq; t0 += FS) {
    __syncthreads();  // previous tile consumed; owned rows visible
    for (int idx = tid; idx < FS * D; idx += FTHREADS) {
      const int i = idx / D, d = idx % D, t = t0 + i;
      const bool valid = t < Tq;
      qs[i * (D + 1) + d] = valid ? qb[t * st.qt + d] : 0.f;
      gs[i * (D + 1) + d] = valid ? gb[t * tok + d] : 0.f;
    }
    if (tid < FS) {
      const int t = t0 + tid;
      rl[tid] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
      rd[tid] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int i = col + 16 * ii;
      float z = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        z = fmaf(ks[row * D + d], qs[i * (D + 1) + d], z);
        dp = fmaf(vs[row * D + d], gs[i * (D + 1) + d], dp);
      }
      const float p = (key_ok && t0 + i < Tq) ? exp2f(z * qscale - rl[i]) : 0.f;
      ps[row * FS + i] = p;
      dss[row * FS + i] = p * (dp - rd[i]);
    }
    __syncthreads();
    for (int i = 0; i < FS; ++i) {
      const float p = ps[row * FS + i], ds = dss[row * FS + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int cc = col + 16 * c;
        if (D % 16 == 0 || cc < D) {
          dv_acc[c] = fmaf(p, gs[i * (D + 1) + cc], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qs[i * (D + 1) + cc], dk_acc[c]);
        }
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int cc = col + 16 * c;
      if (D % 16 == 0 || cc < D) {
        dkb[(k0 + row) * tok + cc] = dk_acc[c] * scale;
        dvb[(k0 + row) * tok + cc] = dv_acc[c];
      }
    }
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

namespace mma = nvcuda::wmma;
using FragA = mma::fragment<mma::matrix_a, 16, 16, 16, __nv_bfloat16, mma::row_major>;
using FragBRow = mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::row_major>;
using FragBCol = mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::col_major>;
using FragC = mma::fragment<mma::accumulator, 16, 16, 16, float>;

constexpr int MR = 64;  // owned rows per block: four 16-row groups
constexpr int MT = 64;  // streamed rows per tile

template <int D>
struct MmaTile {
  static constexpr int DP = (D + 15) / 16 * 16;     // the reduction, in k16 steps
  static constexpr int SPLIT = DP >= 160 ? 2 : 1;   // warps sharing a row group
  static constexpr int WARPS = 4 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int DW = DP / SPLIT;             // output columns a warp owns
  static constexpr int NF = DW / 16;                // its 16-wide fp32 fragments
  static constexpr int LDX = DP + 8;  // bf16 pitch of the q, k, v, dO tiles
  static constexpr int LDS = MT + 4;  // fp32 pitch of z and dp
  static constexpr int LDP = MT + 8;  // bf16 pitch of p and ds
  static constexpr size_t own0 = 0;                                 // [MR][LDX]
  static constexpr size_t own1 = own0 + (size_t)MR * LDX * 2;       // [MR][LDX]
  static constexpr size_t str0 = own1 + (size_t)MR * LDX * 2;       // [MT][LDX]
  static constexpr size_t str1 = str0 + (size_t)MT * LDX * 2;       // [MT][LDX]
  static constexpr size_t z = str1 + (size_t)MT * LDX * 2;          // [MR][LDS]
  static constexpr size_t dp = z + (size_t)MR * LDS * 4;            // [MR][LDS]
  static constexpr size_t p = dp + (size_t)MR * LDS * 4;            // [MR][LDP]
  static constexpr size_t ds = p + (size_t)MR * LDP * 2;            // [MR][LDP]
  static constexpr size_t rows = ds + (size_t)MR * LDP * 2;         // lse, delta
  static constexpr size_t bytes = rows + (size_t)2 * MT * 4;
  // the output staging: one 16x16 fp32 fragment a warp, in the z tile
  static_assert(WARPS * 256 <= MR * LDS, "output staging must fit the z tile");
  static_assert(DW % 16 == 0, "a warp owns whole 16-wide fragments");
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

// rows [row0, row0 + rows) of one head, D wide, from rows `tok` elements apart
// into a bf16 smem tile of pitch LDX, 16 bytes at a time; rows past `valid`
// and the columns [D, DP) are 0
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long tok, int row0, int rows, int valid) {
  using L = MmaTile<D>;
  constexpr int CHUNKS = L::DP / 8;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += L::THREADS) {
    const int r = e / CHUNKS, c = 8 * (e % CHUNKS);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < D && row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * tok + c);
    *reinterpret_cast<uint4*>(dst + r * L::LDX + c) = val;
  }
}

// out (16 x MT fp32, pitch LDS) = A (16 x DP) . X^T (X: MT x DP), one 16x16
// fragment at a time
template <int D>
__device__ __forceinline__ void product(const __nv_bfloat16* a, const __nv_bfloat16* x,
                                        float* out) {
  using L = MmaTile<D>;
#pragma unroll
  for (int j = 0; j < MT / 16; ++j) {
    FragC acc;
    mma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kd = 0; kd < L::DP; kd += 16) {
      FragA fa;
      FragBCol fx;  // X is [row][d] row-major, i.e. X^T column-major
      mma::load_matrix_sync(fa, a + kd, L::LDX);
      mma::load_matrix_sync(fx, x + j * 16 * L::LDX + kd, L::LDX);
      mma::mma_sync(acc, fa, fx, acc);
    }
    mma::store_matrix_sync(out + j * 16, acc, L::LDS, mma::mem_row_major);
  }
}

// this warp's share of a row group's z (pitch LDS) = A X^T and dp = B Y^T:
// both with one warp a group, z or dp with two
template <int D>
__device__ __forceinline__ void products(const __nv_bfloat16* a, const __nv_bfloat16* bm,
                                         const __nv_bfloat16* x, const __nv_bfloat16* y,
                                         float* z, float* dp, int part) {
  if (MmaTile<D>::SPLIT == 1 || part == 0) product<D>(a, x, z);
  if (MmaTile<D>::SPLIT == 1 || part == 1) product<D>(bm, y, dp);
}

// acc[n] (16 x 16 slice n of this warp's 16 x DW sum) += P (16 x MT, pitch
// LDP) . X (MT x DW, the warp's columns, pitch LDX)
template <int D>
__device__ __forceinline__ void accumulate(FragC* acc, const __nv_bfloat16* pw,
                                           const __nv_bfloat16* x) {
  using L = MmaTile<D>;
#pragma unroll
  for (int kk = 0; kk < MT; kk += 16) {
    FragA fp;
    mma::load_matrix_sync(fp, pw + kk, L::LDP);
#pragma unroll
    for (int n = 0; n < L::NF; ++n) {
      FragBRow fx;
      mma::load_matrix_sync(fx, x + kk * L::LDX + n * 16, L::LDX);
      mma::mma_sync(acc[n], fp, fx, acc[n]);
    }
  }
}

// this warp's 16 x DW fp32 sum at columns [col0, col0 + DW), times `mul`,
// rounded to bf16 into rows [row0, row0 + 16) of dst (rows `tok` apart), 8
// columns a lane, through a 16x16 fp32 fragment of shared memory `stage`;
// columns >= D and rows >= valid are not written
template <int D>
__device__ __forceinline__ void store_rows(const FragC* acc, float* stage, float mul,
                                           __nv_bfloat16* dst, long long tok, int row0,
                                           int col0, int valid) {
  using L = MmaTile<D>;
  const int lane = threadIdx.x % 32, r = lane / 2, half = lane % 2;
  const bool row_ok = row0 + r < valid;
#pragma unroll
  for (int n = 0; n < L::NF; ++n) {
    mma::store_matrix_sync(stage, acc[n], 16, mma::mem_row_major);
    __syncwarp();
    const int c = col0 + n * 16 + half * 8;
    if (row_ok && c < D) {
      const float* src = stage + r * 16 + half * 8;
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(src[e] * mul);
      *reinterpret_cast<uint4*>(dst + (row0 + r) * tok + c) =
          *reinterpret_cast<const uint4*>(out);
    }
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::THREADS)
attn_dq_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, float qscale,
                 float scale, Strides st) {
  using L = MmaTile<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::own0);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::own1);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::str0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::str1);
  float* zs = reinterpret_cast<float*>(smem_raw + L::z);
  float* dps = reinterpret_cast<float*>(smem_raw + L::dp);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::ds);
  float* rl = reinterpret_cast<float*>(smem_raw + L::rows);
  float* rd = rl + MT;

  // warp (group, part): row group `group` of the block's four, output
  // columns [part * DW, (part + 1) * DW)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp % 4, part = warp / 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * MR;
  const long long tok = (long long)H * D;
  const __nv_bfloat16* qb = q + b * st.qb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * st.kb + (long long)h * D;
  const __nv_bfloat16* vb = v + b * st.vb + (long long)h * D;
  const __nv_bfloat16* gb = dout + (long long)b * Tq * tok + (long long)h * D;

  load_tile<D>(qs, qb, st.qt, q0, MR, Tq);
  load_tile<D>(gs, gb, tok, q0, MR, Tq);
  for (int i = threadIdx.x; i < MR; i += L::THREADS) {
    const int t = q0 + i;
    rl[i] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    rd[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
  }

  // elementwise step: the group's 32 * SPLIT threads, two a row, each
  // MT / (2 * SPLIT) of its columns
  constexpr int SEG = MT / (2 * L::SPLIT);
  const int row = group * 16 + lane / 2, c0 = (part * 2 + lane % 2) * SEG;
  const bool row_ok = q0 + row < Tq;
  FragC acc[L::NF];
#pragma unroll
  for (int n = 0; n < L::NF; ++n) mma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < S; k0 += MT) {
    __syncthreads();  // previous tile consumed (first pass: owned rows loaded)
    load_tile<D>(ks, kb, st.kt, k0, MT, S);
    load_tile<D>(vs, vb, st.vt, k0, MT, S);
    __syncthreads();

    // z = Q_g K^T and dp = dO_g V^T, 16 x MT each
    products<D>(qs + group * 16 * L::LDX, gs + group * 16 * L::LDX, ks, vs,
                zs + group * 16 * L::LDS, dps + group * 16 * L::LDS, part);
    __syncthreads();  // a group's z and dp may come from two warps
    const float lse_r = rl[row], del_r = rd[row];
    for (int j = 0; j < SEG; ++j) {
      const int c = c0 + j;
      const float p = (row_ok && k0 + c < S)
                          ? exp2f(zs[row * L::LDS + c] * qscale - lse_r) : 0.f;
      dss[row * L::LDP + c] = __float2bfloat16(p * (dps[row * L::LDS + c] - del_r));
    }
    __syncthreads();  // a group's ds rows feed both its warps
    // dq_g[:, part's columns] += ds_g K[:, part's columns]
    accumulate<D>(acc, dss + group * 16 * L::LDP, ks + part * L::DW);
  }
  __syncthreads();  // the staging below overwrites z
  store_rows<D>(acc, zs + warp * 256, scale, dq + (long long)b * Tq * tok + (long long)h * D,
                tok, q0 + group * 16, part * L::DW, Tq);
}

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::THREADS)
attn_dkv_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                  int S, int H, float qscale, float scale, Strides st) {
  using L = MmaTile<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::own0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::own1);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::str0);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::str1);
  float* zs = reinterpret_cast<float*>(smem_raw + L::z);
  float* dps = reinterpret_cast<float*>(smem_raw + L::dp);
  __nv_bfloat16* pss = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::p);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::ds);
  float* rl = reinterpret_cast<float*>(smem_raw + L::rows);
  float* rd = rl + MT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp % 4, part = warp / 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * MR;
  const long long tok = (long long)H * D;
  const __nv_bfloat16* qb = q + b * st.qb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * st.kb + (long long)h * D;
  const __nv_bfloat16* vb = v + b * st.vb + (long long)h * D;
  const __nv_bfloat16* gb = dout + (long long)b * Tq * tok + (long long)h * D;

  load_tile<D>(ks, kb, st.kt, k0, MR, S);
  load_tile<D>(vs, vb, st.vt, k0, MR, S);

  // elementwise step: the group's 32 * SPLIT threads, two a key row, each
  // MT / (2 * SPLIT) of its query columns
  constexpr int SEG = MT / (2 * L::SPLIT);
  const int row = group * 16 + lane / 2, c0 = (part * 2 + lane % 2) * SEG;
  const bool key_ok = k0 + row < S;
  FragC dk_acc[L::NF], dv_acc[L::NF];
#pragma unroll
  for (int n = 0; n < L::NF; ++n) {
    mma::fill_fragment(dk_acc[n], 0.f);
    mma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int t0 = 0; t0 < Tq; t0 += MT) {
    __syncthreads();  // previous tile consumed (first pass: owned rows loaded)
    load_tile<D>(qs, qb, st.qt, t0, MT, Tq);
    load_tile<D>(gs, gb, tok, t0, MT, Tq);
    for (int i = threadIdx.x; i < MT; i += L::THREADS) {
      const int t = t0 + i;
      rl[i] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
      rd[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
    }
    __syncthreads();

    // z^T = K_g Q^T and dp^T = V_g dO^T, 16 keys x MT queries each
    products<D>(ks + group * 16 * L::LDX, vs + group * 16 * L::LDX, qs, gs,
                zs + group * 16 * L::LDS, dps + group * 16 * L::LDS, part);
    __syncthreads();  // a group's z and dp may come from two warps
    for (int j = 0; j < SEG; ++j) {
      const int c = c0 + j;
      const float p = (key_ok && t0 + c < Tq)
                          ? exp2f(zs[row * L::LDS + c] * qscale - rl[c]) : 0.f;
      pss[row * L::LDP + c] = __float2bfloat16(p);
      dss[row * L::LDP + c] = __float2bfloat16(p * (dps[row * L::LDS + c] - rd[c]));
    }
    __syncthreads();  // a group's p and ds rows feed both its warps
    // dv_g += p^T_g dO and dk_g += ds^T_g Q, at this warp's columns
    accumulate<D>(dv_acc, pss + group * 16 * L::LDP, gs + part * L::DW);
    accumulate<D>(dk_acc, dss + group * 16 * L::LDP, qs + part * L::DW);
  }
  __syncthreads();  // the staging below overwrites z
  const long long out0 = (long long)b * S * tok + (long long)h * D;
  store_rows<D>(dk_acc, zs + warp * 256, scale, dk + out0, tok, k0 + group * 16,
                part * L::DW, S);
  store_rows<D>(dv_acc, zs + warp * 256, 1.f, dv + out0, tok, k0 + group * 16,
                part * L::DW, S);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned_bf16(const void* a, const void* b, const void* c, const void* d, const void* e,
                  const Strides& st) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(e);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  return any % 16 == 0 && strides % 8 == 0;
}

// the compiled tile of head dim D in `dtype` is the host's
template <int D>
bool plan_is_compiled(const Plan& p, int dtype) {
  if (dtype == 0)
    return p.rows == FB && p.tile == FS && p.d_pad == D && p.split == 1 &&
           p.smem == (long long)f32_smem_bytes<D>();
  if constexpr (D == 512) {
    return false;  // bf16 dh 512 does not fit a block
  } else {
    using L = MmaTile<D>;
    return p.rows == MR && p.tile == MT && p.d_pad == L::DP && p.split == L::SPLIT &&
           p.smem == (long long)L::bytes;
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, void* dq, int B, int Tq, int S, int H, float qscale,
              float scale, Strides st, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    const size_t bytes = f32_smem_bytes<D>();
    cudaError_t err = set_smem(attn_dq_f32<D>, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((Tq + FB - 1) / FB), (unsigned)(B * H));
    attn_dq_f32<D><<<grid, FTHREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dq), Tq, S, H, qscale, scale, st);
    return (int)cudaGetLastError();
  }
  if constexpr (D == 512) {
    return (int)cudaErrorInvalidValue;  // bf16 dh 512 does not fit a block
  } else {
    using L = MmaTile<D>;
    if (!aligned_bf16(q, k, v, g, dq, st)) return (int)cudaErrorMisalignedAddress;
    cudaError_t err = set_smem(attn_dq_bf16_mma<D>, L::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((Tq + MR - 1) / MR), (unsigned)(B * H));
    attn_dq_bf16_mma<D><<<grid, L::THREADS, L::bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse,
        delta, static_cast<__nv_bfloat16*>(dq), Tq, S, H, qscale, scale, st);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Tq, int S, int H,
               float qscale, float scale, Strides st, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    const size_t bytes = f32_smem_bytes<D>();
    cudaError_t err = set_smem(attn_dkv_f32<D>, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((S + FB - 1) / FB), (unsigned)(B * H));
    attn_dkv_f32<D><<<grid, FTHREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, H, qscale, scale, st);
    return (int)cudaGetLastError();
  }
  if constexpr (D == 512) {
    return (int)cudaErrorInvalidValue;  // bf16 dh 512 does not fit a block
  } else {
    using L = MmaTile<D>;
    if (!aligned_bf16(q, k, v, g, dk, st) || reinterpret_cast<uintptr_t>(dv) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    cudaError_t err = set_smem(attn_dkv_bf16_mma<D>, L::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((S + MR - 1) / MR), (unsigned)(B * H));
    attn_dkv_bf16_mma<D><<<grid, L::THREADS, L::bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse,
        delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Tq, S, H,
        qscale, scale, st);
    return (int)cudaGetLastError();
  }
}

template <int D>
int dispatch(bool dkv, const void* q, const void* k, const void* v, const void* g,
             const float* lse, const float* delta, void* o1, void* o2, int B, int Tq, int S,
             int H, float qscale, float scale, Strides st, int dtype, const Plan& p,
             cudaStream_t s) {
  if (!plan_is_compiled<D>(p, dtype))
    return (int)cudaErrorInvalidValue;  // the host's plan is not the compiled one
  if (dkv) return launch_dkv<D>(q, k, v, g, lse, delta, o1, o2, B, Tq, S, H, qscale, scale,
                                st, dtype, s);
  return launch_dq<D>(q, k, v, g, lse, delta, o1, B, Tq, S, H, qscale, scale, st, dtype, s);
}

int entry(bool dkv, const void* q, const void* k, const void* v, const void* g,
          const void* lse, const void* delta, void* o1, void* o2, int B, int T, int S, int H,
          int D, float qscale, float scale, Strides st, int dtype, Plan p, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DPM_BWD_CASE(DH) \
    case DH: return dispatch<DH>(dkv, q, k, v, g, l, dl, o1, o2, B, T, S, H, qscale, scale, \
                                 st, dtype, p, s);
    DPM_BWD_CASE(32) DPM_BWD_CASE(40) DPM_BWD_CASE(64) DPM_BWD_CASE(80)
    DPM_BWD_CASE(128) DPM_BWD_CASE(160) DPM_BWD_CASE(256) DPM_BWD_CASE(512)
#undef DPM_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share it;
// bf16 pointers 16-byte aligned, bf16 strides multiples of 8). q, k, v take
// the forward's strides (elements; channel stride 1); dout, dq, dk and dv are
// contiguous (B, T|S, H*D); lse (the forward's, base 2) and delta are float32
// (B*H, T). qscale = scale * log2(e). D is one of 32, 40, 64, 80, 128, 160,
// 256 and 512, but 512 in float32 only. rows, tile, d_pad, split and
// smem_bytes are the host's tile (ops/attention.py::attention_bwd_plan); a
// tile other than the compiled one is refused. Each returns the cudaError_t
// of its launch.
extern "C" int dpm_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int T, int S, int H, int D, float qscale,
                                    float scale, long long q_bs, long long q_ts, long long k_bs,
                                    long long k_ts, long long v_bs, long long v_ts, int dtype,
                                    int rows, int tile, int d_pad, int split,
                                    long long smem_bytes, void* stream) {
  return entry(false, q, k, v, dout, lse, delta, dq, nullptr, B, T, S, H, D, qscale, scale,
               Strides{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts}, dtype,
               Plan{rows, tile, d_pad, split, smem_bytes}, stream);
}

extern "C" int dpm_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int T, int S, int H, int D,
                                     float qscale, float scale, long long q_bs, long long q_ts,
                                     long long k_bs, long long k_ts, long long v_bs,
                                     long long v_ts, int dtype, int rows, int tile, int d_pad,
                                     int split, long long smem_bytes, void* stream) {
  return entry(true, q, k, v, dout, lse, delta, dk, dv, B, T, S, H, D, qscale, scale,
               Strides{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts}, dtype,
               Plan{rows, tile, d_pad, split, smem_bytes}, stream);
}
