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
// - dq: a block owns one (batch*head, 64-query tile) and streams K/V tiles;
// - dk/dv: a block owns one (batch*head, 64-key tile) and streams Q/dO tiles.
//
// Each kernel recomputes z and dp for its tile pair, so the pair does 7
// products of T*S*D (the forward does 2): about 14*T*S*D flops per head
// against 2 bytes * D * (4*T + 4*S) of bf16 inputs and outputs, hundreds of
// flops per byte at the ADM-256 sites (T = S >= 64, D = 64). Compute-bound:
// the products belong on the tensor cores, the exponentials in fp32.
//
// Two forms by dtype, as the forward has:
// - bf16: 4 warps, each owning 16 rows of the block's 64. All products are
//   WMMA 16x16x16 bf16 with fp32 accumulators (`mma.sync`); z and dp go
//   through fp32 shared memory for the elementwise step (a WMMA fragment's
//   element order is opaque), p and ds are rounded to bf16 for the second
//   products, as the Pallas kernels round them; the dq, dk and dv sums stay
//   in fp32 fragments across the whole stream and are rounded once. `wgmma`,
//   TMA-fed stages and keeping z in registers are the later steps.
// - fp32: exact on the CUDA cores, 16 owned rows per block, 32-row streamed
//   tiles, 16 threads per owned row; streamed rows padded by one float so the
//   16 threads of a row read 16 different banks.
//
// Head dim 64 only: every attention site of the ADM-256 UNet and classifier.
// Ragged T and S are masked: keys >= S and queries >= T get p = 0, so they
// add nothing to any sum, and their rows are never written.
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

// ---- fp32, exact, on the CUDA cores ----------------------------------------

constexpr int FB = 16;         // owned rows per block
constexpr int FS = 32;         // streamed rows per tile
constexpr int FTHREADS = 256;  // 16 threads per owned row

template <int D>
constexpr size_t f32_smem_floats() {
  // owned [FB][D] x2, streamed [FS][D+1] x2, two [FB][FS] tiles, two [FS] rows
  return (size_t)2 * FB * D + (size_t)2 * FS * (D + 1) + 2 * FB * FS + 2 * FS;
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int Tq, int S, int H, float qscale, float scale,
            Strides st) {
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
  float acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i] = 0.f;

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
      for (int i = 0; i < D / 16; ++i) acc[i] = fmaf(ds, ks[j * (D + 1) + col + 16 * i], acc[i]);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) dqb[(q0 + row) * tok + col + 16 * i] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int H,
             float qscale, float scale, Strides st) {
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
  float dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) dk_acc[i] = dv_acc[i] = 0.f;

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
      for (int c = 0; c < D / 16; ++c) {
        dv_acc[c] = fmaf(p, gs[i * (D + 1) + col + 16 * c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, qs[i * (D + 1) + col + 16 * c], dk_acc[c]);
      }
    }
  }
  if (key_ok) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dkb[(k0 + row) * tok + col + 16 * c] = dk_acc[c] * scale;
      dvb[(k0 + row) * tok + col + 16 * c] = dv_acc[c];
    }
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

namespace mma = nvcuda::wmma;
using FragA = mma::fragment<mma::matrix_a, 16, 16, 16, __nv_bfloat16, mma::row_major>;
using FragBRow = mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::row_major>;
using FragBCol = mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::col_major>;
using FragC = mma::fragment<mma::accumulator, 16, 16, 16, float>;

constexpr int MR = 64;            // owned rows per block: 4 warps x 16
constexpr int MT = 64;            // streamed rows per tile
constexpr int MMA_THREADS = 128;

template <int D>
struct MmaSmem {                      // byte offsets into dynamic shared memory
  static constexpr int LDX = D + 8;   // bf16 pitch of the q, k, v, dO tiles
  static constexpr int LDS = MT + 4;  // fp32 pitch of z and dp
  static constexpr int LDP = MT + 8;  // bf16 pitch of p and ds
  static constexpr int LDO = D + 4;   // fp32 pitch of the output staging
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
  // the output staging reuses z (and dp for the second output)
  static_assert(LDO <= LDS, "output staging must fit the z tile");
};

// rows [row0, row0 + rows) of one head, D wide, from rows `tok` elements apart
// into a bf16 smem tile of pitch ldx, 16 bytes at a time; rows past `valid` are 0
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long tok, int row0, int rows, int valid,
                                          int ldx) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += MMA_THREADS) {
    const int r = e / CHUNKS, c = 8 * (e % CHUNKS);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * tok + c);
    *reinterpret_cast<uint4*>(dst + r * ldx + c) = val;
  }
}

// this warp's 16 owned rows (A, B) against the MT streamed rows (X, Y):
// za = A X^T and zb = B Y^T, 16 x MT each, into fp32 smem at this warp's rows
template <int D>
__device__ __forceinline__ void two_products(const __nv_bfloat16* a, const __nv_bfloat16* bm,
                                             const __nv_bfloat16* x, const __nv_bfloat16* y,
                                             float* za, float* zb) {
  using L = MmaSmem<D>;
  FragC acc_a[MT / 16], acc_b[MT / 16];
#pragma unroll
  for (int j = 0; j < MT / 16; ++j) {
    mma::fill_fragment(acc_a[j], 0.f);
    mma::fill_fragment(acc_b[j], 0.f);
  }
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    FragA fa, fb;
    mma::load_matrix_sync(fa, a + kd, L::LDX);
    mma::load_matrix_sync(fb, bm + kd, L::LDX);
#pragma unroll
    for (int j = 0; j < MT / 16; ++j) {
      // X is [row][d] row-major, i.e. X^T column-major
      FragBCol fx, fy;
      mma::load_matrix_sync(fx, x + j * 16 * L::LDX + kd, L::LDX);
      mma::load_matrix_sync(fy, y + j * 16 * L::LDX + kd, L::LDX);
      mma::mma_sync(acc_a[j], fa, fx, acc_a[j]);
      mma::mma_sync(acc_b[j], fb, fy, acc_b[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < MT / 16; ++j) {
    mma::store_matrix_sync(za + j * 16, acc_a[j], L::LDS, mma::mem_row_major);
    mma::store_matrix_sync(zb + j * 16, acc_b[j], L::LDS, mma::mem_row_major);
  }
}

// acc[n] (16 x 16 slice n of a 16 x D sum) += P (16 x MT, pitch LDP) . X (MT x D)
template <int D>
__device__ __forceinline__ void accumulate(FragC* acc, const __nv_bfloat16* pw,
                                           const __nv_bfloat16* x) {
  using L = MmaSmem<D>;
#pragma unroll
  for (int kk = 0; kk < MT; kk += 16) {
    FragA fp;
    mma::load_matrix_sync(fp, pw + kk, L::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fx;
      mma::load_matrix_sync(fx, x + kk * L::LDX + n * 16, L::LDX);
      mma::mma_sync(acc[n], fp, fx, acc[n]);
    }
  }
}

// this warp's 16 x D fp32 sum, times `mul`, rounded to bf16 into rows
// [row0 + warp*16, ...) of dst (rows `tok` apart); stage is fp32 smem
template <int D>
__device__ __forceinline__ void store_rows(const FragC* acc, float* stage, float mul,
                                           __nv_bfloat16* dst, long long tok, int row0,
                                           int valid) {
  using L = MmaSmem<D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = stage + warp * 16 * L::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    mma::store_matrix_sync(sw + n * 16, acc[n], L::LDO, mma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, half = lane % 2;
  const int t = row0 + warp * 16 + r;
  if (t < valid) {
    const float* src = sw + r * L::LDO + half * (D / 2);
    __nv_bfloat16* out = dst + t * tok + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(src[c] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dq_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, float qscale,
                 float scale, Strides st) {
  using L = MmaSmem<D>;
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * MR;
  const long long tok = (long long)H * D;
  const __nv_bfloat16* qb = q + b * st.qb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * st.kb + (long long)h * D;
  const __nv_bfloat16* vb = v + b * st.vb + (long long)h * D;
  const __nv_bfloat16* gb = dout + (long long)b * Tq * tok + (long long)h * D;

  load_tile<D>(qs, qb, st.qt, q0, MR, Tq, L::LDX);
  load_tile<D>(gs, gb, tok, q0, MR, Tq, L::LDX);
  for (int i = threadIdx.x; i < MR; i += MMA_THREADS) {
    const int t = q0 + i;
    rl[i] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    rd[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
  }

  // elementwise step: lanes 2r and 2r+1 take row (warp*16 + r), half each
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const bool row_ok = q0 + row < Tq;
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) mma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < S; k0 += MT) {
    __syncthreads();  // previous tile consumed (first pass: owned rows loaded)
    load_tile<D>(ks, kb, st.kt, k0, MT, S, L::LDX);
    load_tile<D>(vs, vb, st.vt, k0, MT, S, L::LDX);
    __syncthreads();

    // z = Q_w K^T and dp = dO_w V^T, 16 x MT each
    two_products<D>(qs + warp * 16 * L::LDX, gs + warp * 16 * L::LDX, ks, vs,
                    zs + warp * 16 * L::LDS, dps + warp * 16 * L::LDS);
    __syncwarp();
    const float lse_r = rl[row], del_r = rd[row];
    for (int j = 0; j < MT / 2; ++j) {
      const int c = half * (MT / 2) + j;
      const float p = (row_ok && k0 + c < S)
                          ? exp2f(zs[row * L::LDS + c] * qscale - lse_r) : 0.f;
      dss[row * L::LDP + c] = __float2bfloat16(p * (dps[row * L::LDS + c] - del_r));
    }
    __syncwarp();
    // dq_w += ds_w K
    accumulate<D>(acc, dss + warp * 16 * L::LDP, ks);
  }
  __syncthreads();  // the staging below overwrites other warps' z rows
  store_rows<D>(acc, zs, scale, dq + (long long)b * Tq * tok + (long long)h * D, tok, q0, Tq);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dkv_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                  int S, int H, float qscale, float scale, Strides st) {
  using L = MmaSmem<D>;
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
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * MR;
  const long long tok = (long long)H * D;
  const __nv_bfloat16* qb = q + b * st.qb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * st.kb + (long long)h * D;
  const __nv_bfloat16* vb = v + b * st.vb + (long long)h * D;
  const __nv_bfloat16* gb = dout + (long long)b * Tq * tok + (long long)h * D;

  load_tile<D>(ks, kb, st.kt, k0, MR, S, L::LDX);
  load_tile<D>(vs, vb, st.vt, k0, MR, S, L::LDX);

  // elementwise step: lanes 2r and 2r+1 take key row (warp*16 + r), half each
  const int row = warp * 16 + lane / 2, half = lane % 2;
  const bool key_ok = k0 + row < S;
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    mma::fill_fragment(dk_acc[n], 0.f);
    mma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int t0 = 0; t0 < Tq; t0 += MT) {
    __syncthreads();  // previous tile consumed (first pass: owned rows loaded)
    load_tile<D>(qs, qb, st.qt, t0, MT, Tq, L::LDX);
    load_tile<D>(gs, gb, tok, t0, MT, Tq, L::LDX);
    for (int i = threadIdx.x; i < MT; i += MMA_THREADS) {
      const int t = t0 + i;
      rl[i] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
      rd[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
    }
    __syncthreads();

    // z^T = K_w Q^T and dp^T = V_w dO^T, 16 keys x MT queries each
    two_products<D>(ks + warp * 16 * L::LDX, vs + warp * 16 * L::LDX, qs, gs,
                    zs + warp * 16 * L::LDS, dps + warp * 16 * L::LDS);
    __syncwarp();
    for (int j = 0; j < MT / 2; ++j) {
      const int c = half * (MT / 2) + j;
      const float p = (key_ok && t0 + c < Tq)
                          ? exp2f(zs[row * L::LDS + c] * qscale - rl[c]) : 0.f;
      pss[row * L::LDP + c] = __float2bfloat16(p);
      dss[row * L::LDP + c] = __float2bfloat16(p * (dps[row * L::LDS + c] - rd[c]));
    }
    __syncwarp();
    // dv_w += p^T_w dO and dk_w += ds^T_w Q
    accumulate<D>(dv_acc, pss + warp * 16 * L::LDP, gs);
    accumulate<D>(dk_acc, dss + warp * 16 * L::LDP, qs);
  }
  __syncthreads();  // the staging below overwrites other warps' z and dp rows
  const long long out0 = (long long)b * S * tok + (long long)h * D;
  store_rows<D>(dk_acc, zs, scale, dk + out0, tok, k0, S);
  store_rows<D>(dv_acc, dps, 1.f, dv + out0, tok, k0, S);
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

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, void* dq, int B, int Tq, int S, int H, float qscale,
              float scale, Strides st, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    const size_t bytes = f32_smem_floats<D>() * sizeof(float);
    cudaError_t err = set_smem(attn_dq_f32<D>, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((Tq + FB - 1) / FB), (unsigned)(B * H));
    attn_dq_f32<D><<<grid, FTHREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dq), Tq, S, H, qscale, scale, st);
    return (int)cudaGetLastError();
  }
  if (!aligned_bf16(q, k, v, g, dq, st)) return (int)cudaErrorMisalignedAddress;
  const size_t bytes = MmaSmem<D>::bytes;
  cudaError_t err = set_smem(attn_dq_bf16_mma<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + MR - 1) / MR), (unsigned)(B * H));
  attn_dq_bf16_mma<D><<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse, delta,
      static_cast<__nv_bfloat16*>(dq), Tq, S, H, qscale, scale, st);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Tq, int S, int H,
               float qscale, float scale, Strides st, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    const size_t bytes = f32_smem_floats<D>() * sizeof(float);
    cudaError_t err = set_smem(attn_dkv_f32<D>, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((S + FB - 1) / FB), (unsigned)(B * H));
    attn_dkv_f32<D><<<grid, FTHREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, H, qscale, scale, st);
    return (int)cudaGetLastError();
  }
  if (!aligned_bf16(q, k, v, g, dk, st) || reinterpret_cast<uintptr_t>(dv) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t bytes = MmaSmem<D>::bytes;
  cudaError_t err = set_smem(attn_dkv_bf16_mma<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + MR - 1) / MR), (unsigned)(B * H));
  attn_dkv_bf16_mma<D><<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Tq, S, H, qscale,
      scale, st);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share it;
// bf16 pointers 16-byte aligned, bf16 strides multiples of 8). q, k, v take
// the forward's strides (elements; channel stride 1); dout, dq, dk and dv are
// contiguous (B, T|S, H*D); lse (the forward's, base 2) and delta are float32
// (B*H, T). qscale = scale * log2(e). D must be 64. Each returns the
// cudaError_t of its launch.
extern "C" int dpm_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int T, int S, int H, int D, float qscale,
                                    float scale, long long q_bs, long long q_ts, long long k_bs,
                                    long long k_ts, long long v_bs, long long v_ts, int dtype,
                                    void* stream) {
  if ((dtype != 0 && dtype != 1) || D != 64) return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  return launch_dq<64>(q, k, v, dout, static_cast<const float*>(lse),
                       static_cast<const float*>(delta), dq, B, T, S, H, qscale, scale, st,
                       dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dpm_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int T, int S, int H, int D,
                                     float qscale, float scale, long long q_bs, long long q_ts,
                                     long long k_bs, long long k_ts, long long v_bs,
                                     long long v_ts, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || D != 64) return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  return launch_dkv<64>(q, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), dk, dv, B, T, S, H, qscale, scale,
                        st, dtype, static_cast<cudaStream_t>(stream));
}
