// Attention with its out-projection and residual fused, for sm_90a:
//   out = concat_h(softmax(q_h k_h^T * scale) v_h) @ w_out (+ bias) + residual.
//
// Replaces the Pallas kernel `_attn_out_forward` (`_attn_out_kernel`) of
// dpm_solver_tpu/ops/attention.py, behind `attention_out_fused`. As there, the
// (B*T, H*dh) attention output never reaches device memory: the Pallas kernel
// keeps it in VMEM, this one in shared memory. Head dim 64 only (the SD-2.1
// sites the JAX package measured, benchmarks/attn_out_fused_bench.py).
//
// Layout: q (B, T, H*64), k and v (B, S, H*64), each with unit stride along
// the channels and any batch and token strides (fused-qkv column slices are
// read in place); w_out (H*64, C) row-major; bias (C,) fp32 or null;
// residual and out (B, T, C) contiguous, in the dtype of q.
//
// What bounds it on the H100: the attention is 4*T*S*64 flops per head
// against 2*(T+S)*64*2 bytes of q/k/v in bf16, the out-projection 2*T*H*64*C
// flops against the (H*64, C) weight and 2*T*C*2 bytes of residual and out:
// at the SD sites (T = S >= 2304) far above the bf16 ridge, so it is
// compute-bound and both products belong on the tensor cores.
//
// - bf16: `attention_out_bf16`. A block owns 64 queries of one batch element
//   (4 warps x 16 rows) and loops over the heads. Per head it streams K/V in
//   64-key tiles with the online base-2 max and sum of attention.cu's forward
//   (WMMA bf16 products, fp32 logits, P rounded to bf16, the running output
//   fp32 in shared memory), then writes the head's normalised output, rounded
//   to bf16 as the unfused path rounds token_attention's output, into a
//   (64 x H*64) bf16 buffer in shared memory: 80 KB at C_in = 640. After the
//   last head it multiplies that buffer by w_out, 64 output columns at a
//   time, streaming 64x64 tiles of w_out through shared memory into fp32
//   WMMA accumulators, and adds bias and residual in fp32 on the way out.
//   Shared memory: the concat buffer plus 71,680 bytes of attention tiles,
//   which the out-projection's w tile and fp32 staging then reuse (154,624
//   bytes at H*64 = 640; at most 1024 channels in, 203,776 bytes).
// - fp32: `attention_out_f32`, exact on the CUDA cores: 16 queries per
//   block, 32-key tiles, the output accumulator in registers (attention.cu's
//   fp32 form), the head outputs in a (16 x H*64) fp32 shared buffer; then
//   each thread owns output columns and reads w_out once per block, coalesced.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

struct Strides {
  long long qb, qt, kb, kt, vb, vt;
};

constexpr int D = 64;            // head dim
constexpr int MAX_INNER = 1024;  // H * D: the concat buffer's width

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- bf16 on the tensor cores ---------------------------------------------

namespace mma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int MQ = 64;       // queries per block: 4 warps x 16 rows
constexpr int KV = 64;       // keys per streamed tile
constexpr int NC = 64;       // output columns per out-projection pass
constexpr int KC = 64;       // w_out rows per streamed tile
constexpr int THREADS = 128;
constexpr int LDX = D + 8;   // bf16 q/k/v tile pitch
constexpr int LDS = KV + 4;  // fp32 logits pitch (also the NC-wide output staging)
constexpr int LDP = KV + 8;  // bf16 probabilities pitch
constexpr int LDO = D + 4;   // fp32 head-output pitch
constexpr int LDW = NC + 8;  // bf16 w_out tile pitch
// byte offsets after the concat buffer: the attention tiles, then (reused)
// the out-projection's w_out tile and its fp32 staging
constexpr size_t OFF_Q = 0;
constexpr size_t OFF_K = OFF_Q + (size_t)MQ * LDX * 2;
constexpr size_t OFF_V = OFF_K + (size_t)KV * LDX * 2;
constexpr size_t OFF_S = OFF_V + (size_t)KV * LDX * 2;
constexpr size_t OFF_P = OFF_S + (size_t)MQ * LDS * 4;
constexpr size_t OFF_O = OFF_P + (size_t)MQ * LDP * 2;
constexpr size_t WORK_BYTES = OFF_O + (size_t)MQ * LDO * 4;
constexpr size_t OFF_W = 0;
constexpr size_t OFF_OUT = OFF_W + (size_t)KC * LDW * 2;
static_assert(OFF_OUT + (size_t)MQ * LDS * 4 <= WORK_BYTES, "epilogue fits the tiles");
static_assert(NC + 4 == LDS, "output staging pitch");

size_t bf16_smem_bytes(int inner) { return (size_t)MQ * (inner + 8) * 2 + WORK_BYTES; }

// rows [row0, row0 + rows) of one head, 64 wide, from rows `tok` elements
// apart into a bf16 tile of pitch LDX, 16 bytes at a time; rows past `valid` are 0
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long tok, int row0,
                                          int rows, int valid) {
  constexpr int CHUNKS = D / 8;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = 8 * (e % CHUNKS);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * tok + c);
    *reinterpret_cast<uint4*>(dst + r * LDX + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_out_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const bf16* __restrict__ res,
                   bf16* __restrict__ out, int Tq, int S, int H, int C, float qscale,
                   Strides st) {
  constexpr int HALF = KV / 2;  // logits of one row per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int inner = H * D, ldc = inner + 8;
  bf16* cat = reinterpret_cast<bf16*>(smem_raw);  // [MQ][ldc]: every head's output
  unsigned char* work = smem_raw + (size_t)MQ * ldc * 2;
  bf16* qs = reinterpret_cast<bf16*>(work + OFF_Q);
  bf16* ks = reinterpret_cast<bf16*>(work + OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(work + OFF_V);
  float* ss = reinterpret_cast<float*>(work + OFF_S);
  bf16* ps = reinterpret_cast<bf16*>(work + OFF_P);
  float* os = reinterpret_cast<float*>(work + OFF_O);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, q0 = blockIdx.x * MQ;
  // lanes 2r and 2r+1 own row warp*16 + r: its softmax state and half its columns
  const int row = warp * 16 + lane / 2, half = lane % 2;

  for (int h = 0; h < H; ++h) {
    const bf16* qb = q + b * st.qb + (long long)h * D;
    const bf16* kb = k + b * st.kb + (long long)h * D;
    const bf16* vb = v + b * st.vb + (long long)h * D;
    __syncthreads();  // the previous head's tiles are consumed
    load_tile(qs, qb, st.qt, q0, MQ, Tq);
    for (int e = threadIdx.x; e < MQ * LDO; e += THREADS) os[e] = 0.f;
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < S; k0 += KV) {
      __syncthreads();  // previous key tile consumed (first: q tile and O zeroed)
      load_tile(ks, kb, st.kt, k0, KV, S);
      load_tile(vs, vb, st.vt, k0, KV, S);
      __syncthreads();

      // logits of this warp's 16 rows against the KV keys: Q_w (16 x 64) . K^T
      mma::fragment<mma::accumulator, 16, 16, 16, float> sacc[KV / 16];
#pragma unroll
      for (int j = 0; j < KV / 16; ++j) mma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        mma::fragment<mma::matrix_a, 16, 16, 16, bf16, mma::row_major> fa;
        mma::load_matrix_sync(fa, qs + warp * 16 * LDX + kd, LDX);
#pragma unroll
        for (int j = 0; j < KV / 16; ++j) {
          mma::fragment<mma::matrix_b, 16, 16, 16, bf16, mma::col_major> fb;  // K^T
          mma::load_matrix_sync(fb, ks + j * 16 * LDX + kd, LDX);
          mma::mma_sync(sacc[j], fa, fb, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KV / 16; ++j)
        mma::store_matrix_sync(ss + warp * 16 * LDS + j * 16, sacc[j], LDS, mma::mem_row_major);
      __syncwarp();

      // online softmax in base 2 over this lane's half of its row
      float* srow = ss + row * LDS + half * HALF;
      float mx = -INFINITY;
      for (int j = 0; j < HALF; ++j) {
        const float sv = k0 + half * HALF + j < S ? srow[j] * qscale : -INFINITY;
        srow[j] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);      // finite: every tile has a valid key
      const float alpha = exp2f(m - m_new);  // first tile: exp2(-inf) = 0
      float sum = 0.f;
      bf16* prow = ps + row * LDP + half * HALF;
      for (int j = 0; j < HALF; ++j) {
        const float pv = exp2f(srow[j] - m_new);  // masked keys: exp2(-inf) = 0
        sum += pv;
        prow[j] = __float2bfloat16(pv);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      if (alpha != 1.f) {
        float* orow = os + row * LDO + half * (D / 2);
        for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
      }
      __syncwarp();

      // O_w (16 x 64) += P_w (16 x KV) . V (KV x 64)
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        mma::fragment<mma::accumulator, 16, 16, 16, float> oacc;
        float* otile = os + warp * 16 * LDO + n;
        mma::load_matrix_sync(oacc, otile, LDO, mma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < KV; kk += 16) {
          mma::fragment<mma::matrix_a, 16, 16, 16, bf16, mma::row_major> fp;
          mma::fragment<mma::matrix_b, 16, 16, 16, bf16, mma::row_major> fv;
          mma::load_matrix_sync(fp, ps + warp * 16 * LDP + kk, LDP);
          mma::load_matrix_sync(fv, vs + kk * LDX + n, LDX);
          mma::mma_sync(oacc, fp, fv, oacc);
        }
        mma::store_matrix_sync(otile, oacc, LDO, mma::mem_row_major);
      }
      __syncwarp();
    }

    // the head's normalised output, rounded to bf16, into its concat columns
    const float inv = 1.f / l;
    const float* orow = os + row * LDO + half * (D / 2);
    bf16* crow = cat + row * ldc + h * D + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) crow[c] = __float2bfloat16(orow[c] * inv);
  }

  // out-projection: cat (64 x inner) . w_out (inner x C), NC columns at a time
  bf16* ws = reinterpret_cast<bf16*>(work + OFF_W);
  float* outs = reinterpret_cast<float*>(work + OFF_OUT);
  const int t = q0 + row;
  for (int n0 = 0; n0 < C; n0 += NC) {
    mma::fragment<mma::accumulator, 16, 16, 16, float> acc[NC / 16];
#pragma unroll
    for (int j = 0; j < NC / 16; ++j) mma::fill_fragment(acc[j], 0.f);
    for (int kc = 0; kc < inner; kc += KC) {
      __syncthreads();  // the concat buffer is complete; the previous w tile consumed
      constexpr int CHUNKS = NC / 8;
      for (int e = threadIdx.x; e < KC * CHUNKS; e += THREADS) {
        const int r = e / CHUNKS, c = 8 * (e % CHUNKS);
        uint4 val = make_uint4(0, 0, 0, 0);  // columns past C are 0 (C % 8 == 0)
        if (n0 + c < C) val = *reinterpret_cast<const uint4*>(w + (long long)(kc + r) * C + n0 + c);
        *reinterpret_cast<uint4*>(ws + r * LDW + c) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        mma::fragment<mma::matrix_a, 16, 16, 16, bf16, mma::row_major> fa;
        mma::load_matrix_sync(fa, cat + warp * 16 * ldc + kc + kk, ldc);
#pragma unroll
        for (int j = 0; j < NC / 16; ++j) {
          mma::fragment<mma::matrix_b, 16, 16, 16, bf16, mma::row_major> fb;
          mma::load_matrix_sync(fb, ws + kk * LDW + j * 16, LDW);
          mma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    // each warp stages and writes only its own 16 rows
#pragma unroll
    for (int j = 0; j < NC / 16; ++j)
      mma::store_matrix_sync(outs + warp * 16 * LDS + j * 16, acc[j], LDS, mma::mem_row_major);
    __syncwarp();
    if (t < Tq) {
      const float* src = outs + row * LDS + half * (NC / 2);
      const long long base = ((long long)b * Tq + t) * C;
      for (int c = 0; c < NC / 2; ++c) {
        const int n = n0 + half * (NC / 2) + c;
        if (n < C) {
          const float val = src[c] + (bias != nullptr ? bias[n] : 0.f);
          out[base + n] = __float2bfloat16(val + __bfloat162float(res[base + n]));
        }
      }
    }
    __syncwarp();  // staging read before the next pass overwrites it
  }
}

// ---- fp32 on the CUDA cores -------------------------------------------------

constexpr int FQ = 16;        // queries per block
constexpr int FKV = 32;       // keys per streamed tile (= warp width)
constexpr int FTHREADS = 256; // 16 threads per query row

size_t f32_smem_bytes(int inner) {
  return sizeof(float) * ((size_t)FQ * inner + FQ * D + FKV * (D + 1) + FKV * D + FQ * FKV +
                          3 * FQ);
}

__global__ void __launch_bounds__(FTHREADS)
attention_out_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ res,
                  float* __restrict__ out, int Tq, int S, int H, int C, float qscale,
                  Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int inner = H * D;
  float* cat = smem;                  // [FQ][inner]: every head's output
  float* qs = cat + FQ * inner;       // [FQ][D], pre-scaled by scale*log2(e)
  float* ks = qs + FQ * D;            // [FKV][D+1]
  float* vs = ks + FKV * (D + 1);     // [FKV][D]
  float* ps = vs + FKV * D;           // [FQ][FKV] logits, then probabilities
  float* row_m = ps + FQ * FKV;       // running max (base 2)
  float* row_l = row_m + FQ;          // running sum
  float* row_a = row_l + FQ;          // this tile's rescale factor

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * FQ;
  const int row = tid / 16, col = tid % 16;  // output cols col + 16*i
  const int warp = tid / 32, lane = tid % 32;

  for (int h = 0; h < H; ++h) {
    const float* qb = q + b * st.qb + (long long)h * D;
    const float* kb = k + b * st.kb + (long long)h * D;
    const float* vb = v + b * st.vb + (long long)h * D;
    __syncthreads();  // the previous head's state is consumed
    for (int idx = tid; idx < FQ * D; idx += FTHREADS) {
      const int r = idx / D, d = idx % D;
      qs[idx] = q0 + r < Tq ? qb[(q0 + r) * st.qt + d] * qscale : 0.f;
    }
    if (tid < FQ) {
      row_m[tid] = -INFINITY;
      row_l[tid] = 0.f;
    }
    float acc[D / 16];
#pragma unroll
    for (int i = 0; i < D / 16; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < S; k0 += FKV) {
      __syncthreads();
      for (int idx = tid; idx < FKV * D; idx += FTHREADS) {
        const int j = idx / D, d = idx % D;
        const bool valid = k0 + j < S;
        ks[j * (D + 1) + d] = valid ? kb[(k0 + j) * st.kt + d] : 0.f;
        vs[j * D + d] = valid ? vb[(k0 + j) * st.vt + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = col + 16 * jj;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[row * D + d], ks[j * (D + 1) + d], dot);
        ps[row * FKV + j] = k0 + j < S ? dot : -INFINITY;
      }
      __syncthreads();
      // online softmax: warp w updates rows 2w and 2w+1, one key per lane
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        const float s = ps[r * FKV + lane];
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, warp_max(s));
        const float p = exp2f(s - m_new);
        const float sum = warp_sum(p);
        ps[r * FKV + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          row_l[r] = row_l[r] * alpha + sum;
          row_m[r] = m_new;
          row_a[r] = alpha;
        }
      }
      __syncthreads();
      const float alpha = row_a[row];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) acc[i] *= alpha;
      for (int j = 0; j < FKV; ++j) {
        const float p = ps[row * FKV + j];
#pragma unroll
        for (int i = 0; i < D / 16; ++i) acc[i] = fmaf(p, vs[j * D + col + 16 * i], acc[i]);
      }
    }
    const float inv = 1.f / row_l[row];
#pragma unroll
    for (int i = 0; i < D / 16; ++i) cat[row * inner + h * D + col + 16 * i] = acc[i] * inv;
  }
  __syncthreads();  // the concat buffer is complete

  // out-projection: each thread owns columns c, reading w_out once, coalesced
  for (int c = tid; c < C; c += FTHREADS) {
    float o[FQ];
#pragma unroll
    for (int r = 0; r < FQ; ++r) o[r] = 0.f;
    for (int kk = 0; kk < inner; ++kk) {
      const float wv = w[(long long)kk * C + c];
#pragma unroll
      for (int r = 0; r < FQ; ++r) o[r] = fmaf(cat[r * inner + kk], wv, o[r]);
    }
    const float bv = bias != nullptr ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < FQ; ++r) {
      if (q0 + r < Tq) {
        const long long idx = ((long long)b * Tq + q0 + r) * C + c;
        out[idx] = o[r] + bv + res[idx];
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, w, residual and out share it;
// bf16 pointers 16-byte aligned, bf16 strides and C multiples of 8). D must
// be 64 and H*D at most 1024. qscale is scale * log2(e). q_bs, q_ts (and k_,
// v_) are batch and token strides in elements, the channel stride 1; w is
// (H*D, C) row-major; bias is null or (C,) fp32; residual and out are (B, T,
// C) contiguous. Returns the cudaError_t of the launch.
extern "C" int dpm_attention_out_fwd(const void* q, const void* k, const void* v, const void* w,
                                     const void* bias, const void* res, void* out, int B, int T,
                                     int S, int H, int Dh, int C, float qscale, long long q_bs,
                                     long long q_ts, long long k_bs, long long k_ts,
                                     long long v_bs, long long v_ts, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inner = H * Dh;
  if (Dh != D || inner > MAX_INNER || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  const float* fbias = static_cast<const float*>(bias);
  if (dtype == 0) {
    const size_t bytes = f32_smem_bytes(inner);
    cudaError_t err = cudaFuncSetAttribute(attention_out_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((T + FQ - 1) / FQ), (unsigned)B);
    attention_out_f32<<<grid, FTHREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(w), fbias, static_cast<const float*>(res),
        static_cast<float*>(out), T, S, H, C, qscale, st);
    return (int)cudaGetLastError();
  }
  // the bf16 kernel moves q, k, v and w in 16-byte vectors
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt | C;
  if (any % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const size_t bytes = bf16_smem_bytes(inner);
  cudaError_t err = cudaFuncSetAttribute(attention_out_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((T + MQ - 1) / MQ), (unsigned)B);
  attention_out_bf16<<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(w), fbias, static_cast<const bf16*>(res), static_cast<bf16*>(out),
      T, S, H, C, qscale, st);
  return (int)cudaGetLastError();
}
