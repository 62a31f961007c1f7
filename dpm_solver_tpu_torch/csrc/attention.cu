// Attention forward, softmax(q k^T * scale) v, streamed over key tiles, for sm_90a.
//
// Replaces the Pallas forwards of dpm_solver_tpu/ops/attention.py, which all
// compute this one function and differ only in how they fill the TPU's
// matrix unit: `_forward` (whole K/V panel in VMEM, exact one-pass softmax),
// `_flash_forward` (streamed over key blocks with an online max and sum),
// `_flash_forward_T` and `_panel_forward_T` (the same two with P.V taken
// transposed). Here one block owns one (batch*head, query tile, output
// column slice) and streams K/V in key tiles through shared memory with an
// online fp32 row max and row sum (the flash variant's math), so shared
// memory stays bounded whatever S is and any S works (ragged tails are
// masked). As in the Pallas kernels the softmax runs in base 2 with
// scale*log2(e) folded in, and the exponentials are exp2.
//
// On request the kernel also writes each row's base-2 log-sum-exp of the
// pre-scaled logits, m + log2(l), from the running max and sum it already
// keeps: the residual the backward (attention_bwd.cu) rebuilds P from. That
// output replaces the Pallas side pass `_lse` (`_lse_kernel`), which ran a
// second Q.K^T over the whole key panel; here it costs one float per row.
//
// Layout: o (B, T, H*D) contiguous, head-major channels (h*D + d) as in
// token_attention. q, k and v are (B, T|S, H*D) with unit stride along the
// channels and any batch and token strides, so the column slices of one
// fused qkv projection (token stride 3*H*D) are read in place, with no copy.
//
// What bounds it on the H100: the two products are 2*2*T*S*D flops per head
// against 4*T*D*2 bytes of q/k/v/o in bf16 (T = S), i.e. about S/2
// flop/byte: at S >= 1024 far above the bf16 ridge (~295), so it is
// compute-bound and the products belong on the tensor cores, with every
// intermediate (logits, probabilities, the running output) kept on chip.
// Two kernels, by dtype:
//
// - bf16 (the model's compute dtype): `attention_fwd_bf16_mma`. A block owns
//   64 queries; each of its 4 warps owns 16 rows end to end. Per key tile,
//   Q.K^T and P.V run as WMMA 16x16x16 bf16 products with fp32 accumulators
//   (`mma.sync`); the logits and the online max/sum stay fp32; P is rounded
//   to bf16 for the second product, as the JAX package's XLA path rounds it
//   (`attention_xla`). The running output lives in fp32 shared memory (a
//   wide head would not fit in registers beside the rest). Heads up to 256
//   wide take 64-key tiles and the whole head per block (at D = 256: 190 KB
//   of shared memory). The VAE's single 512-wide head does not fit so: its
//   blocks each own a 256-wide slice of the output (grid.z = 2) and take
//   32-key tiles, and each recomputes the logits over all 512 channels for
//   its slice. That costs one extra Q.K^T product (1.5x the flops of the
//   unsplit form) and keeps a block at 197,632 bytes of shared memory
//   (q 64x520 and k 32x520 bf16, v 32x264 bf16, logits 64x36 fp32,
//   probabilities 64x40 bf16, output 64x260 fp32). `wgmma`, TMA and keeping
//   O in registers are the later steps.
// - fp32: `attention_fwd_f32`, exact on the CUDA cores: 16 queries per block,
//   32-key tiles, the output accumulator in registers 16 columns apart per
//   thread (conflict-free reads of V), K rows padded by one float so the 16
//   threads of a logits row read 16 different banks. At D = 512 a block
//   takes 166,208 bytes of shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

// element strides of q, k and v; o is contiguous (B, T, H*D)
struct Strides {
  long long qb, qt, kb, kt, vb, vt;
};

constexpr int BQ = 16;       // queries per block
constexpr int BKV = 32;      // keys per streamed tile (= warp width)
constexpr int THREADS = 256; // 16 threads per query row

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

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * D + (size_t)BKV * (D + 1) + (size_t)BKV * D + BQ * BKV + 3 * BQ;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int Tq, int S, int H, float qscale, Strides st) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BQ][D], pre-scaled by scale*log2(e)
  float* ks = qs + BQ * D;           // [BKV][D+1]
  float* vs = ks + BKV * (D + 1);    // [BKV][D]
  float* ps = vs + BKV * D;          // [BQ][BKV] logits, then probabilities
  float* row_m = ps + BQ * BKV;      // running max (base 2)
  float* row_l = row_m + BQ;         // running sum
  float* row_a = row_l + BQ;         // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long long otok = (long long)H * D;  // output elements between tokens
  const float* qb = q + b * st.qb + (long long)h * D;
  const float* kb = k + b * st.kb + (long long)h * D;
  const float* vb = v + b * st.vb + (long long)h * D;
  float* ob = o + (long long)b * Tq * otok + (long long)h * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int t = q0 + r;
    qs[idx] = t < Tq ? qb[t * st.qt + d] * qscale : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  const int row = tid / 16;  // query row of this thread (logits and output)
  const int col = tid % 16;  // logits cols col, col+16; output cols col+16*i
  const int warp = tid / 32, lane = tid % 32;
  float acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed; q tile and stats visible
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      const bool valid = key < S;
      ks[j * (D + 1) + d] = valid ? kb[key * st.kt + d] : 0.f;
      vs[j * D + d] = valid ? vb[key * st.vt + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = col + 16 * jj;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row * D + d], ks[j * (D + 1) + d], dot);
      ps[row * BKV + j] = (k0 + j < S) ? dot : -INFINITY;
    }
    __syncthreads();

    // online softmax: warp w updates rows 2w and 2w+1, one key per lane
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const float s = ps[r * BKV + lane];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: every tile has a valid key
      const float p = exp2f(s - m_new);               // masked keys: exp2(-inf) = 0
      const float sum = warp_sum(p);
      ps[r * BKV + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);     // first tile: exp2(-inf) = 0
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    const float alpha = row_a[row];
#pragma unroll
    for (int i = 0; i < D / 16; ++i) acc[i] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = ps[row * BKV + j];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) acc[i] = fmaf(p, vs[j * D + col + 16 * i], acc[i]);
    }
  }

  const int t = q0 + row;
  if (t < Tq) {
    const float inv = 1.f / row_l[row];
#pragma unroll
    for (int i = 0; i < D / 16; ++i) ob[t * otok + col + 16 * i] = acc[i] * inv;
    // base-2 log-sum-exp of the pre-scaled logits, from the final max and sum
    if (lse != nullptr && col == 0) lse[(long long)bh * Tq + t] = row_m[row] + log2f(row_l[row]);
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------

namespace mma = nvcuda::wmma;
constexpr int MQ = 64;            // queries per block: 4 warps x 16 rows
constexpr int MMA_THREADS = 128;

// D: the q/k head width; DV: the output columns one block owns (D, or 256
// for the 512-wide head); KV: keys per streamed tile
template <int D, int DV, int KV>
struct MmaSmem {                  // byte offsets into dynamic shared memory
  static constexpr int LDX = D + 8;   // bf16 q/k tile pitch
  static constexpr int LDV = DV + 8;  // bf16 v tile pitch
  static constexpr int LDS = KV + 4;  // fp32 logits pitch
  static constexpr int LDP = KV + 8;  // bf16 probabilities pitch
  static constexpr int LDO = DV + 4;  // fp32 output pitch
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)MQ * LDX * 2;
  static constexpr size_t v = k + (size_t)KV * LDX * 2;
  static constexpr size_t s = v + (size_t)KV * LDV * 2;
  static constexpr size_t p = s + (size_t)MQ * LDS * 4;
  static constexpr size_t o = p + (size_t)MQ * LDP * 2;
  static constexpr size_t bytes = o + (size_t)MQ * LDO * 4;
};

// rows [row0, row0 + rows) of one head, W wide, from rows `tok` elements apart
// into a bf16 smem tile of pitch ldx, 16 bytes at a time; rows past `valid` are 0
template <int W>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long tok, int row0, int rows, int valid,
                                          int ldx) {
  constexpr int CHUNKS = W / 8;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += MMA_THREADS) {
    const int r = e / CHUNKS, c = 8 * (e % CHUNKS);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * tok + c);
    *reinterpret_cast<uint4*>(dst + r * ldx + c) = val;
  }
}

template <int D, int DV, int KV>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Tq, int S, int H, float qscale, Strides st) {
  static_assert(KV % 32 == 0 && DV % 32 == 0 && D % DV == 0, "tile shapes");
  using L = MmaSmem<D, DV, KV>;
  constexpr int HALF = KV / 2;    // logits of one row per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::v);
  float* ss = reinterpret_cast<float*>(smem_raw + L::s);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::p);
  float* os = reinterpret_cast<float*>(smem_raw + L::o);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * MQ;
  const int c0 = blockIdx.z * DV;  // this block's output columns within the head
  const long long otok = (long long)H * D;
  const __nv_bfloat16* qb = q + b * st.qb + (long long)h * D;
  const __nv_bfloat16* kb = k + b * st.kb + (long long)h * D;
  const __nv_bfloat16* vb = v + b * st.vb + (long long)h * D + c0;
  __nv_bfloat16* ob = o + (long long)b * Tq * otok + (long long)h * D + c0;

  load_tile<D>(qs, qb, st.qt, q0, MQ, Tq, L::LDX);
  for (int e = threadIdx.x; e < MQ * L::LDO; e += MMA_THREADS) os[e] = 0.f;

  // softmax state: lanes 2r and 2r+1 both hold row (warp*16 + r)'s running
  // max and sum, and each owns half of that row's logits
  const int row = warp * 16 + lane / 2, half = lane % 2;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += KV) {
    __syncthreads();  // previous tile consumed (first pass: q tile and O zeroed)
    load_tile<D>(ks, kb, st.kt, k0, KV, S, L::LDX);
    load_tile<DV>(vs, vb, st.vt, k0, KV, S, L::LDV);
    __syncthreads();

    // logits of this warp's 16 rows against the KV keys: Q_w (16 x D) . K^T
    mma::fragment<mma::accumulator, 16, 16, 16, float> sacc[KV / 16];
#pragma unroll
    for (int j = 0; j < KV / 16; ++j) mma::fill_fragment(sacc[j], 0.f);
#pragma unroll 4
    for (int kd = 0; kd < D; kd += 16) {
      mma::fragment<mma::matrix_a, 16, 16, 16, __nv_bfloat16, mma::row_major> fa;
      mma::load_matrix_sync(fa, qs + warp * 16 * L::LDX + kd, L::LDX);
#pragma unroll
      for (int j = 0; j < KV / 16; ++j) {
        // K is [key][d] row-major, i.e. K^T column-major
        mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::col_major> fb;
        mma::load_matrix_sync(fb, ks + j * 16 * L::LDX + kd, L::LDX);
        mma::mma_sync(sacc[j], fa, fb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KV / 16; ++j)
      mma::store_matrix_sync(ss + warp * 16 * L::LDS + j * 16, sacc[j], L::LDS,
                             mma::mem_row_major);
    __syncwarp();

    // online softmax in base 2 over this lane's HALF logits of its row
    float* srow = ss + row * L::LDS + half * HALF;
    float mx = -INFINITY;
    for (int j = 0; j < HALF; ++j) {
      const bool valid = k0 + half * HALF + j < S;
      const float sv = valid ? srow[j] * qscale : -INFINITY;
      srow[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);       // finite: every tile has a valid key
    const float alpha = exp2f(m - m_new);   // first tile: exp2(-inf) = 0
    float sum = 0.f;
    __nv_bfloat16* prow = ps + row * L::LDP + half * HALF;
    for (int j = 0; j < HALF; ++j) {
      const float pv = exp2f(srow[j] - m_new);  // masked keys: exp2(-inf) = 0
      sum += pv;
      prow[j] = __float2bfloat16(pv);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    if (alpha != 1.f) {  // both lanes of a row agree on alpha
      float* orow = os + row * L::LDO + half * (DV / 2);
      for (int c = 0; c < DV / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O_w (16 x DV) += P_w (16 x KV) . V (KV x DV)
    for (int n = 0; n < DV; n += 16) {
      mma::fragment<mma::accumulator, 16, 16, 16, float> oacc;
      float* otile = os + warp * 16 * L::LDO + n;
      mma::load_matrix_sync(oacc, otile, L::LDO, mma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KV; kk += 16) {
        mma::fragment<mma::matrix_a, 16, 16, 16, __nv_bfloat16, mma::row_major> fp;
        mma::fragment<mma::matrix_b, 16, 16, 16, __nv_bfloat16, mma::row_major> fv;
        mma::load_matrix_sync(fp, ps + warp * 16 * L::LDP + kk, L::LDP);
        mma::load_matrix_sync(fv, vs + kk * L::LDV + n, L::LDV);
        mma::mma_sync(oacc, fp, fv, oacc);
      }
      mma::store_matrix_sync(otile, oacc, L::LDO, mma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + row;
  if (t < Tq) {
    const float inv = 1.f / l;
    const float* orow = os + row * L::LDO + half * (DV / 2);
    __nv_bfloat16* dst = ob + t * otok + half * (DV / 2);
    for (int c = 0; c < DV / 2; ++c) dst[c] = __float2bfloat16(orow[c] * inv);
    // base-2 log-sum-exp of the pre-scaled logits (both lanes of a row hold it;
    // every output slice of a 512-wide head has it, the first writes it)
    if (lse != nullptr && half == 0 && blockIdx.z == 0) lse[(long long)bh * Tq + t] = m + log2f(l);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int Tq, int S, int H, float qscale, Strides st, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + BQ - 1) / BQ), (unsigned)(B * H));
  attention_fwd_f32<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, S, H, qscale, st);
  return (int)cudaGetLastError();
}

template <int D, int DV, int KV>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int Tq, int S, int H, float qscale, Strides st, cudaStream_t stream) {
  const size_t bytes = MmaSmem<D, DV, KV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16_mma<D, DV, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + MQ - 1) / MQ), (unsigned)(B * H), (unsigned)(D / DV));
  attention_fwd_bf16_mma<D, DV, KV><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Tq, S, H,
      qscale, st);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Tq,
           int S, int H, float qscale, Strides st, int dtype, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, B, Tq, S, H, qscale, st, s);
  // the bf16 kernel moves q, k, v in 16-byte vectors: every row start aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  if (any % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if constexpr (D == 512) {
    return launch_bf16<D, 256, 32>(q, k, v, o, lse, B, Tq, S, H, qscale, st, s);
  } else {
    return launch_bf16<D, D, 64>(q, k, v, o, lse, B, Tq, S, H, qscale, st, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it; bf16 pointers
// 16-byte aligned, bf16 strides multiples of 8). qscale is scale * log2(e).
// q_bs, q_ts (and k_, v_) are the batch and token strides in elements; the
// channel stride is 1 and o is contiguous. lse is null, or a float32 (B*H, T)
// output for the base-2 log-sum-exp of each row's pre-scaled logits, which the
// backward (attention_bwd.cu) reads. Returns the cudaError_t of the launch.
extern "C" int dpm_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse_out, int B, int T, int S, int H, int D, float qscale,
                                 long long q_bs, long long q_ts, long long k_bs,
                                 long long k_ts, long long v_bs, long long v_ts,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, s);
    case 64: return launch<64>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, s);
    case 128: return launch<128>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, s);
    case 256: return launch<256>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, s);
    case 512: return launch<512>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
