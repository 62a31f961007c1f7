// GEGLU feed-forward, out = (h * gelu(gate)) . W2^T + b2 with
// [h | gate] = x . W1^T + b1, for sm_90a.
//
// Replaces the Pallas kernel dpm_solver_tpu/ops/geglu.py::_geglu_pallas (body
// `_kernel`). That kernel walked the inner dimension as the sequential last
// grid axis and carried an fp32 (TM, d) accumulator in VMEM scratch from one
// step to the next, so the (M, inner) gated tile never reached HBM. Hopper
// blocks run in parallel and in no order, and a block cannot hold that
// accumulator: at d = 1,280 it is 5 KB a row, more than two warpgroups'
// registers hold for 64 rows. A fused kernel would have to split the output
// columns across blocks and recompute h * gelu(gate) for each slice (the
// first kernel, kept below as the "wmma" route, does that: 1.67x the flops at
// d = 320, 2.33x at 640 and 1,280). So the bf16 route is two kernels, and
// the gated tile P goes through device memory once:
//
//   P   = bf16((x . W1h^T + b1h) * gelu_exact(x . W1g^T + b1g))   (M, I)
//   out = bf16(P . W2^T + b2)                                       (M, d)
//
// with fp32 accumulators, and the gate exact: 0.5 g (1 + erf(g / sqrt 2)),
// `erff` (the Abramowitz-Stegun erf of the Pallas kernel was a workaround for
// Mosaic, which has no erf, not part of the function).
//
// What bounds it on the H100 (I = 4d at every SD site). The function does
// 24 M d^2 flops against 4 M d bytes of x and out (plus the weights, 24 d^2
// bytes, read once): some thousands of flops a byte, compute-bound. Split in
// two, P adds 8 M d bytes written and 8 M d read:
// - the gate kernel does 16 M d^2 flops against 2 M d + 8 M d bytes:
//   1.6 d flops a byte, 512 at d = 320, above the card's ~295 ridge:
//   compute-bound;
// - the down kernel does 8 M d^2 flops against 8 M d + 2 M d bytes: 0.8 d
//   flops a byte, 256 at d = 320 (byte-bound there, by 0.009 ms a launch at
//   M = 73,728), 512 and 1,024 at d = 640 and 1,280;
// so over path B's launches the pair's bound is within 2% of the fused
// function's (5% at the d = 320 sites alone, none at the others).
// Both kernels therefore keep the tensor cores fed at their full rate:
// `wgmma` on tiles that TMA brings into shared memory, in the shape of
// conv3x3.cu's `conv3x3_wgmma`. One producer warp streams the reduction
// through a ring of stages guarded by full and empty mbarriers; two consumer
// warpgroups issue `wgmma` with fp32 accumulators in registers, keep one
// group of products in flight while the next stage is waited for, and
// release each stage when its products are done. Every operand is K-major
// (x and P along d and I, W1 (2I, d) and W2 (d, I) in torch's Linear
// layout), read through 128-byte-swizzled 64-column tiles with no transpose.
// TMA's zero fill pads rows past M and columns past d or I, so no load
// carries a mask; the stores mask the ragged edges.
//
// - "wgmma" (bf16, d % 8 == 0 and I % 8 == 0, 16-byte aligned tensors):
//   `geglu_gate_wgmma` then `geglu_down_wgmma`.
//   * gate: a block owns 128 rows (64 at small M) and 64 inner columns.
//     Each stage is the x box and two W1 boxes, the h rows j0... and the
//     gate rows I + j0..., stacked as one 128-row B tile, so one m64n128k16
//     product gives a warpgroup h in its first 64 columns and gate in its
//     last 64, and the thread that holds h[r, c] holds gate[r, c] (with 64
//     rows a block, the two warpgroups split the 64 columns: m64n64k16 over
//     32 of h and 32 of gate each). The epilogue adds b1, applies the gate,
//     multiplies, rounds once to bf16 and stores P: the [h | gate] fp32 tile
//     never leaves the registers. 96 KB of shared memory a block, so two
//     blocks share an SM and one's gelu epilogue (erff on the CUDA cores)
//     runs under the other's products.
//   * down: a block owns 128 rows (64 at small M) and 160 output columns
//     (320, 640 and 1,280 are multiples of 160): m64n160k16 per warpgroup
//     (m64n80k16 each at 64 rows). The epilogue adds the fp32 b2 and rounds
//     once to bf16. Where even 64-row tiles leave the card short of blocks
//     (SD-1's small maps), the reduction over I is split across blockIdx.y:
//     each split stores fp32 partials and `geglu_splitk_sum` adds them, b2,
//     and rounds.
//   The tiles and the split are the host's (ops/geglu.py::geglu_plan); the
//   entry refuses one it was not compiled for. The wrapper allocates P and
//   the partials; the kernels allocate nothing.
// - "wmma" (bf16 with ragged widths, where TMA cannot stride):
//   `geglu_bf16_mma`, the first fused kernel, as it was: the x tile resident in
//   shared memory, WMMA 16x16x16 fragments (`mma.sync`), the output columns
//   split across blocks with h * gelu(gate) recomputed per slice.
// - "f32": `geglu_f32`, the exact form on the CUDA cores, 16 rows and 64
//   output columns per block, for the card-against-CPU trajectory check.

#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu_exact(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

constexpr int TI = 64;            // inner columns per step (each of h and gate)
constexpr int KB = 32;            // x . W1 reduction depth staged per step
constexpr int THREADS = 256;      // 8 warps
constexpr int LDW1 = KB + 8;      // bf16 [h | gate] weight tile pitch: [2 TI][LDW1]
constexpr int LDHG = 2 * TI + 4;  // fp32 [h | gate] tile pitch
constexpr int LDP = TI + 8;       // bf16 gated tile pitch
constexpr int LDW2 = TI + 8;      // bf16 W2 tile pitch: [DN][LDW2]

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

struct Layout {                   // byte offsets into dynamic shared memory
  int kpad, ldx;
  size_t x, w1, hg, p, w2, bytes;
};

__host__ __device__ inline Layout layout(int tm, int d, int dn) {
  Layout s;
  s.kpad = round_up(d, KB);
  s.ldx = s.kpad + 8;
  s.x = 0;
  s.w1 = s.x + (size_t)tm * s.ldx * 2;
  s.hg = s.w1 + (size_t)2 * TI * LDW1 * 2;
  s.p = s.hg + (size_t)tm * LDHG * 4;
  s.w2 = s.p + (size_t)tm * LDP * 2;
  s.bytes = s.w2 + (size_t)dn * LDW2 * 2;
  return s;
}

// TM rows per block, NF output fragments per warp: WM = TM/16 warps along the
// rows, WN = 8/WM along the columns, DN = 16 * NF * WN output columns
template <int TM, int NF>
__global__ void __launch_bounds__(THREADS, 1)
geglu_bf16_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int d, int I,
               bool vec_x, bool vec_w1, bool vec_w2) {
  constexpr int WM = TM / 16, WN = 8 / WM;
  constexpr int F1 = 2 * TI / 16 / WN;  // [h | gate] fragments per warp
  constexpr int DN = 16 * NF * WN;
  static_assert(WM * WN == 8 && F1 >= 1, "warp layout");
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(TM, d, DN);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);      // [TM][ldx]
  bf16* W1s = reinterpret_cast<bf16*>(smem + L.w1);    // [2 TI][LDW1]: [h | gate] rows of W1
  float* HG = reinterpret_cast<float*>(smem + L.hg);   // [TM][LDHG]
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);      // [TM][LDP]
  bf16* W2s = reinterpret_cast<bf16*>(smem + L.w2);    // [DN][LDW2]: W2[n0 + c, i0 + r]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % WM, wc = warp / WM;
  const long long m0 = (long long)blockIdx.x * TM;
  const int n0 = blockIdx.y * DN;
  const bf16 zero = __float2bfloat16(0.f);

  // the x tile, zero past M and in the columns [d, kpad)
  if (vec_x) {
    const int chunks = L.kpad / 8;
    for (int e = tid; e < TM * chunks; e += THREADS) {
      const int r = e / chunks, c = 8 * (e % chunks);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && c < d) v = *reinterpret_cast<const uint4*>(x + (m0 + r) * d + c);
      *reinterpret_cast<uint4*>(Xs + r * L.ldx + c) = v;
    }
  } else {
    for (int e = tid; e < TM * L.kpad; e += THREADS) {
      const int r = e / L.kpad, c = e % L.kpad;
      Xs[r * L.ldx + c] = (m0 + r < M && c < d) ? x[(m0 + r) * d + c] : zero;
    }
  }

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wm::fill_fragment(acc[f], 0.f);

  for (int i0 = 0; i0 < I; i0 += TI) {
    // [h | gate] (TM x 128) = X (TM x d) . [W1 h-tile | W1 gate-tile]
    wm::fragment<wm::accumulator, 16, 16, 16, float> hg[F1];
#pragma unroll
    for (int f = 0; f < F1; ++f) wm::fill_fragment(hg[f], 0.f);
    for (int k0 = 0; k0 < L.kpad; k0 += KB) {
      __syncthreads();  // the x tile is staged; the previous W1 tile is consumed
      if (vec_w1) {     // d % 8 == 0: a chunk of 8 along d is in or out as a whole
        for (int e = tid; e < 2 * TI * (KB / 8); e += THREADS) {
          const int c = e / (KB / 8), kk = 8 * (e % (KB / 8));
          const int ic = i0 + c % TI;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ic < I && k0 + kk < d)
            v = *reinterpret_cast<const uint4*>(w1 + (long long)(c < TI ? ic : I + ic) * d +
                                                k0 + kk);
          *reinterpret_cast<uint4*>(W1s + c * LDW1 + kk) = v;
        }
      } else {
        for (int e = tid; e < 2 * TI * KB; e += THREADS) {
          const int c = e / KB, kk = e % KB;
          const int ic = i0 + c % TI;
          W1s[c * LDW1 + kk] = (ic < I && k0 + kk < d)
                                   ? w1[(long long)(c < TI ? ic : I + ic) * d + k0 + kk]
                                   : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KB; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
        wm::load_matrix_sync(fa, Xs + wr * 16 * L.ldx + k0 + kk, L.ldx);
#pragma unroll
        for (int f = 0; f < F1; ++f) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
          wm::load_matrix_sync(fb, W1s + (wc * F1 + f) * 16 * LDW1 + kk, LDW1);
          wm::mma_sync(hg[f], fa, fb, hg[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F1; ++f)
      wm::store_matrix_sync(HG + wr * 16 * LDHG + (wc * F1 + f) * 16, hg[f], LDHG,
                            wm::mem_row_major);
    // the W2 tile: this block's DN rows of W2 (output columns), inner i0 .. i0+TI
    if (vec_w2) {  // I % 8 == 0
      for (int e = tid; e < DN * (TI / 8); e += THREADS) {
        const int c = e / (TI / 8), r = 8 * (e % (TI / 8));
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n0 + c < d && i0 + r < I)
          v = *reinterpret_cast<const uint4*>(w2 + (long long)(n0 + c) * I + i0 + r);
        *reinterpret_cast<uint4*>(W2s + c * LDW2 + r) = v;
      }
    } else {
      for (int e = tid; e < DN * TI; e += THREADS) {
        const int c = e / TI, r = e % TI;
        W2s[c * LDW2 + r] =
            (n0 + c < d && i0 + r < I) ? w2[(long long)(n0 + c) * I + i0 + r] : zero;
      }
    }
    __syncthreads();
    // the gate in fp32, one rounding to bf16 (columns past I give 0 * gelu(0) = 0)
    for (int e = tid; e < TM * TI; e += THREADS) {
      const int r = e / TI, c = e % TI;
      const bool in = i0 + c < I;
      const float h = HG[r * LDHG + c] + (in ? b1[i0 + c] : 0.f);
      const float g = HG[r * LDHG + TI + c] + (in ? b1[I + i0 + c] : 0.f);
      Ps[r * LDP + c] = __float2bfloat16(h * gelu_exact(g));
    }
    __syncthreads();
    // acc (TM x DN) += P (TM x TI) . W2 tile (TI x DN)
#pragma unroll
    for (int kk = 0; kk < TI; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::load_matrix_sync(fa, Ps + wr * 16 * LDP + kk, LDP);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
        wm::load_matrix_sync(fb, W2s + (wc * NF + f) * 16 * LDW2 + kk, LDW2);
        wm::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }

  // epilogue: each warp through its own 16x16 fp32 scratch in the HG tile,
  // + b2 in fp32, one rounding to bf16
  __syncthreads();
  float* scratch = HG + warp * 256;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wm::store_matrix_sync(scratch, acc[f], 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const long long m = m0 + wr * 16 + e / 16;
      const int col = n0 + (wc * NF + f) * 16 + e % 16;
      if (m < M && col < d) out[m * d + col] = __float2bfloat16(scratch[e] + b2[col]);
    }
    __syncwarp();
  }
}

// ---- fp32 on the CUDA cores -------------------------------------------------

constexpr int GM = 16;            // rows per block
constexpr int GN = 64;            // output columns per block
constexpr int GI = 32;            // inner columns per step
constexpr int GTHREADS = 256;

__global__ void __launch_bounds__(GTHREADS)
geglu_f32(const float* __restrict__ x, const float* __restrict__ w1,
          const float* __restrict__ b1, const float* __restrict__ w2,
          const float* __restrict__ b2, float* __restrict__ out, int M, int d, int I) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                 // [GM][d]
  float* ps = xs + GM * d;        // [GM][GI] gated values
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * GM;
  const long long rows = min((long long)GM, (long long)M - m0);
  for (int e = tid; e < GM * d; e += GTHREADS) xs[e] = e < rows * d ? x[m0 * d + e] : 0.f;
  const int col = blockIdx.y * GN + tid % GN, rg = tid / GN;  // 4 rows per thread
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < I; i0 += GI) {
    __syncthreads();  // x staged; the previous gated tile consumed
    for (int e = tid; e < GM * GI; e += GTHREADS) {
      const int r = e / GI, ic = i0 + e % GI;
      float p = 0.f;
      if (ic < I) {
        float h = 0.f, g = 0.f;
        for (int k = 0; k < d; ++k) {
          const float xv = xs[r * d + k];
          h = fmaf(xv, w1[(long long)ic * d + k], h);
          g = fmaf(xv, w1[(long long)(I + ic) * d + k], g);
        }
        p = (h + b1[ic]) * gelu_exact(g + b1[I + ic]);
      }
      ps[e] = p;
    }
    __syncthreads();
    if (col < d) {
      for (int c = 0; c < GI && i0 + c < I; ++c) {
        const float wv = w2[(long long)col * I + i0 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(ps[(rg * 4 + i) * GI + c], wv, acc[i]);
      }
    }
  }
  if (col < d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + rg * 4 + i;
      if (m < M) out[m * d + col] = acc[i] + b2[col];
    }
  }
}

// ---- bf16 on the tensor cores: TMA + wgmma ---------------------------------

constexpr int WG_THREADS = 2 * 128 + 32;  // two consumer warpgroups + the producer warp

// The gate kernel: a block owns 64 * WM rows and 64 inner columns. WM = 2:
// the two warpgroups split the rows and each multiplies its 64 rows by the
// whole 128-row B tile [64 h | 64 gate]; WM = 1: they split the columns and
// each takes 64 B rows [32 h | 32 gate] of the tile.
constexpr int GATE_COLS = 64;
constexpr int GATE_STAGES = 3;
constexpr uint32_t GATE_B_BYTES = 2 * GATE_COLS * 128;  // 128 W1 rows x 64 along d

template <int WM>
struct GateTile {
  static constexpr int BM = 64 * WM;
  static constexpr int WN = 2 / WM;        // warpgroups along the columns
  static constexpr int N = 128 / WN;       // B rows of one warpgroup: [N/2 h | N/2 gate]
  static constexpr uint32_t A_BYTES = BM * 128;
  static constexpr uint32_t STAGE = A_BYTES + GATE_B_BYTES;
  static constexpr size_t SMEM = 1024 + GATE_STAGES * (size_t)STAGE + 16 * GATE_STAGES;
};

template <int WM>
__global__ void __launch_bounds__(WG_THREADS, 2)
geglu_gate_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ b1, bf16* __restrict__ p, int M, int d, int I,
                 int tiles_i) {
  using namespace hopper;
  using T = GateTile<WM>;
  constexpr int HALF = T::N / 2;  // h (and gate) columns of one warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GATE_STAGES * T::STAGE);
  uint64_t* empty = full + GATE_STAGES;

  // block -> (inner tile, row tile); the inner tiles of one row tile are
  // neighbours, so its x is read from L2 by all of them
  const int j0 = (blockIdx.x % tiles_i) * GATE_COLS;
  const int m0 = (blockIdx.x / tiles_i) * T::BM;
  const int niter = (d + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GATE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one lane starts every load
    if (lane == 0) {
      for (int it = 0; it < niter; ++it) {
        const int s = it % GATE_STAGES;
        mbar_wait(&empty[s], ((it / GATE_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        uint8_t* a = ring + s * T::STAGE;
        tma_load_2d(a, &xmap, &full[s], 64 * it, m0);
        for (int wn = 0; wn < T::WN; ++wn) {
          uint8_t* bt = a + T::A_BYTES + wn * T::N * 128;
          tma_load_2d(bt, &wmap, &full[s], 64 * it, j0 + wn * HALF);
          tma_load_2d(bt + HALF * 128, &wmap, &full[s], 64 * it, I + j0 + wn * HALF);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wm.. and B rows N wn..
  const int wg = warp / 4, wm = wg % WM, wn = wg / WM;
  float acc[T::N / 2];
#pragma unroll
  for (int i = 0; i < T::N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int it = 0; it < niter; ++it) {
    const int s = it % GATE_STAGES;
    mbar_wait(&full[s], (it / GATE_STAGES) & 1);
    const uint32_t a = smem_u32(ring + s * T::STAGE) + wm * 64 * 128;
    const uint32_t bt = smem_u32(ring + s * T::STAGE + T::A_BYTES) + wn * T::N * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<T::N>::template ss<0>(acc, desc(a + kk * 32, 16, 1024), desc(bt + kk * 32, 16, 1024), 1);
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % GATE_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: this thread holds rows r and r + 8 of its warp's 16, columns
  // 2(lane%4) (+1) of every 8; h in the first HALF columns, gate in the rest
  const int quad = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wm * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
    if (m >= M) continue;
    bf16* dst = p + (long long)m * I;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int c = j0 + wn * HALF + 8 * j + 2 * quad;
      if (c >= I) continue;  // I % 8 == 0: a pair is in or out as a whole
      const float h0 = acc[4 * j + 2 * r] + b1[c], h1 = acc[4 * j + 2 * r + 1] + b1[c + 1];
      const float g0 = acc[4 * (j + HALF / 8) + 2 * r] + b1[I + c];
      const float g1 = acc[4 * (j + HALF / 8) + 2 * r + 1] + b1[I + c + 1];
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(h0 * gelu_exact(g0), h1 * gelu_exact(g1));
    }
  }
}

// The down kernel: a block owns 64 * WM rows and 160 output columns; WM = 2:
// the warpgroups split the rows (m64n160k16 each), WM = 1: the columns
// (m64n80k16 each). blockIdx.y is the split of the reduction over I.
constexpr int DOWN_COLS = 160;
constexpr int DOWN_STAGES = 4;

template <int WM>
struct DownTile {
  static constexpr int BM = 64 * WM;
  static constexpr int WN = 2 / WM;
  static constexpr int N = DOWN_COLS / WN;  // output columns of one warpgroup
  static constexpr uint32_t A_BYTES = BM * 128;
  static constexpr uint32_t B_BYTES = DOWN_COLS * 128;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + DOWN_STAGES * (size_t)STAGE + 16 * DOWN_STAGES;
};

template <int WM>
__global__ void __launch_bounds__(WG_THREADS, 1)
geglu_down_wgmma(const __grid_constant__ CUtensorMap pmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ part,
                 int M, int d, int I, int tiles_n, int chunks_per_split) {
  using namespace hopper;
  using T = DownTile<WM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DOWN_STAGES * T::STAGE);
  uint64_t* empty = full + DOWN_STAGES;

  const int n0 = (blockIdx.x % tiles_n) * DOWN_COLS;
  const int m0 = (blockIdx.x / tiles_n) * T::BM;
  const int k0 = blockIdx.y * chunks_per_split;
  const int niter = min((I + 63) / 64 - k0, chunks_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DOWN_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int it = 0; it < niter; ++it) {
        const int s = it % DOWN_STAGES;
        mbar_wait(&empty[s], ((it / DOWN_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        uint8_t* a = ring + s * T::STAGE;
        const int kc = 64 * (k0 + it);
        tma_load_2d(a, &pmap, &full[s], kc, m0);
        for (int wn = 0; wn < T::WN; ++wn)
          tma_load_2d(a + T::A_BYTES + wn * T::N * 128, &wmap, &full[s], kc, n0 + wn * T::N);
      }
    }
    return;
  }

  const int wg = warp / 4, wm = wg % WM, wn = wg / WM;
  float acc[T::N / 2];
#pragma unroll
  for (int i = 0; i < T::N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int it = 0; it < niter; ++it) {
    const int s = it % DOWN_STAGES;
    mbar_wait(&full[s], (it / DOWN_STAGES) & 1);
    const uint32_t a = smem_u32(ring + s * T::STAGE) + wm * 64 * 128;
    const uint32_t bt = smem_u32(ring + s * T::STAGE + T::A_BYTES) + wn * T::N * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<T::N>::template ss<0>(acc, desc(a + kk * 32, 16, 1024), desc(bt + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % DOWN_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: + b2 and one rounding to bf16, or (a split) the fp32 partial
  const int quad = lane % 4;
  float* slab = part == nullptr ? nullptr : part + (long long)blockIdx.y * M * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wm * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < T::N / 8; ++j) {
      const int c = n0 + wn * T::N + 8 * j + 2 * quad;
      if (c >= d) continue;  // d % 8 == 0: a pair is in or out as a whole
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (slab != nullptr) {
        *reinterpret_cast<float2*>(slab + (long long)m * d + c) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * d + c) =
            __floats2bfloat162_rn(v0 + b2[c], v1 + b2[c + 1]);
      }
    }
  }
}

// out = bf16(sum over the splits of the fp32 partials + b2), two columns a thread
__global__ void __launch_bounds__(256)
geglu_splitk_sum(const float* __restrict__ part, const float* __restrict__ b2,
                 bf16* __restrict__ out, long long md, int d, int splits) {
  const long long pairs = md / 2;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < pairs; i += (long long)gridDim.x * 256) {
    float2 s = make_float2(0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float2 v = reinterpret_cast<const float2*>(part + z * md)[i];
      s.x += v.x;
      s.y += v.y;
    }
    const int c = (int)((2 * i) % d);
    reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(s.x + b2[c], s.y + b2[c + 1]);
  }
}

template <int WM>
int launch_gate(const void* x, const void* w1, const void* b1, void* p, int M, int d, int I,
                cudaStream_t stream) {
  using T = GateTile<WM>;
  CUtensorMap xm, wm;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)M}, xstr[1] = {2ull * d};
  const uint64_t wdims[2] = {(uint64_t)d, 2ull * I}, wstr[1] = {2ull * d};
  const uint32_t xbox[2] = {64, (uint32_t)T::BM}, wbox[2] = {64, (uint32_t)(T::N / 2)};
  int code = hopper::make_map(&xm, x, 2, xdims, xstr, xbox);
  if (code == 0) code = hopper::make_map(&wm, w1, 2, wdims, wstr, wbox);
  if (code != 0) return code;
  cudaError_t err = hopper::set_smem_once<geglu_gate_wgmma<WM>>(T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_i = (I + GATE_COLS - 1) / GATE_COLS;
  const long long blocks = (long long)tiles_i * ((M + T::BM - 1) / T::BM);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  geglu_gate_wgmma<WM><<<(unsigned)blocks, WG_THREADS, T::SMEM, stream>>>(
      xm, wm, static_cast<const float*>(b1), static_cast<bf16*>(p), M, d, I, tiles_i);
  return (int)cudaGetLastError();
}

template <int WM>
int launch_down(const void* p, const void* w2, const void* b2, void* out, float* part, int M,
                int d, int I, int splits, cudaStream_t stream) {
  using T = DownTile<WM>;
  CUtensorMap pm, wm;
  const uint64_t pdims[2] = {(uint64_t)I, (uint64_t)M}, pstr[1] = {2ull * I};
  const uint64_t wdims[2] = {(uint64_t)I, (uint64_t)d}, wstr[1] = {2ull * I};
  const uint32_t pbox[2] = {64, (uint32_t)T::BM}, wbox[2] = {64, (uint32_t)T::N};
  int code = hopper::make_map(&pm, p, 2, pdims, pstr, pbox);
  if (code == 0) code = hopper::make_map(&wm, w2, 2, wdims, wstr, wbox);
  if (code != 0) return code;
  cudaError_t err = hopper::set_smem_once<geglu_down_wgmma<WM>>(T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (I + 63) / 64;
  const int per = (chunks + splits - 1) / splits;
  // the host's split leaves no split empty
  if (splits > 1 && (part == nullptr || (splits - 1) * per >= chunks))
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (d + DOWN_COLS - 1) / DOWN_COLS;
  const long long blocks = (long long)tiles_n * ((M + T::BM - 1) / T::BM);
  if (blocks >= (1ll << 31) || splits > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)splits);
  geglu_down_wgmma<WM><<<grid, WG_THREADS, T::SMEM, stream>>>(
      pm, wm, static_cast<const float*>(b2), static_cast<bf16*>(out),
      splits > 1 ? part : nullptr, M, d, I, tiles_n, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long md = (long long)M * d;
  const long long sum_blocks = std::min<long long>((md / 2 + 255) / 256, 4096);
  geglu_splitk_sum<<<(unsigned)sum_blocks, 256, 0, stream>>>(
      part, static_cast<const float*>(b2), static_cast<bf16*>(out), md, d, splits);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, void* p, void* part, int M, int d, int I, int gate_rows,
                 int down_rows, int splits, cudaStream_t s) {
  // TMA: 16-byte aligned bases and byte strides
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                        reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(part);
  if (d % 8 != 0 || I % 8 != 0 || any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (p == nullptr || splits < 1) return (int)cudaErrorInvalidValue;
  int code;
  if (gate_rows == 128) code = launch_gate<2>(x, w1, b1, p, M, d, I, s);
  else if (gate_rows == 64) code = launch_gate<1>(x, w1, b1, p, M, d, I, s);
  else return (int)cudaErrorInvalidValue;  // the host's tile is not a compiled one
  if (code != 0) return code;
  float* f = static_cast<float*>(part);
  if (down_rows == 128) return launch_down<2>(p, w2, b2, out, f, M, d, I, splits, s);
  if (down_rows == 64) return launch_down<1>(p, w2, b2, out, f, M, d, I, splits, s);
  return (int)cudaErrorInvalidValue;
}

template <int TM, int NF>
int launch_mma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int M, int d, int I, cudaStream_t stream) {
  constexpr int DN = 16 * NF * (8 / (TM / 16));
  const Layout L = layout(TM, d, DN);
  cudaError_t err = cudaFuncSetAttribute(geglu_bf16_mma<TM, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + TM - 1) / TM), (unsigned)((d + DN - 1) / DN));
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  geglu_bf16_mma<TM, NF><<<grid, THREADS, L.bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, d, I,
      d % 8 == 0 && aligned(x), d % 8 == 0 && aligned(w1), I % 8 == 0 && aligned(w2));
  return (int)cudaGetLastError();
}

template <int TM>
int launch_tm(int nf, const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, void* out, int M, int d, int I, cudaStream_t s) {
  switch (nf) {
    case 1: return launch_mma<TM, 1>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 2: return launch_mma<TM, 2>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 3: return launch_mma<TM, 3>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 4: return launch_mma<TM, 4>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 5: return launch_mma<TM, 5>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 6: return launch_mma<TM, 6>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 7: return launch_mma<TM, 7>(x, w1, b1, w2, b2, out, M, d, I, s);
    case 8: return launch_mma<TM, 8>(x, w1, b1, w2, b2, out, M, d, I, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_wmma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* out, int M, int d, int I, cudaStream_t s) {
  // TM = 64 rows while the x tile fits beside the rest, else 32; the output
  // columns split into the fewest slices of at most 8 fragments per warp
  const int tm = d <= 640 ? 64 : 32;
  const int unit = 16 * (8 / (tm / 16));      // columns per fragment across the warps
  const int slices = (d + 8 * unit - 1) / (8 * unit);
  const int nf = round_up((d + slices - 1) / slices, unit) / unit;
  if (tm == 64) return launch_tm<64>(nf, x, w1, b1, w2, b2, out, M, d, I, s);
  return launch_tm<32>(nf, x, w1, b1, w2, b2, out, M, d, I, s);
}

int launch_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int M, int d, int I, cudaStream_t stream) {
  const size_t bytes = ((size_t)GM * d + GM * GI) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(geglu_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + GM - 1) / GM), (unsigned)((d + GN - 1) / GN));
  geglu_f32<<<grid, GTHREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), M, d, I);
  return (int)cudaGetLastError();
}

}  // namespace

// route (ops/geglu.py::geglu_plan): 0 = "f32" (x, w1, w2, out float32),
// 1 = "wmma" and 2 = "wgmma" (bfloat16). b1 and b2 are float32. All
// contiguous, w1 and w2 in torch's Linear layout: x (M, d), w1 (2I, d) with
// [h | gate] row halves, b1 (2I,), w2 (d, I), b2 (d,), out (M, d). "wgmma"
// needs d % 8 == 0, I % 8 == 0 and 16-byte aligned tensors, and takes the
// host's scratch and tiles: p, a bf16 (M, I) buffer for the gated tile;
// gate_rows and down_rows, 128 or 64, the rows of a gate and of a down
// block; splits, the down kernel's split of the reduction over I, with part
// a float32 (splits, M, d) buffer when splits > 1 (else null). The other
// routes ignore p, part and the tiles. Returns the cudaError_t of the launch,
// or a TMA-encoding error code (>= 10000).
extern "C" int dpm_geglu_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* p, void* part, int M, int d,
                             int I, int route, int gate_rows, int down_rows, int splits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || d <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  if (route == 0) return launch_f32(x, w1, b1, w2, b2, out, M, d, I, s);
  if (route == 1) return launch_wmma(x, w1, b1, w2, b2, out, M, d, I, s);
  if (route == 2)
    return launch_wgmma(x, w1, b1, w2, b2, out, p, part, M, d, I, gate_rows, down_rows, splits,
                        s);
  return (int)cudaErrorInvalidValue;
}
