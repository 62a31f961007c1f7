// The register-tiled fp32 attention blocks shared by the forward
// (attention.cu, `attention_fwd_f32`) and the backward (attention_bwd.cu,
// `attn_bwd_f32`), exact on the CUDA cores, for sm_90a.
//
// A block of F32_THREADS threads owns F32_ROWS rows (queries, or keys in the
// dk/dv kernel) and streams the other side in tiles of TILE rows, two
// buffers deep, by cp.async. The logits of a tile (and the backward's dp)
// are register-tiled: each thread computes a 4 x 4 patch of (owned rows) x
// (streamed rows) over one of PARTS interleaved slices of the head dim (at
// most F32_SLICE columns a slice), so 8 shared-memory reads feed 16 FMAs of
// each product, and a butterfly over the PARTS lanes of a patch sums the
// slices. TILE = F32_THREADS / PARTS, so the patches of one tile take every
// thread once: the tile grows as the head dim shrinks (128 rows up to dh
// 80, 64 at 128 and 160, 32 at 256, 16 at 512). Pitches: owned rows D + 2
// (D + 4 at 16 slices), streamed rows D + 2, which keep a warp's reads on
// distinct banks (its patches share a column block, so the streamed reads
// broadcast and the owned ones spread). Past dh 640 (the forward's dh 960)
// the parts stay 16 and a lane sums more than F32_SLICE columns. ops/attention.py states the same
// rule (`F32_ROWS`, `F32_THREADS`, `F32_SLICE`, `_f32_parts`), and
// tests/test_torch_kernel_plans.py holds the constants equal. The forward's
// step over one streamed tile (`forward_tile`) is shared by the fp32
// attention forward and the fp32 fused attention with its out-projection
// (attention_out.cu).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace attn_f32 {

constexpr int F32_ROWS = 16;       // owned rows a block
constexpr int F32_THREADS = 256;
constexpr int F32_SLICE = 40;      // head-dim columns a patch lane sums, at most

// head-dim slices a patch is split into: enough that a lane sums at most
// F32_SLICE columns, at least 2 and at most 16 (at the forward's dh 960 a
// lane sums 60 columns: 16 parts keep a tile at 16 rows, the least that the
// softmax's 16 threads a row cover)
constexpr int f32_parts(int d) {
  int p = 2;
  while (p * F32_SLICE < d && p < 16) p *= 2;
  return p;
}

// the streamed tile of head dim D and how the block's threads cover it, at
// P head-dim slices a patch (the backward takes P = 32 at dh 960: a warp a
// patch, 8-row tiles)
template <int D, int P = f32_parts(D)>
struct Stream {
  static constexpr int PARTS = P;
  static constexpr int TILE = F32_THREADS / PARTS;       // streamed rows a tile
  static constexpr int PO = D + (PARTS == 16 ? 4 : 2);   // owned pitch (banks)
  static constexpr int PS = D + 2;                       // streamed pitch (banks, 8-byte rows)
  static constexpr int NC = (D + 63) / 64;               // output columns a thread: ct + 64 i
  static_assert(D % PARTS == 0 && D % 2 == 0 && TILE % 8 == 0, "parts");
};

// start copying rows [r0, r0 + TILE) of x and y (rows sx, sy elements
// apart; rows >= n read as 0) into buf: x's rows at buf, y's TILE * PS
// floats on; 8 bytes a copy when `vec` (every row 8-byte aligned)
template <int D, int P = f32_parts(D)>
__device__ __forceinline__ void load_rows(float* buf, const float* x, long long sx,
                                          const float* y, long long sy, int r0, int n, bool vec) {
  using L = Stream<D, P>;
  if (vec) {
    for (int e = threadIdx.x; e < L::TILE * D / 2; e += F32_THREADS) {
      const int j = e / (D / 2), c = 2 * (e % (D / 2));
      const bool ok = r0 + j < n;
      const long long o = ok ? (long long)(r0 + j) : 0;
      hopper::cp_async<8>(buf + j * L::PS + c, x + o * sx + c, ok);
      hopper::cp_async<8>(buf + (L::TILE + j) * L::PS + c, y + o * sy + c, ok);
    }
  } else {
    for (int e = threadIdx.x; e < L::TILE * D; e += F32_THREADS) {
      const int j = e / D, c = e % D;
      const bool ok = r0 + j < n;
      const long long o = ok ? (long long)(r0 + j) : 0;
      hopper::cp_async<4>(buf + j * L::PS + c, x + o * sx + c, ok);
      hopper::cp_async<4>(buf + (L::TILE + j) * L::PS + c, y + o * sy + c, ok);
    }
  }
}

// N products on one patch, each over this lane's head-dim slice d = part
// (mod PARTS): acc[N * (4 r + c) + p] += sum_d A_p[4 rb + r][d] * X_p[4 cb
// + c][d], where operand p of the owned rows starts p * own_next floats
// into `own` (pitch PO) and of the streamed rows p * xs_next into `xs`
// (pitch PS). The sums of one element run in increasing d.
template <int D, int N, int P = f32_parts(D)>
__device__ __forceinline__ void patch_products(float (&acc)[16 * N], const float* own,
                                               int own_next, const float* xs, int xs_next,
                                               int rb, int cb, int part) {
  using L = Stream<D, P>;
#pragma unroll 4
  for (int k = 0; k < D / L::PARTS; ++k) {
    const int d = part + L::PARTS * k;
    float a[N][4], x[N][4];
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[p][r] = own[p * own_next + (4 * rb + r) * L::PO + d];
        x[p][r] = xs[p * xs_next + (4 * cb + r) * L::PS + d];
      }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int p = 0; p < N; ++p)
          acc[N * (4 * r + c) + p] = fmaf(a[p][r], x[p][c], acc[N * (4 * r + c) + p]);
  }
}

// one butterfly round over the lanes `w` = P / 2 apart, then the next: each
// lane keeps the half of its N live sums its bit of `part` names (the upper
// half where it is set) and adds its partner's copy of that half; after
// log2(P) rounds lane `part` holds the full sums of values [part * A / P,
// + A / P) in acc[0 ..). All indices are constants, so acc stays in registers.
template <int P, int N, int A>
__device__ __forceinline__ void fold(float (&acc)[A], int part) {
  if constexpr (P > 1) {
    constexpr int w = P / 2, n = N / 2;
    const bool up = (part & w) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float lo = acc[i], hi = acc[i + n];
      acc[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, w);
    }
    fold<w, n, A>(acc, part);
  }
}

// The forward's step over one streamed key tile `xs` (its k rows, then its
// v rows TILE * PS floats on), in base 2, for the 16 owned queries `qs`
// (pitch PO), in three phases split by __syncthreads (every thread of the
// block calls it): (1) the logits, each thread a 4x4 patch (queries 4rb..,
// keys 4cb..) over its head-dim slice, folded across the slices, scaled by
// qscale and masked (keys >= S get -inf) into `ps` (pitch TILE + 1); (2) the
// online softmax, 16 threads a row: the row's max over the tile, p =
// exp2(z - m) (exp2f: exact to the fp32 ulp) back into `ps`, the running max
// and sum and this tile's rescale factor in row_m, row_l, row_a; (3) O = O *
// alpha + P.V into `acc`, each thread 4 rows (4rg..) x the output columns
// col0 + ct + 64 i below dv. key0 is the tile's first key.
template <int D>
__device__ __forceinline__ void forward_tile(float (&acc)[4][Stream<D>::NC], const float* qs,
                                             const float* xs, float* ps, float* row_m,
                                             float* row_l, float* row_a, int key0, int S,
                                             float qscale, int col0, int dv) {
  using L = Stream<D>;
  constexpr int TILE = L::TILE, PARTS = L::PARTS, NC = L::NC;
  constexpr int VALS = 16 / PARTS, PT = TILE + 1;  // logits a lane keeps; logits pitch
  static_assert(TILE % 16 == 0, "16 threads a row cover a tile");
  const int tid = threadIdx.x;
  const int part = tid % PARTS, patch = tid / PARTS, rb = patch % 4, cb = patch / 4;
  const int srow = tid / 16, slane = tid % 16;
  const int rg = tid / 64, ct = tid % 64;

  float z[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) z[i] = 0.f;
  patch_products<D, 1>(z, qs, 0, xs, 0, rb, cb, part);
  fold<PARTS, 16>(z, part);  // lane `part`: values [part * VALS, + VALS)
#pragma unroll
  for (int m = 0; m < VALS; ++m) {
    const int e = part * VALS + m, row = 4 * rb + e / 4, col = 4 * cb + e % 4;
    ps[row * PT + col] = key0 + col < S ? z[m] * qscale : -INFINITY;
  }
  __syncthreads();

  {  // (2) the row's max over the tile, p = exp2(z - m), the running stats
    float zv[TILE / 16], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < TILE / 16; ++u) {
      zv[u] = ps[srow * PT + slane + 16 * u];
      mx = fmaxf(mx, zv[u]);
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_old = row_m[srow];
    const float m_new = fmaxf(m_old, mx);  // finite: every tile has a valid key
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < TILE / 16; ++u) {
      const float p = exp2f(zv[u] - m_new);  // masked keys: exp2(-inf) = 0
      ps[srow * PT + slane + 16 * u] = p;
      sum += p;
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (slane == 0) {  // the row's 16 lanes read m_old before the shuffles above
      const float alpha = exp2f(m_old - m_new);  // first tile: exp2(-inf) = 0
      row_l[srow] = row_l[srow] * alpha + sum;
      row_m[srow] = m_new;
      row_a[srow] = alpha;
    }
  }
  __syncthreads();

  // (3) O = O * alpha + P.V
  float pr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float alpha = row_a[4 * rg + r];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
  }
  const float* vs = xs + TILE * L::PS + col0 + ct;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pr[r] = ps[(4 * rg + r) * PT + j];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (ct + 64 * i < dv) {
        const float x = vs[j * L::PS + 64 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i] = fmaf(pr[r], x, acc[r][i]);
      }
    }
  }
}

}  // namespace attn_f32
