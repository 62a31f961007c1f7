// The bf16 attention mainloop's building blocks, shared by the forward
// (attention.cu, `attention_fwd_wgmma`) and the fused attention with its
// out-projection (attention_out.cu, `attention_out_wgmma`), for sm_90a: the
// online base-2 softmax of one key tile on the `wgmma` accumulator in
// registers, P rounded to bf16 as register A fragments, and the two
// products S = Q.K^T (q and k K-major in shared memory) and O += P.V (V
// MN-major through the descriptor's transpose bit). A tile type L names
// KV (keys a tile), DV (output columns), BM (queries a block) and KSTEPS
// (the 16-deep steps over the head dim).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace attn_wgmma {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the softmax of one key tile, in base 2, on its logits S (the wgmma
// accumulator): scale, mask keys >= S, the row max over the quad, the new
// running max m and sum l, the factor alpha the running output must take,
// and P rounded to bf16 as register A fragments (k-step j takes accumulator
// columns [16j, 16j + 16), i.e. sacc[8j .. 8j + 8) in pairs)
template <int KV>
__device__ __forceinline__ void online_softmax(float (&sacc)[KV / 2], uint32_t (&pa)[KV / 16][4],
                                               float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               int key0, int S, float qscale, int quad) {
  float mx[2] = {-INFINITY, -INFINITY};
  const bool ragged = key0 + KV > S;
#pragma unroll
  for (int i = 0; i < KV / 2; ++i) {
    const int key = key0 + 8 * (i / 4) + 2 * quad + (i % 2);
    const float sv = (ragged && key >= S) ? -INFINITY : sacc[i] * qscale;
    sacc[i] = sv;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sv);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: a tile has a valid key
    alpha[r] = ex2(m[r] - m_new);                      // first tile: exp2(-inf) = 0
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < KV / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = ex2(sacc[8 * j + 2 * r] - m[r % 2]);  // masked keys: exp2(-inf) = 0
      const float p1 = ex2(sacc[8 * j + 2 * r + 1] - m[r % 2]);
      l[r % 2] += p0 + p1;
      pa[j][r] = hopper::pack_bf16(p0, p1);
    }
}

template <int KV>
__device__ __forceinline__ void fence_frags(uint32_t (&pa)[KV / 16][4]) {
#pragma unroll
  for (int j = 0; j < KV / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[j][r])::"memory");
}

// S = Q . K^T of one tile: 64 x KV per warpgroup, reduced over D in steps
// of 16 (the first step overwrites the accumulator); one commit group
template <typename L>
__device__ __forceinline__ void qk_product(float (&sacc)[L::KV / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < L::KSTEPS; ++ks) {
    const int c = ks / 4, kk = ks % 4;
    hopper::Wgmma<L::KV>::template ss<0>(
        sacc, hopper::desc(q_addr + c * L::BM * 128 + kk * 32, 16, 1024),
        hopper::desc(k_addr + c * L::KV * 128 + kk * 32, 16, 1024), ks > 0);
  }
  hopper::wgmma_commit();
}

// O += P . V of one tile: V is [key][d], MN-major, its 64-column tiles
// KV*128 bytes apart; one commit group
template <typename L>
__device__ __forceinline__ void pv_product(float (&oacc)[L::DV / 2],
                                         const uint32_t (&pa)[L::KV / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int j = 0; j < L::KV / 16; ++j)
    hopper::Wgmma<L::DV>::template rs<1>(oacc, pa[j],
                                         hopper::desc(v_addr + j * 2048, L::KV * 128, 1024), 1);
  hopper::wgmma_commit();
}

}  // namespace attn_wgmma
