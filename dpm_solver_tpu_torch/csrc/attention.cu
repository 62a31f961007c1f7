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
// compute-bound, and the only way to the card's tensor-core rate is `wgmma`
// fed by TMA (at short S, as on the CIFAR and classifier sites, the bytes
// bound it and what matters is reading q, k and v once). Two kernels, by
// dtype:
//
// - bf16 (the model's compute dtype): `attention_fwd_wgmma`, FlashAttention-3
//   style. A block is one producer warp and NWG consumer warpgroups, each of
//   which owns 64 query rows. The producer loads the block's q tile once and
//   then streams K and V tiles by TMA into a ring of STAGES shared-memory
//   stages, each guarded by a full and an empty mbarrier. A consumer computes
//   S = Q.K^T with `wgmma` m64nKVk16 from shared memory (q and k K-major),
//   runs the online softmax on the accumulator in registers (a row lies in
//   the 4 threads of a quad: two shuffles for its max; the sum stays per
//   thread until the end), rounds P to bf16 in registers (as the JAX XLA
//   path rounds it) and feeds it as the register A operand of O += P.V, with
//   V read MN-major through the descriptor's transpose bit. O stays in
//   registers all the way and is rescaled there. At D <= 64 (OVERLAP), tile
//   t's softmax runs while tile t-1's P.V product is in flight
//   (FlashAttention-3's intra-warpgroup overlap), so the tensor cores do not
//   wait for the exponentials. It holds a second set of P fragments, which
//   the 168 registers a thread of a 288-thread block can spare only at the
//   narrower heads (from D = 128 up ptxas spills them). q, k and v are
//   read through 4-D tensor maps over (d, head, token, batch) with the token
//   and batch strides given, so fused-qkv column slices load in place, and TMA's
//   out-of-bounds zero fill pads ragged T and S and the head dims that are
//   not a multiple of 64 (40, 80, 160: the map has the true extent along d,
//   the box 64 columns, so the pad columns arrive as zeros; the products run
//   only to the next multiple of 16 along d, and P.V only to D). Masked keys
//   (>= S) get -inf before the max. The tile per head dim (queries a block,
//   keys a tile, stages, output split) is chosen on the host
//   (ops/attention.py::attention_plan) and checked here against the compiled
//   instance. The VAE's single 512-wide head is split into two 256-wide
//   output halves (grid.z = 2), each of which recomputes the logits over all
//   512 channels, with one consumer warpgroup and 32-key tiles to stay
//   inside 227 KB of shared memory. The class-conditional LDM's (cin256)
//   single heads of 384, 576 and 960 run the same way in 192-column output
//   slices (grid.z = 2, 3, 5; 192 divides all three in whole 64-column
//   runs), with the widest key tile of 64, 32 or 16 whose two stages fit
//   beside the resident 64-row q tile, which alone takes 120 KB at 960
//   (wide_kv: 64, 32 and 16 keys). dh 96 and 192 (the ADM ImageNet-64 and
//   -128 presets' heads) take the tiles of 80 and 160.
// - fp32: `attention_fwd_f32`, exact on the CUDA cores (no TF32: bits/dim
//   rides its rounding), register-tiled like the fp32 backward, whose
//   blocks it shares (attention_f32.cuh). At path E's site (b8, T = S = 256,
//   one 256-wide head: 537 MFLOP a launch, 8 us at 67 TFLOP/s against about
//   2.5 us of bytes) it is bound by the FMAs, so the design feeds them from
//   registers. A block of 256 threads owns 16 queries (so that site runs 128
//   blocks on the 132 SMs) and streams K/V tiles of 256 / PARTS keys (32 at
//   dh 256), double-buffered by cp.async, so the next tile's copy overlaps
//   this tile's math. Per tile, three phases: (1) the logits, each thread a
//   4x4 patch over one of PARTS interleaved slices of dh (8 shared reads
//   feed 16 FMAs), summed by a butterfly over the patch's lanes, scaled
//   and masked (keys >= S get -inf) into shared memory; (2) the online
//   softmax in base 2, 16 threads a row (exp2f: exact to the fp32 ulp, not
//   ex2.approx); (3) O = O * alpha + P.V, each thread owning 4 rows x
//   ceil(dv/64) columns 64 apart (4 broadcast reads of p and one row read
//   of V a column feed 4 FMAs each). Where a launch has fewer than 128
//   row blocks (path E's 4x4 mid-block: T = 16, 8 blocks), the output
//   columns split over grid.z in 64-column multiples, each block
//   recomputing the small logits (32 blocks there). At dh 960 two K/V
//   buffers do not fit beside the queries: there one buffer, each tile's
//   copy started after the previous tile's math. The tile (16 queries,
//   the key tile, its buffers) and the column split are stated on the host
//   (ops/attention.py::attention_plan and AttentionTile.grid) and checked
//   here against the compiled instance.

#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn_wgmma;

// element strides of q, k and v; o is contiguous (B, T, H*D)
struct Strides {
  long long qb, qt, kb, kt, vb, vt;
};

// ---- fp32, exact, on the CUDA cores (attention_f32.cuh) ----------------------

using attn_f32::F32_ROWS;
using attn_f32::F32_THREADS;
constexpr int F32_STAGES = 2;  // K/V buffers a block where they fit: cp.async double buffering

// the shared streamed tile, and this kernel's shared-memory layout: F32_STAGES
// K/V buffers where they fit, else one (dh 960)
template <int D>
struct FwdF32 : attn_f32::Stream<D> {
  using S = attn_f32::Stream<D>;
  static constexpr int PT = S::TILE + 1;                     // logits / p pitch
  static constexpr int QS = F32_ROWS * S::PO;                // floats: the owned queries
  static constexpr int BUF = 2 * S::TILE * S::PS;            // a buffer: k and v rows
  static constexpr size_t smem(int stages) {
    return 4 * (size_t)(QS + stages * BUF + F32_ROWS * PT + 3 * F32_ROWS);
  }
  static constexpr int STAGES = smem(F32_STAGES) <= 232448 ? F32_STAGES : 1;
  static constexpr size_t SMEM = smem(STAGES);
  static_assert(S::PARTS * (F32_ROWS / 4) * (S::TILE / 4) == F32_THREADS, "patches");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int Tq, int S, int H, float qscale, Strides st,
                  int vec, int dv) {
  using L = FwdF32<D>;
  constexpr int TILE = L::TILE, NC = L::NC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [16][PO] queries
  float* bufs = qs + L::QS;                // [STAGES][BUF]: k rows, then v rows (pitch PS)
  float* ps = bufs + L::STAGES * L::BUF;   // [16][PT] the tile's logits, then p
  float* row_m = ps + F32_ROWS * L::PT;    // running max (base 2)
  float* row_l = row_m + F32_ROWS;         // running sum
  float* row_a = row_l + F32_ROWS;         // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * F32_ROWS, col0 = blockIdx.z * dv;
  const float* qb = q + b * st.qb + (long long)h * D;
  const float* kb = k + b * st.kb + (long long)h * D;
  const float* vb = v + b * st.vb + (long long)h * D;
  const int ntiles = (S + TILE - 1) / TILE;

  attn_f32::load_rows<D>(bufs, kb, st.kt, vb, st.vt, 0, S, vec != 0);
  hopper::cp_async_commit();
  for (int e = tid; e < F32_ROWS * D; e += F32_THREADS) {
    const int r = e / D, d = e % D, t = q0 + r;
    qs[r * L::PO + d] = t < Tq ? qb[t * st.qt + d] : 0.f;
  }
  if (tid < F32_ROWS) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // queries [4rg, 4rg + 4), output columns col0 + ct + 64 i (forward_tile's phase 3)
  const int rg = tid / 64, ct = tid % 64;
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (L::STAGES == 2 && t + 1 < ntiles) {
      attn_f32::load_rows<D>(bufs + ((t + 1) & 1) * L::BUF, kb, st.kt, vb, st.vt,
                             (t + 1) * TILE, S, vec != 0);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // tile t, the queries and the row stats visible
    attn_f32::forward_tile<D>(acc, qs, bufs + (L::STAGES == 2 ? (t & 1) : 0) * L::BUF, ps,
                              row_m, row_l, row_a, t * TILE, S, qscale, col0, dv);
    __syncthreads();  // the next copy reuses this buffer
    if (L::STAGES == 1 && t + 1 < ntiles) {  // one buffer: the next tile after this one
      attn_f32::load_rows<D>(bufs, kb, st.kt, vb, st.vt, (t + 1) * TILE, S, vec != 0);
      hopper::cp_async_commit();
    }
  }

  const long long otok = (long long)H * D;
  float* ob = o + (long long)b * Tq * otok + (long long)h * D + col0 + ct;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * rg + r, t = q0 + row;
    if (t >= Tq) continue;
    const float inv = 1.f / row_l[row];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (ct + 64 * i < dv) ob[t * otok + 64 * i] = acc[r][i] * inv;
    // base-2 log-sum-exp of the pre-scaled logits, from the final max and sum
    if (lse != nullptr && ct == 0 && blockIdx.z == 0)
      lse[(long long)bh * Tq + t] = row_m[row] + log2f(row_l[row]);
  }
}

// ---- bf16: TMA + wgmma -------------------------------------------------------

// D: the q/k head width; DV: the output columns one block owns (D, or 256
// for the 512-wide head); KV: keys per tile; NWG: consumer warpgroups (64
// queries each); STAGES: K/V ring depth
template <int D, int DV_, int KV_, int NWG, int STAGES>
struct AttnTile {
  static constexpr int KV = KV_, DV = DV_;
  static constexpr int BM = 64 * NWG;         // queries per block
  static constexpr int DCH = (D + 63) / 64;   // 64-column tiles of q and k
  static constexpr int DCHV = (DV_ + 63) / 64; // 64-column tiles of v
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr uint32_t Q_BYTES = DCH * BM * 128;
  static constexpr uint32_t K_BYTES = DCH * KV_ * 128;
  static constexpr uint32_t V_BYTES = DCHV * KV_ * 128;
  static constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;
  // + 1024 to align the base to a swizzle atom, + the barriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int THREADS = 128 * NWG + 32;
};

template <int D, int DV, int KV, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
attention_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int Tq, int S, int H, float qscale) {
  using L = AttnTile<D, DV, KV, NWG, STAGES>;
  static_assert(DV % 8 == 0 && DV <= 256 && KV % 16 == 0 && L::SMEM <= 232448, "tile");
  using namespace hopper;
  constexpr bool OVERLAP = D <= 64;  // the softmax / P.V overlap (header)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ring = smem + L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * L::BM;
  const int ntiles = (S + KV - 1) / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: one lane starts every load
    if (lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::DCH; ++c) tma_load_4d(qs + c * L::BM * 128, &qmap, qbar, 64 * c, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        uint8_t* ks = ring + s * L::STAGE_BYTES;
        uint8_t* vs = ks + L::K_BYTES;
        for (int c = 0; c < L::DCH; ++c)
          tma_load_4d(ks + c * KV * 128, &kmap, &full[s], 64 * c, h, t * KV, b);
        for (int c = 0; c < L::DCHV; ++c)
          tma_load_4d(vs + c * KV * 128, &vmap, &full[s], blockIdx.z * DV + 64 * c, h, t * KV, b);
      }
    }
    return;
  }
  // consumers: warpgroup wg owns queries [64 wg, 64 wg + 64) of the tile;
  // this thread holds rows r and r + 8 of its warp's 16, columns 2(lane%4)
  // (+1) of every 8
  const int wg = warp / 4;
  const int quad = lane % 4;
  float oacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float sacc[KV / 2];
  uint32_t pa[KV / 16][4];

  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  const uint32_t ring_addr = smem_u32(ring);
  auto k_addr = [&](int s) { return ring_addr + s * L::STAGE_BYTES; };
  auto v_addr = [&](int s) { return ring_addr + s * L::STAGE_BYTES + L::K_BYTES; };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i % 4) / 2];
  };
  mbar_wait(qbar, 0);

  if constexpr (!OVERLAP) {
    // per tile: S = Q.K^T, its softmax, rescale O, O += P.V, release
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      wgmma_fence();
      qk_product<L>(sacc, q_addr, k_addr(s));
      wgmma_wait<0>();
      fence_regs(sacc);
      online_softmax<KV>(sacc, pa, m, l, alpha, t * KV, S, qscale, quad);
      rescale();
      fence_frags<KV>(pa);
      fence_regs(oacc);
      wgmma_fence();
      pv_product<L>(oacc, pa, v_addr(s));
      wgmma_wait<0>();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else {
    // tile t's softmax runs while tile t-1's P.V product is in flight on
    // the tensor cores (FlashAttention-3's intra-warpgroup overlap): per
    // tile, start S_t = Q.K_t^T and O += P_{t-1}.V_{t-1}, wait for S_t
    // only, run its softmax into the next fragments, then wait for the
    // product, release stage t-1 and rescale O by tile t's alpha
    uint32_t pn[KV / 16][4];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    qk_product<L>(sacc, q_addr, k_addr(0));
    wgmma_wait<0>();
    fence_regs(sacc);
    online_softmax<KV>(sacc, pa, m, l, alpha, 0, S, qscale, quad);  // O is 0: no rescale
    for (int t = 1; t < ntiles; ++t) {
      const int s = t % STAGES, prev = (t - 1) % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      fence_frags<KV>(pa);
      fence_regs(oacc);
      wgmma_fence();
      qk_product<L>(sacc, q_addr, k_addr(s));
      pv_product<L>(oacc, pa, v_addr(prev));
      wgmma_wait<1>();  // S_t is done; the product may still run
      fence_regs(sacc);
      online_softmax<KV>(sacc, pn, m, l, alpha, t * KV, S, qscale, quad);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_frags<KV>(pa);  // pa is read by the product until here
      if (lane == 0) mbar_arrive(&empty[prev]);
      rescale();
#pragma unroll
      for (int j = 0; j < KV / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[j][r] = pn[j][r];
    }
    fence_frags<KV>(pa);
    fence_regs(oacc);
    wgmma_fence();
    pv_product<L>(oacc, pa, v_addr((ntiles - 1) % STAGES));
    wgmma_wait<0>();
    fence_regs(oacc);
  }

  const long long otok = (long long)H * D;
  __nv_bfloat16* ob = o + (long long)b * Tq * otok + (long long)h * D + blockIdx.z * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int t = q0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * r;
    if (t < Tq) {
      const float inv = 1.f / lsum;
      __nv_bfloat16* dst = ob + t * otok + 2 * quad;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
      // base-2 log-sum-exp of the pre-scaled logits (every output slice of
      // a 512-wide head has it; the first writes it)
      if (lse != nullptr && quad == 0 && blockIdx.z == 0) lse[(long long)bh * Tq + t] = m[r] + log2f(lsum);
    }
  }
}

// the host's tile (ops/attention.py::attention_plan and AttentionTile.grid)
struct Plan {
  int block_q, block_kv, d_pad, dv, stages;
};

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int Tq, int S, int H, float qscale, Strides st, Plan plan, cudaStream_t stream) {
  using L = FwdF32<D>;
  // the compiled tile; the output split in whole 64-column runs that divide D
  if (plan.block_q != F32_ROWS || plan.block_kv != L::TILE || plan.d_pad != D ||
      plan.stages != L::STAGES || plan.dv <= 0 || D % plan.dv != 0 ||
      (plan.dv != D && plan.dv % 64 != 0))
    return (int)cudaErrorInvalidValue;
  // 8-byte copies where every row of k and v starts 8-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const long long strides = st.kb | st.kt | st.vb | st.vt;
  const int vec = any % 8 == 0 && strides % 2 == 0;
  cudaError_t err = hopper::set_smem_once<attention_fwd_f32<D>>(L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + F32_ROWS - 1) / F32_ROWS), (unsigned)(B * H),
            (unsigned)(D / plan.dv));
  attention_fwd_f32<D><<<grid, F32_THREADS, L::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, S, H, qscale, st, vec,
      plan.dv);
  return (int)cudaGetLastError();
}

template <int D, int DV, int KV, int NWG, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int Tq, int S, int H, float qscale, Strides st, Plan plan,
                 cudaStream_t stream) {
  using L = AttnTile<D, DV, KV, NWG, STAGES>;
  if (plan.block_q != L::BM || plan.block_kv != KV || plan.d_pad != 64 * L::DCH ||
      plan.dv != DV || plan.stages != STAGES)
    return (int)cudaErrorInvalidValue;  // the host's plan is not the compiled one
  // TMA: 16-byte aligned bases and byte strides
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  if (any % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  // 4-D maps over (d, head, token, batch); the box is 64 columns of one head
  CUtensorMap qm, km, vm;
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Tq, (uint64_t)B};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t qstr[3] = {2ull * D, 2ull * st.qt, 2ull * st.qb};
  const uint64_t kstr[3] = {2ull * D, 2ull * st.kt, 2ull * st.kb};
  const uint64_t vstr[3] = {2ull * D, 2ull * st.vt, 2ull * st.vb};
  const uint32_t qbox[4] = {64, 1, (uint32_t)L::BM, 1};
  const uint32_t kbox[4] = {64, 1, (uint32_t)KV, 1};
  int code = hopper::make_map(&qm, q, 4, qdims, qstr, qbox);
  if (code == 0) code = hopper::make_map(&km, k, 4, kdims, kstr, kbox);
  if (code == 0) code = hopper::make_map(&vm, v, 4, kdims, vstr, kbox);
  if (code != 0) return code;
  cudaError_t err =
      hopper::set_smem_once<attention_fwd_wgmma<D, DV, KV, NWG, STAGES>>(L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + L::BM - 1) / L::BM), (unsigned)(B * H), (unsigned)(D / DV));
  attention_fwd_wgmma<D, DV, KV, NWG, STAGES><<<grid, L::THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, Tq, S, H, qscale);
  return (int)cudaGetLastError();
}

// the wide single heads past 256 but 512 (cin256's dh 384, 576 and 960): one
// warpgroup, 192-column output slices, and the widest key tile of 64, 32 or
// 16 whose two stages fit beside the 64-row q tile
constexpr int WIDE_DV = 192;
template <int D>
constexpr int wide_kv() {
  return AttnTile<D, WIDE_DV, 64, 1, 2>::SMEM <= 232448   ? 64
         : AttnTile<D, WIDE_DV, 32, 1, 2>::SMEM <= 232448 ? 32
                                                           : 16;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Tq,
           int S, int H, float qscale, Strides st, int dtype, Plan p, cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, B, Tq, S, H, qscale, st, p, s);
  if constexpr (D == 512) {
    return launch_wgmma<512, 256, 32, 1, 2>(q, k, v, o, lse, B, Tq, S, H, qscale, st, p, s);
  } else if constexpr (D > 256) {
    return launch_wgmma<D, WIDE_DV, wide_kv<D>(), 1, 2>(q, k, v, o, lse, B, Tq, S, H, qscale, st,
                                                      p, s);
  } else if constexpr (D >= 160) {
    return launch_wgmma<D, D, 64, 2, 2>(q, k, v, o, lse, B, Tq, S, H, qscale, st, p, s);
  } else if constexpr (D >= 80) {
    return launch_wgmma<D, D, 128, 2, 2>(q, k, v, o, lse, B, Tq, S, H, qscale, st, p, s);
  } else {
    return launch_wgmma<D, D, 128, 2, 3>(q, k, v, o, lse, B, Tq, S, H, qscale, st, p, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it; bf16 pointers
// 16-byte aligned, bf16 strides multiples of 8). qscale is scale * log2(e).
// q_bs, q_ts (and k_, v_) are the batch and token strides in elements; the
// channel stride is 1 and o is contiguous. lse is null, or a float32 (B*H, T)
// output for the base-2 log-sum-exp of each row's pre-scaled logits, which the
// backward (attention_bwd.cu) reads. block_q, block_kv, d_pad, dv and stages
// are the host's tile (ops/attention.py::attention_plan; for float32 dv is
// the launch's output column slice, AttentionTile.grid); a tile other than a
// compiled one is refused. Returns the
// cudaError_t of the launch, or a TMA-encoding error code (>= 10000).
extern "C" int dpm_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse_out, int B, int T, int S, int H, int D, float qscale,
                                 long long q_bs, long long q_ts, long long k_bs,
                                 long long k_ts, long long v_bs, long long v_ts,
                                 int dtype, int block_q, int block_kv, int d_pad, int dv,
                                 int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  const Plan p{block_q, block_kv, d_pad, dv, stages};
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 40: return launch<40>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 64: return launch<64>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 80: return launch<80>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 96: return launch<96>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 128: return launch<128>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 160: return launch<160>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 192: return launch<192>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 256: return launch<256>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 384: return launch<384>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 512: return launch<512>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 576: return launch<576>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    case 960: return launch<960>(q, k, v, o, lse, B, T, S, H, qscale, st, dtype, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
