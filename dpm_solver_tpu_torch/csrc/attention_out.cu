// Attention with its out-projection and residual fused, for sm_90a:
//   out = concat_h(softmax(q_h k_h^T * scale) v_h) @ w_out (+ bias) + residual.
//
// Replaces the Pallas kernel `_attn_out_forward` (`_attn_out_kernel`) of
// dpm_solver_tpu/ops/attention.py, behind `attention_out_fused`. As there, the
// (B*T, H*dh) attention output never reaches device memory: the Pallas kernel
// keeps it in VMEM, this one in shared memory. Every head dim of the
// attention forward (32, 40, 64, 80, 128, 160, 256, 512) with H*dh up to
// MAX_INNER = 1280 (SD-2.1's and SD-1's deepest transformer) and any C % 8 == 0
// up to 1280.
//
// Layout: q (B, T, H*dh), k and v (B, S, H*dh), each with unit stride along
// the channels and any batch and token strides (fused-qkv column slices are
// read in place); w_out (H*dh, C) row-major; bias (C,) fp32 or null;
// residual and out (B, T, C) contiguous, in the dtype of q.
//
// What bounds it on the H100: the attention is 4*T*S*dh flops a head against
// 2*(T+S)*dh*2 bytes of q/k/v in bf16, the out-projection 2*T*H*dh*C flops
// against the (H*dh, C) weight and 2*T*C*2 bytes of residual and out: at the
// SD sites far above the bf16 ridge, so it is compute-bound, and both
// products belong on `wgmma` fed by TMA. Two kernels, by dtype:
//
// - bf16: `attention_out_wgmma`, the mainloop of attention.cu's
//   `attention_fwd_wgmma` (attention_wgmma.cuh) with the projection as its
//   epilogue. A block is one producer warp and NWG consumer warpgroups of 64
//   query rows each; it keeps one query tile of one batch element and walks
//   the heads. The producer streams (head, key tile) pairs through one TMA
//   ring of STAGES stages (K and V through 4-D (d, head, token, batch) maps,
//   TMA's zero fill padding head dims that are not a multiple of 64 and
//   ragged S), so the next head's first K/V tiles are in flight while the
//   current head finishes; the head's q tile is reloaded once the consumers
//   have released the last one (qfull / qempty barriers). A consumer runs
//   S = Q.K^T by `wgmma`, the online base-2 softmax on the accumulator in
//   registers, P rounded to bf16 as the register A operand of O += P.V (at
//   dh <= 64 with the next tile's softmax overlapping the product, as
//   there). Per head it normalises O in registers, rounds it to bf16 (as the
//   unfused path rounds token_attention's output) and stores it into a
//   concat buffer in shared memory: BM rows x H*dh columns, laid out by the
//   global column h*dh + d in 64-column tiles with the 128-byte swizzle a
//   `wgmma` K-major A descriptor reads. It is laid out by global column and
//   never by head, because at dh 40, 80 and 160 a head's columns straddle
//   the 64-column tiles and the projection's 16-deep steps cross heads; the
//   columns from H*dh to the tile's end are zeroed, so the steps may run to
//   the next multiple of 16. The 512-wide head runs in two 256-wide output
//   halves, each recomputing the logits over all 512 channels (as
//   attention.cu does for the VAE). After the last head every consumer
//   computes out = concat . w_out by `wgmma` (w_out MN-major through the
//   transpose bit) in OUT_NCH-column passes with fp32 accumulators in
//   registers (the softmax's O registers are dead by then), the w_out tiles
//   (KW rows x OUT_NCH columns, sized to a K/V stage) arriving through the
//   same ring, which the K/V tiles have left; then adds bias and residual in
//   fp32 and stores bf16 once. Shared memory: the q tile, the ring, the
//   concat buffer (BM x H*dh x 2 bytes: 160 KB at 64 rows and H*dh = 1280),
//   the barriers. Where the grid of query tiles is small, a thread-block
//   cluster of 2-8 CTAs splits the heads: each CTA attends to its share,
//   then copies the others' columns of the concat buffer through
//   distributed shared memory and computes every cluster-th output pass.
//   The tile and cluster size are chosen on the host
//   (ops/attention.py::attention_out_plan: a compiled tile that fits 227 KB
//   at this H*dh, with the cluster its launch model rates fastest) and
//   checked here against the compiled instances.
// - fp32: `attention_out_f32`, exact on the CUDA cores, built from the
//   register-tiled blocks the fp32 attention forward and backward share
//   (attention_f32.cuh): 256 threads own 16 queries and walk the heads,
//   streaming K/V tiles of 256 / PARTS keys by cp.async (two buffers where
//   they fit beside the concat buffer at the head dim's widest H*dh, else
//   one), each head's normalised output into a (16 x H*dh) fp32 concat
//   buffer in shared memory; then each thread owns output columns and reads
//   w_out once a block, coalesced, summing over the inner width in order.

#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "attention_wgmma.cuh"
#include "hopper.cuh"

namespace {

using namespace attn_wgmma;
using bf16 = __nv_bfloat16;

struct Strides {
  long long qb, qt, kb, kt, vb, vt;
};

constexpr int MAX_INNER = 1280;     // H * dh: the widest concat buffer
constexpr int MAX_C = 1280;         // output channels
constexpr int OUT_NCH = 128;        // bf16: output columns a projection pass
constexpr int OUT_SMEM_LIMIT = 232448;  // 227 KB of shared memory a block
constexpr int MAX_CLUSTER = 8;      // bf16: CTAs a cluster (the portable limit)

// ---- bf16: TMA + wgmma -------------------------------------------------------

// D: head dim; KV: keys a tile; NWG: consumer warpgroups (64 queries each);
// STAGES: ring depth. A stage holds one K and one V tile, or one KW x
// OUT_NCH tile of w_out.
template <int D, int KV_, int NWG, int STAGES_>
struct OutTile {
  static constexpr int KV = KV_, STAGES = STAGES_;
  static constexpr int DV = D > 256 ? 256 : D;  // output columns a pass over the keys
  static constexpr int HALVES = D / DV;
  static constexpr int BM = 64 * NWG;
  static constexpr int DCH = (D + 63) / 64;
  static constexpr int DCHV = (DV + 63) / 64;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr uint32_t Q_BYTES = DCH * BM * 128;
  static constexpr uint32_t K_BYTES = DCH * KV * 128;
  static constexpr uint32_t V_BYTES = DCHV * KV * 128;
  static constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int KW = STAGE_BYTES / (OUT_NCH * 2) / 16 * 16;  // w_out rows a stage
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int BARRIERS = 2 + 2 * STAGES;  // qfull, qempty, full[], empty[]
  static_assert(DV % 8 == 0 && KV % 16 == 0 && KW >= 16 && KW <= 256, "tile");
  // + 1024 to align the base to a swizzle atom, the q tile, the ring, the
  // concat buffer (whole 64-column tiles of BM rows), the barriers
  static constexpr size_t smem(int inner) {
    return 1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES + (size_t)BM * 128 * ((inner + 63) / 64) +
           8 * BARRIERS;
  }
};

// O (DV/2 accumulators a thread: rows r and r + 8 of its warp's 16,
// columns 8j + 2(lane%4) (+1)) normalised by the row sums and rounded to
// bf16 into the concat buffer at global columns col0 + [0, DV): tile
// col / 64, 16-byte chunk (col % 64) / 8 swizzled by the row
template <int DV>
__device__ __forceinline__ void store_concat(uint8_t* cat_rows, int tile_bytes, int col0,
                                             const float (&oacc)[DV / 2], const float (&l)[2],
                                             int row0, int quad) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);
    const int row = row0 + 8 * r;
    uint8_t* dst = cat_rows + row * 128;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = col0 + 8 * j + 2 * quad, within = col % 64;
      *reinterpret_cast<uint32_t*>(dst + (col / 64) * tile_bytes +
                                   (((within / 8) ^ (row % 8)) * 16) + (within % 8) * 2) =
          hopper::pack_bf16(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D, int KV, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
attention_out_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    const bf16* __restrict__ res, bf16* __restrict__ out, int Tq, int S, int H,
                    int C, float qscale, int cl) {
  using L = OutTile<D, KV, NWG, STAGES>;
  using namespace hopper;
  constexpr int DV = L::DV;
  constexpr bool OVERLAP = D <= 64;  // the softmax / P.V overlap (attention.cu)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int inner = H * D, cat_tiles = (inner + 63) / 64;
  constexpr int TILE_BYTES = L::BM * 128;  // one 64-column tile of q or of the concat buffer
  uint8_t* qs = smem;
  uint8_t* ring = smem + L::Q_BYTES;
  uint8_t* cat = ring + STAGES * L::STAGE_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(cat + (size_t)cat_tiles * TILE_BYTES);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qfull + 2;
  uint64_t* empty = full + STAGES;

  // a cluster of `cl` CTAs shares one query tile: CTA `rank` attends to heads
  // [h0, h0 + hc) and computes the output passes n = rank (mod cl)
  const int rank = cl > 1 ? (int)cluster_rank() : 0, hc = H / cl, h0 = rank * hc;
  const int b = blockIdx.y, q0 = blockIdx.x / cl * L::BM;
  const int ntiles = (S + KV - 1) / KV;
  const int nchunks = (C + OUT_NCH - 1) / OUT_NCH;
  const int wsteps = (inner + 15) / 16;  // the projection's 16-deep steps
  const int wtiles = (inner + L::KW - 1) / L::KW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * NWG);  // lane 0 of every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: one lane starts every load
    if (lane == 0) {
      int it = 0;  // the ring's running tile count, as the consumers keep it
      auto acquire = [&](uint32_t bytes) {  // the next stage, expecting `bytes`
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        ++it;
        return s;
      };
      const int per_head = L::HALVES * ntiles;
      for (int hh = 0; hh < hc; ++hh) {
        const int h = h0 + hh;
        // the head's q tile once the consumers are done with the last one:
        // after the first stages of this head's K/V are under way
        const int q_at = hh == 0 ? 0 : (per_head < STAGES ? per_head : STAGES);
        for (int i = 0; i <= per_head; ++i) {
          if (i == q_at) {
            if (hh > 0) mbar_wait(qempty, (hh - 1) & 1);
            mbar_expect_tx(qfull, L::Q_BYTES);
            for (int c = 0; c < L::DCH; ++c)
              tma_load_4d(qs + c * TILE_BYTES, &qmap, qfull, 64 * c, h, q0, b);
          }
          if (i == per_head) break;
          const int half = i / ntiles, t = i % ntiles;
          const int s = acquire(L::STAGE_BYTES);
          uint8_t* ks = ring + s * L::STAGE_BYTES;
          uint8_t* vs = ks + L::K_BYTES;
          for (int c = 0; c < L::DCH; ++c)
            tma_load_4d(ks + c * KV * 128, &kmap, &full[s], 64 * c, h, t * KV, b);
          for (int c = 0; c < L::DCHV; ++c)
            tma_load_4d(vs + c * KV * 128, &vmap, &full[s], half * DV + 64 * c, h, t * KV, b);
        }
      }
      // the producer reads no peer's shared memory: it arrives at the
      // cluster's gather barrier here, before the w_out loads that wait on
      // the consumers' projection
      if (cl > 1) cluster_arrive_relaxed();
      for (int n = rank; n < nchunks; n += cl) {
        // the pass's 64-column runs that start inside C (a run past C would
        // feed only output columns that are never stored)
        const int runs = min(OUT_NCH / 64, (C - n * OUT_NCH + 63) / 64);
        for (int kt = 0; kt < wtiles; ++kt) {
          const int s = acquire(runs * L::KW * 128);
          uint8_t* ws = ring + s * L::STAGE_BYTES;
          for (int c = 0; c < runs; ++c)
            tma_load_2d(ws + c * L::KW * 128, &wmap, &full[s], n * OUT_NCH + 64 * c, kt * L::KW);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block's
  // query tile; this thread rows r0 and r0 + 8 (r0 = 16 (warp%4) + lane/4),
  // columns 2(lane%4) (+1) of every 8
  const int wg = warp / 4, quad = lane % 4;
  const int row0 = (warp % 4) * 16 + lane / 4;
  uint8_t* cat_rows = cat + wg * 64 * 128;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t cat_addr = smem_u32(cat_rows);
  auto k_addr = [&](int s) { return ring_addr + s * L::STAGE_BYTES; };
  auto v_addr = [&](int s) { return ring_addr + s * L::STAGE_BYTES + L::K_BYTES; };

  // the columns from H*dh to the last tile's end: zero (the projection's
  // last 16-deep step may read past H*dh, against w_out rows TMA fills with 0)
  if (inner % 64 != 0) {
    for (int e = threadIdx.x % 128; e < 64 * 8; e += 128) {
      const int row = e / 8, chunk = e % 8;
      if (chunk >= (inner % 64) / 8)
        *reinterpret_cast<uint4*>(cat_rows + (cat_tiles - 1) * TILE_BYTES + row * 128 +
                                  ((chunk ^ (row % 8)) * 16)) = make_uint4(0, 0, 0, 0);
    }
  }

  int it = 0;
  for (int hh = 0; hh < hc; ++hh) {
    const int h = h0 + hh;
    mbar_wait(qfull, hh & 1);
    for (int half = 0; half < L::HALVES; ++half) {
      float oacc[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float sacc[KV / 2];
      uint32_t pa[KV / 16][4];
      auto rescale = [&]() {
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i % 4) / 2];
      };
      const int it0 = it;
      it += ntiles;
      auto stage = [&](int t) { return (it0 + t) % STAGES; };
      auto phase = [&](int t) { return (uint32_t)(((it0 + t) / STAGES) & 1); };
      // the q tile is free once the head's last pass has computed its last
      // logits: the producer loads the next head's while this one finishes
      auto release_q = [&](int t) {
        if (half == L::HALVES - 1 && t == ntiles - 1 && lane == 0) mbar_arrive(qempty);
      };

      if constexpr (!OVERLAP) {
        for (int t = 0; t < ntiles; ++t) {
          const int s = stage(t);
          mbar_wait(&full[s], phase(t));
          wgmma_fence();
          qk_product<L>(sacc, q_addr, k_addr(s));
          wgmma_wait<0>();
          fence_regs(sacc);
          release_q(t);
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
        // tile t's softmax while tile t-1's P.V product runs (attention.cu)
        uint32_t pn[KV / 16][4];
        mbar_wait(&full[stage(0)], phase(0));
        wgmma_fence();
        qk_product<L>(sacc, q_addr, k_addr(stage(0)));
        wgmma_wait<0>();
        fence_regs(sacc);
        online_softmax<KV>(sacc, pa, m, l, alpha, 0, S, qscale, quad);  // O is 0: no rescale
        for (int t = 1; t < ntiles; ++t) {
          const int s = stage(t), prev = stage(t - 1);
          mbar_wait(&full[s], phase(t));
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
        release_q(ntiles - 1);  // every logit of the pass is computed
        fence_frags<KV>(pa);
        fence_regs(oacc);
        wgmma_fence();
        pv_product<L>(oacc, pa, v_addr(stage(ntiles - 1)));
        wgmma_wait<0>();
        fence_regs(oacc);
        if (lane == 0) mbar_arrive(&empty[stage(ntiles - 1)]);
      }
      store_concat<DV>(cat_rows, TILE_BYTES, h * D + half * DV, oacc, l, row0, quad);
    }
  }

  if (cl > 1) {
    // every CTA's heads in its concat buffer; copy the peers' columns into
    // this one (the same swizzled offsets: the layout is the same in each)
    cluster_arrive_release();
    cluster_wait();
    // (GATHER copies in flight a thread: each remote load waits out the
    // cluster's latency, so they are issued before their stores)
    const int span = hc * D / 8;  // 16-byte chunks a CTA's heads fill in a row
    const int copies = (cl - 1) * 64 * span;  // this warpgroup's rows
    constexpr int GATHER = 4;
    for (int e0 = threadIdx.x % 128; e0 < copies; e0 += 128 * GATHER) {
      uint4 val[GATHER];
      uint32_t off[GATHER];
#pragma unroll
      for (int g = 0; g < GATHER; ++g) {
        const int e = e0 + 128 * g, p = e / (64 * span), r = e % (64 * span);
        const int peer = (rank + 1 + p) % cl, row = r / span, chunk = peer * span + r % span;
        off[g] = (chunk / 8) * TILE_BYTES + row * 128 + (((chunk % 8) ^ (row % 8)) * 16);
        if (e < copies) val[g] = ld_peer_16(cat_addr + off[g], peer);
      }
#pragma unroll
      for (int g = 0; g < GATHER; ++g)
        if (e0 + 128 * g < copies) *reinterpret_cast<uint4*>(cat_rows + off[g]) = val[g];
    }
    // done reading the peers: they may exit once every CTA has arrived
    cluster_arrive_relaxed();
  }
  // the concat buffer (this warpgroup's rows) complete and visible to wgmma
  fence_proxy_async();
  named_sync(1 + wg, 128);

  for (int n = rank; n < nchunks; n += cl) {
    // the pass's residual, loaded before its products so that the loads'
    // latency hides behind them (one independent load each: rows past T and
    // columns past C read nothing)
    uint32_t rpre[2][OUT_NCH / 8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + wg * 64 + row0 + 8 * r;
      const bf16* rrow = res + ((long long)b * Tq + t) * C + n * OUT_NCH + 2 * quad;
#pragma unroll
      for (int j = 0; j < OUT_NCH / 8; ++j)
        rpre[r][j] = t < Tq && n * OUT_NCH + 8 * j + 2 * quad < C
                         ? *reinterpret_cast<const uint32_t*>(rrow + 8 * j) : 0u;
    }
    float acc[OUT_NCH / 2];
#pragma unroll
    for (int i = 0; i < OUT_NCH / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < wtiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int k0 = kt * (L::KW / 16);
      const int kn = min(L::KW / 16, wsteps - k0);
      fence_regs(acc);
      wgmma_fence();
      for (int kk = 0; kk < kn; ++kk) {
        const int ks = k0 + kk;
        hopper::Wgmma<OUT_NCH>::template ss<1>(
            acc, desc(cat_addr + (ks / 4) * TILE_BYTES + (ks % 4) * 32, 16, 1024),
            desc(ring_addr + s * L::STAGE_BYTES + kk * 2048, L::KW * 128, 1024), (kt | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // + bias + residual in fp32, one rounding to bf16
#pragma unroll
    for (int j = 0; j < OUT_NCH / 8; ++j) {
      const int col = n * OUT_NCH + 8 * j + 2 * quad;
      if (col >= C) continue;
      const float2 bv = bias != nullptr ? *reinterpret_cast<const float2*>(bias + col)
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = q0 + wg * 64 + row0 + 8 * r;
        if (t >= Tq) continue;
        __nv_bfloat162 rb;
        *reinterpret_cast<uint32_t*>(&rb) = rpre[r][j];
        const float2 rv = __bfloat1622float2(rb);
        *reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * Tq + t) * C + col) =
            __floats2bfloat162_rn((acc[4 * j + 2 * r] + bv.x) + rv.x,
                                  (acc[4 * j + 2 * r + 1] + bv.y) + rv.y);
      }
    }
  }
  // no CTA leaves while a peer may still read its concat buffer
  if (cl > 1) cluster_wait();
}

// ---- fp32 on the CUDA cores (attention_f32.cuh) --------------------------------

using attn_f32::F32_ROWS;
using attn_f32::F32_THREADS;

// NBUF: K/V buffers a block (2: cp.async double buffering)
template <int D, int NBUF>
struct OutF32 : attn_f32::Stream<D> {
  using S = attn_f32::Stream<D>;
  static constexpr int PT = S::TILE + 1;                     // logits / p pitch
  static constexpr int QS = F32_ROWS * S::PO;                // floats: the owned queries
  static constexpr int BUF = 2 * S::TILE * S::PS;            // a buffer: k and v rows
  static constexpr int WIDEST = MAX_INNER / D * D;           // the widest H*dh at this dh
  // the concat buffer (16 x H*dh), the queries, the buffers, the logits, three row stats
  static constexpr size_t smem(int inner) {
    return 4 * ((size_t)F32_ROWS * inner + QS + NBUF * BUF + F32_ROWS * PT + 3 * F32_ROWS);
  }
  static_assert(S::PARTS * (F32_ROWS / 4) * (S::TILE / 4) == F32_THREADS, "patches");
};

// two buffers where they fit beside the widest concat buffer, else one
template <int D>
constexpr int out_f32_bufs() {
  return OutF32<D, 2>::smem(OutF32<D, 2>::WIDEST) <= OUT_SMEM_LIMIT ? 2 : 1;
}

template <int D, int NBUF>
__global__ void __launch_bounds__(F32_THREADS, 1)
attention_out_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ res,
                  float* __restrict__ out, int Tq, int S, int H, int C, float qscale, Strides st,
                  int vec) {
  using L = OutF32<D, NBUF>;
  constexpr int TILE = L::TILE, NC = L::NC;
  extern __shared__ __align__(16) float smem[];
  const int inner = H * D;
  float* cat = smem;                       // [16][inner]: every head's output
  float* qs = cat + F32_ROWS * inner;      // [16][PO] queries
  float* bufs = qs + L::QS;                // [NBUF][BUF]: k rows, then v rows (pitch PS)
  float* ps = bufs + NBUF * L::BUF;        // [16][PT] the tile's logits, then p
  float* row_m = ps + F32_ROWS * L::PT;    // running max (base 2)
  float* row_l = row_m + F32_ROWS;         // running sum
  float* row_a = row_l + F32_ROWS;         // this tile's rescale factor

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * F32_ROWS;
  const int ntiles = (S + TILE - 1) / TILE;
  // queries [4rg, 4rg + 4), output columns ct + 64 i (forward_tile's phase 3)
  const int rg = tid / 64, ct = tid % 64;

  for (int h = 0; h < H; ++h) {
    const float* qb = q + b * st.qb + (long long)h * D;
    const float* kb = k + b * st.kb + (long long)h * D;
    const float* vb = v + b * st.vb + (long long)h * D;
    __syncthreads();  // the previous head's queries, logits and stats are consumed
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
    float acc[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
      if (NBUF == 2 && t + 1 < ntiles) {
        attn_f32::load_rows<D>(bufs + ((t + 1) % NBUF) * L::BUF, kb, st.kt, vb, st.vt,
                               (t + 1) * TILE, S, vec != 0);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();  // tile t, the queries and the row stats visible
      const float* xs = bufs + (t % NBUF) * L::BUF;

      attn_f32::forward_tile<D>(acc, qs, xs, ps, row_m, row_l, row_a, t * TILE, S, qscale, 0,
                                D);
      __syncthreads();  // the buffer and the logits are consumed
      if (NBUF == 1 && t + 1 < ntiles) {
        attn_f32::load_rows<D>(bufs, kb, st.kt, vb, st.vt, (t + 1) * TILE, S, vec != 0);
        hopper::cp_async_commit();
      }
    }
    // the head's normalised output into its concat columns (query rows past
    // T hold the uniform softmax of zero queries: finite, never stored)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * rg + r;
      const float inv = 1.f / row_l[row];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (ct + 64 * i < D) cat[row * inner + h * D + ct + 64 * i] = acc[r][i] * inv;
    }
  }
  __syncthreads();  // the concat buffer is complete

  // out-projection: each thread owns columns c, reading w_out once, coalesced
  for (int c = tid; c < C; c += F32_THREADS) {
    float o[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) o[r] = 0.f;
    for (int kk = 0; kk < inner; ++kk) {
      const float wv = w[(long long)kk * C + c];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) o[r] = fmaf(cat[r * inner + kk], wv, o[r]);
    }
    const float bv = bias != nullptr ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      if (q0 + r < Tq) {
        const long long idx = ((long long)b * Tq + q0 + r) * C + c;
        out[idx] = (o[r] + bv) + res[idx];
      }
    }
  }
}

// the host's tile (ops/attention.py::attention_out_plan)
struct Plan {
  int rows, block_kv, stages, cluster, n_chunk, w_rows;
};

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* w, const float* bias,
               const void* res, void* out, int B, int Tq, int S, int H, int C, float qscale,
               Strides st, Plan p, cudaStream_t stream) {
  constexpr int NBUF = out_f32_bufs<D>();
  using L = OutF32<D, NBUF>;
  const size_t smem = L::smem(H * D);
  if (p.rows != F32_ROWS || p.block_kv != L::TILE || p.stages != NBUF || p.cluster != 1 ||
      p.n_chunk != F32_THREADS || p.w_rows != 0 || smem > OUT_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;  // the host's plan is not the compiled one
  const uintptr_t any = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const long long strides = st.kb | st.kt | st.vb | st.vt;
  const int vec = any % 8 == 0 && strides % 2 == 0;
  cudaError_t err = hopper::set_smem_once<attention_out_f32<D, NBUF>>(OUT_SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Tq + F32_ROWS - 1) / F32_ROWS), (unsigned)B);
  attention_out_f32<D, NBUF><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), bias, static_cast<const float*>(res),
      static_cast<float*>(out), Tq, S, H, C, qscale, st, vec);
  return (int)cudaGetLastError();
}

template <int D, int KV, int NWG, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, const void* w, const float* bias,
                 const void* res, void* out, int B, int Tq, int S, int H, int C, float qscale,
                 Strides st, int cl, cudaStream_t stream) {
  using L = OutTile<D, KV, NWG, STAGES>;
  const int inner = H * D;
  const size_t smem = L::smem(inner);
  if (smem > OUT_SMEM_LIMIT || cl < 1 || cl > MAX_CLUSTER || H % cl != 0)
    return (int)cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and byte strides
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  if (any % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  // 4-D maps over (d, head, token, batch), the box 64 columns of one head;
  // w_out 2-D over (C, H*dh), the box 64 columns x KW rows
  CUtensorMap qm, km, vm, wm;
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Tq, (uint64_t)B};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t qstr[3] = {2ull * D, 2ull * st.qt, 2ull * st.qb};
  const uint64_t kstr[3] = {2ull * D, 2ull * st.kt, 2ull * st.kb};
  const uint64_t vstr[3] = {2ull * D, 2ull * st.vt, 2ull * st.vb};
  const uint32_t qbox[4] = {64, 1, (uint32_t)L::BM, 1};
  const uint32_t kbox[4] = {64, 1, (uint32_t)KV, 1};
  const uint64_t wdims[2] = {(uint64_t)C, (uint64_t)inner};
  const uint64_t wstr[1] = {2ull * C};
  const uint32_t wbox[2] = {64, (uint32_t)L::KW};
  int code = hopper::make_map(&qm, q, 4, qdims, qstr, qbox);
  if (code == 0) code = hopper::make_map(&km, k, 4, kdims, kstr, kbox);
  if (code == 0) code = hopper::make_map(&vm, v, 4, kdims, vstr, kbox);
  if (code == 0) code = hopper::make_map(&wm, w, 2, wdims, wstr, wbox);
  if (code != 0) return code;
  constexpr auto kernel = attention_out_wgmma<D, KV, NWG, STAGES>;
  cudaError_t err = hopper::set_smem_once<kernel>(OUT_SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  // a cluster of `cl` CTAs a query tile, neighbours along x
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cl * ((Tq + L::BM - 1) / L::BM)), (unsigned)B);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, wm, bias, static_cast<const bf16*>(res),
                           static_cast<bf16*>(out), Tq, S, H, C, qscale, cl);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The compiled bf16 tiles of each head dim, (rows, keys a tile, stages), in
// the order of ops/attention.py's OUT_TILES (widest first), of which
// attention_out_plan takes one that fits 227 KB at the launch's H*dh.
#define OUT_TILE(D_, ROWS, KV_, STAGES_)                                                      \
  if (D == D_ && p.rows == ROWS && p.block_kv == KV_ && p.stages == STAGES_ &&               \
      p.w_rows == OutTile<D_, KV_, ROWS / 64, STAGES_>::KW)                                  \
    return launch_wgmma<D_, KV_, ROWS / 64, STAGES_>(q, k, v, w, bias, res, out, B, Tq, S, H, \
                                                     C, qscale, st, p.cluster, stream);

int launch_bf16(int D, const void* q, const void* k, const void* v, const void* w,
                const float* bias, const void* res, void* out, int B, int Tq, int S, int H,
                int C, float qscale, Strides st, Plan p, cudaStream_t stream) {
  if (p.n_chunk != OUT_NCH) return (int)cudaErrorInvalidValue;
  OUT_TILE(32, 192, 64, 3) OUT_TILE(32, 128, 64, 3) OUT_TILE(32, 64, 64, 3)
  OUT_TILE(40, 192, 64, 3) OUT_TILE(40, 128, 64, 3) OUT_TILE(40, 64, 64, 3)
  OUT_TILE(64, 192, 64, 3) OUT_TILE(64, 128, 64, 3) OUT_TILE(64, 64, 64, 3)
  OUT_TILE(80, 128, 32, 2) OUT_TILE(80, 64, 32, 3)
  OUT_TILE(128, 128, 32, 2) OUT_TILE(128, 64, 32, 3)
  OUT_TILE(160, 64, 16, 3)
  OUT_TILE(256, 64, 64, 2) OUT_TILE(256, 64, 16, 2)
  OUT_TILE(512, 64, 16, 2) OUT_TILE(512, 64, 16, 1)
  return (int)cudaErrorInvalidValue;  // the host's plan is not a compiled one
}
#undef OUT_TILE

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, w, residual and out share it;
// bf16 pointers 16-byte aligned and strides multiples of 8). Dh one of 32,
// 40, 64, 80, 128, 160, 256, 512; H*Dh at most MAX_INNER; C % 8 == 0 and at
// most MAX_C. qscale is scale * log2(e). q_bs, q_ts (and k_, v_) are batch
// and token strides in elements, the channel stride 1; w is (H*Dh, C)
// row-major; bias is null or (C,) fp32; residual and out are (B, T, C)
// contiguous. rows, block_kv, stages, cluster, n_chunk and w_rows are the
// host's tile (ops/attention.py::attention_out_plan); a tile other than a
// compiled one is refused. Returns the cudaError_t of the launch, or a
// TMA-encoding error code (>= 10000).
extern "C" int dpm_attention_out_fwd(const void* q, const void* k, const void* v, const void* w,
                                     const void* bias, const void* res, void* out, int B, int T,
                                     int S, int H, int Dh, int C, float qscale, long long q_bs,
                                     long long q_ts, long long k_bs, long long k_ts,
                                     long long v_bs, long long v_ts, int dtype, int rows,
                                     int block_kv, int stages, int cluster, int n_chunk,
                                     int w_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H * Dh > MAX_INNER || C % 8 != 0 || C > MAX_C || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts};
  const Plan p{rows, block_kv, stages, cluster, n_chunk, w_rows};
  const float* fbias = static_cast<const float*>(bias);
  if (dtype == 1) return launch_bf16(Dh, q, k, v, w, fbias, res, out, B, T, S, H, C, qscale, st, p, s);
#define OUT_F32(D_) \
  case D_: return launch_f32<D_>(q, k, v, w, fbias, res, out, B, T, S, H, C, qscale, st, p, s);
  switch (Dh) {
    OUT_F32(32) OUT_F32(40) OUT_F32(64) OUT_F32(80) OUT_F32(128) OUT_F32(160) OUT_F32(256)
    OUT_F32(512)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OUT_F32
}
