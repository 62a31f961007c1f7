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
// the work the way the Pallas pair does, with no atomics anywhere:
//
// - dq: a block owns one (batch*head, 64-query tile) and streams K/V tiles;
// - dk/dv: a block owns one (batch*head, 64-key tile) and streams Q/dO tiles.
//
// The pair does 7 products of T*S*D (the forward does 2): about 14*T*S*D
// flops per head against 2 bytes * D * (4*T + 4*S) of bf16 inputs and
// outputs, hundreds of flops per byte once T = S >= 64, so the products
// bound it and belong on the tensor cores. Two forms by dtype, at every head
// dim the forward takes (32, 40, 64, 80, 96, 128, 160, 192, 256, 384, 512,
// 576, 960):
//
// - bf16: `attn_dq_wgmma` and `attn_dkv_wgmma`, FlashAttention-3's backward
//   in shape. A block is one producer warp and one consumer warpgroup that
//   owns the block's 64 rows. The producer loads the owned operands once by
//   TMA (q and dO for dq; k and v for dk/dv) and streams the other side's
//   tiles through a ring of STAGES shared-memory stages, each guarded by a
//   full and an empty mbarrier; for dk/dv its 32 lanes also copy each
//   tile's lse and delta rows into the stage. The consumer computes the
//   logits and dp with `wgmma` from shared memory into registers (dq: S =
//   Q.K^T and dP = dO.V^T; dk/dv: S^T = K.Q^T and dP^T = V.dO^T, all
//   K-major), forms p and ds on the accumulators in registers (their layout
//   is known: a thread holds rows r, r + 8 of its warp's 16 and columns
//   2(lane%4) (+1) of every 8), rounds them to bf16 in registers, as the
//   Pallas kernels round them (`ds.astype(k_ref.dtype)`), and feeds them as
//   the register A operand of the second products: dq += dS.K, dv += P^T.dO,
//   dk += dS^T.Q, with K, dO and Q read MN-major through the transpose bit.
//   Nothing of z, dp, p or ds touches shared memory. The sums stay in fp32
//   registers across the whole stream and are rounded once. q, k, v and dO
//   arrive through 4-D tensor maps over (d, head, token, batch) with the
//   caller's strides (fused-qkv column slices load in place); TMA's zero
//   fill pads ragged T and S and the head dims that are not a multiple of
//   64, as in attention.cu. Keys >= S and queries >= T get p = 0, so they
//   add nothing, and their rows are never written.
//   * Registers. A thread holds outs * cols / 2 fp32 sums (outs: dk and dv,
//     or one of them; cols: the output columns of the block), the logits and
//     dp of one tile (tile / 2 each) and the bf16 fragments of p and ds
//     (tile / 4 each): kept within BF16_REG_BUDGET. So the streamed tile is
//     64 rows where that fits, else 32 (dh 192, 256 and 384; dk/dv at dh 96
//     and 128), else 16 (dh 512 and 576, where shared memory decides);
//     dk/dv accumulates both outputs in one block up to dh 128, and from dh
//     160 on one output a block, the other in a second block of the grid
//     (grid.z), which recomputes the logits (dv's block skips dp): 1.25x the
//     flops of one pass. The 512-wide head splits its output columns into
//     two 256-wide slices and the single heads of 384, 576 and 960 into
//     WIDE_DV = 192-column slices (grid.z; 192 divides all three in whole
//     64-column tiles, as in the forward), each block recomputing the
//     logits over the whole head: at dh 960 5x the logits of one pass.
//     dh 96 and 192 run as 80 and 160 do: the tiles are whole 64-column
//     runs (128 and 192 columns) and TMA zero-fills the columns past dh.
//   * Shared memory: the owned 64-row operands (2 x 64 KB at dh 512, 2 x 72
//     KB at 576) and the ring; at dh 512 and 576 the streamed tiles are 16
//     rows, three and two stages (576: 222,248 bytes of 232,448).
//   * dh 960 ("chunked"): the two owned 64-row operands alone take 240 KB,
//     more than a block may use, so the block owns no operand. It streams
//     both sides through one ring of BF16_CHUNK_STAGES stages, a stage one
//     64-column chunk c of the owned rows' two operands (64 x 64 each) and
//     of the streamed tile's two (TILE x 64 each): for each streamed tile
//     the consumer sums the logits and dp chunk by chunk over the DCH = 15
//     chunk stages, then takes one more stage that holds the tile's
//     operand of the second product at the block's output columns (dq: K,
//     dk: Q, dv: dO; COLS / 64 chunks) and accumulates from it. The owned
//     rows are re-read from L2 once per streamed tile; the ring is 100 KB.
// - fp32: `attn_bwd_f32`, exact on the CUDA cores (no TF32), one kernel for
//   both outputs (its operand roles swap): a block of 256 threads owns 16
//   rows and streams tiles of 256 / PARTS rows (128 up to dh 80, 64 at 96
//   to 160, 32 at 192 and 256, 16 at 384 to 576), double-buffered with
//   cp.async, so the next tile's load overlaps this tile's math. At dh 960
//   16-row tiles do not fit even one buffer beside the owned rows (243 KB),
//   so there PARTS = 32 (a warp sums one patch, 30 columns a lane) and the
//   tiles are 8 rows, one buffer (186 KB): after the butterfly a lane holds
//   one of a pair (z, dp), which its neighbour lane hands it. Each tile goes in three
//   register-tiled phases. (1) z and dp: each thread computes a 4x4 patch of
//   both over one of PARTS interleaved slices of the head dim (at most
//   F32_SLICE columns), so 16 shared-memory reads feed 32 FMAs; a butterfly
//   over the PARTS lanes of a patch sums the slices and leaves each lane a
//   share of the patch. (2) p and ds from it, into shared memory. (3) The
//   sums: a thread owns 4 rows x ceil(dh/64) columns of dq (or of dk and of
//   dv), so 4 (+4) broadcast reads and ceil(dh/64) (x2) row reads feed 4x
//   as many FMAs. Where dk's and dv's sums do not fit F32_REG_BUDGET beside
//   phase 1's (dh 960: 32 + 4 x 15 x 2 = 152 registers), dk and dv take a
//   block each (grid.z), as in bf16. The pitches (dh + 2, or + 4 at 16 slices) keep phase 1's
//   reads on distinct banks. 16 rows a block keep path E's site (b8, T = S
//   = 256, one head) at 128 blocks on the 132 SMs. The tile rule, the
//   streamed copies, phase 1's patch products and the butterfly are
//   attention_f32.cuh's, which the fp32 forward (attention.cu) shares.
//
// The tile of each head dim and dtype is fixed here at compile time
// (Bf16Tile, F32Tile); ops/attention.py::attention_bwd_plan states the same
// rule with the same constants, for the shared-memory figure and the grid,
// and tests/test_torch_kernel_plans.py holds the two together. Layout: q, k,
// v (B, T|S, H*D) with unit channel stride and any batch and token strides
// (the forward's); dO, dq, dk, dv contiguous (B, T|S, H*D); lse and delta
// float32 (B*H, T).

#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

struct Strides {  // element strides of q, k and v
  long long qb, qt, kb, kt, vb, vt;
};

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use

// ---- bf16: TMA + wgmma ------------------------------------------------------

constexpr int BF16_ROWS = 64;          // owned rows a block: one consumer warpgroup
constexpr int BF16_THREADS = 160;      // the warpgroup and one producer warp
constexpr int BF16_MAX_COLS = 256;     // output columns a block: dh 512 in two slices
constexpr int WIDE_DV = 192;           // output columns a block at dh 384, 576 and 960
constexpr int BF16_REG_BUDGET = 176;   // sums + logits + fragments, registers a thread
constexpr int BF16_MAX_STAGES = 3;     // ring depth, where it costs no block an SM
constexpr int BF16_CHUNK_STAGES = 4;   // the chunked ring's depth (dh 960)
constexpr int BF16_BLOCKS_PER_SM = 2;  // what the register budget lets share an SM
constexpr int SM_SMEM = 233472;       // shared memory of one SM (1 KB of it kept a block)

constexpr int pad64(int d) { return (d + 63) / 64 * 64; }
constexpr int bf16_cols(int d) {
  return d <= BF16_MAX_COLS ? d : d % BF16_MAX_COLS == 0 ? BF16_MAX_COLS : WIDE_DV;
}
// fp32 registers a thread: the sums, the logits and dp, the p and ds fragments
constexpr int bf16_regs(int outs, int cols, int tile) { return outs * cols / 2 + 3 * tile / 2; }
constexpr long long bf16_smem(int d, int tile, int stages, bool dkv, bool chunked = false) {
  // + 1024 to align to a swizzle atom; the owned operands and the ring
  // (chunked: the ring of chunk stages, each a 64-column chunk of the two
  // owned and the two streamed operands), (dk/dv) the stages' lse and delta
  // rows, the owned, full and empty barriers
  const long long body = chunked ? (long long)stages * 2 * (BF16_ROWS + tile) * 128
                                 : 2LL * BF16_ROWS * pad64(d) * 2 +
                                       (long long)stages * 2 * tile * pad64(d) * 2;
  return 1024 + body + (dkv ? (long long)stages * 2 * tile * 4 : 0) + 8LL * (1 + 2 * stages);
}
// dk/dv takes both outputs in one block where their sums fit beside a 32-row tile
constexpr int bf16_outs(int d, bool dkv) {
  return dkv && bf16_regs(2, d, 32) <= BF16_REG_BUDGET ? 2 : 1;
}
// the widest streamed tile within the register budget (owned: and whose two
// stages fit beside the owned operands)
constexpr int bf16_fit_tile(int d, bool dkv, bool owned) {
  for (int t = 64; t >= 16; t /= 2)
    if (bf16_regs(bf16_outs(d, dkv), bf16_cols(d), t) <= BF16_REG_BUDGET &&
        (!owned || bf16_smem(d, t, 2, dkv) <= SMEM_LIMIT))
      return t;
  return 0;
}
// no tile fits beside the owned operands: stream them too, in chunks
constexpr bool bf16_chunked(int d, bool dkv) { return bf16_fit_tile(d, dkv, true) == 0; }
constexpr int bf16_tile(int d, bool dkv) { return bf16_fit_tile(d, dkv, !bf16_chunked(d, dkv)); }
constexpr long long bf16_blocks(long long smem) {
  return SM_SMEM / (smem + 1024) < BF16_BLOCKS_PER_SM ? SM_SMEM / (smem + 1024)
                                                      : BF16_BLOCKS_PER_SM;
}
// the deeper ring where it fits and keeps as many blocks an SM as two stages
constexpr int bf16_stages(int d, bool dkv) {
  if (bf16_chunked(d, dkv)) return BF16_CHUNK_STAGES;
  const int t = bf16_tile(d, dkv);
  const long long deep = bf16_smem(d, t, BF16_MAX_STAGES, dkv);
  return deep <= SMEM_LIMIT && bf16_blocks(deep) >= bf16_blocks(bf16_smem(d, t, 2, dkv))
             ? BF16_MAX_STAGES
             : 2;
}

template <int D, bool DKV>
struct Bf16Tile {
  static constexpr int OUTS = bf16_outs(D, DKV), COLS = bf16_cols(D);
  static constexpr bool CHUNKED = bf16_chunked(D, DKV);
  static constexpr int TILE = bf16_tile(D, DKV), STAGES = bf16_stages(D, DKV);
  static constexpr int SLICES = D / COLS;              // grid.z: output column slices
  static constexpr int PASSES = DKV ? 2 / OUTS : 1;    // x grid.z: dv's block, dk's block
  static constexpr int DCH = pad64(D) / 64;            // 64-column tiles of a row
  static constexpr int KSTEPS = (D + 15) / 16;         // k16 steps over the head dim
  static constexpr uint32_t OWN_CHUNK = BF16_ROWS * 128;  // 64 columns of the owned rows
  static constexpr uint32_t TILE_CHUNK = TILE * 128;      // 64 columns of a streamed tile
  static constexpr uint32_t OWN_BYTES = CHUNKED ? 0 : DCH * OWN_CHUNK;  // one owned operand
  static constexpr uint32_t TILE_BYTES = DCH * TILE_CHUNK;              // one streamed operand
  // a stage: the streamed tile's two operands; chunked: one chunk of all four
  static constexpr uint32_t STAGE_BYTES = CHUNKED ? 2 * (OWN_CHUNK + TILE_CHUNK) : 2 * TILE_BYTES;
  // chunked: the stage of a tile's operand at the block's output columns
  static constexpr uint32_t SLICE_BYTES = COLS / 64 * TILE_CHUNK;
  static constexpr size_t ROWS_OFF = 2 * (size_t)OWN_BYTES + (size_t)STAGES * STAGE_BYTES;
  static constexpr size_t BAR_OFF = ROWS_OFF + (DKV ? (size_t)STAGES * 2 * TILE * 4 : 0);
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
  static_assert(TILE >= 16 && SMEM == (size_t)bf16_smem(D, TILE, STAGES, DKV, CHUNKED) &&
                    (long long)SMEM <= SMEM_LIMIT,
                "tile");
  static_assert(COLS % 8 == 0 && D % COLS == 0 && (SLICES == 1 || COLS % 64 == 0), "slices");
  static_assert(!CHUNKED || (D % 64 == 0 && COLS % 64 == 0 && OUTS == 1 &&
                             SLICE_BYTES <= STAGE_BYTES),
                "chunks");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// acc (64 x N) = A (64 owned rows at `a`) . B^T (N streamed rows at `b`),
// reduced over the head dim in k16 steps, both K-major; the first step
// overwrites acc. No commit.
template <typename L, int N>
__device__ __forceinline__ void logits(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < L::KSTEPS; ++ks) {
    const int c = ks / 4, kk = ks % 4;
    hopper::Wgmma<N>::template ss<0>(acc, hopper::desc(a + c * BF16_ROWS * 128 + kk * 32, 16, 1024),
                                     hopper::desc(b + c * N * 128 + kk * 32, 16, 1024), ks > 0);
  }
}

// acc (64 x N) (+)= A (64 rows at `a`) . B^T (N rows at `b`) over one
// 64-column chunk, both K-major; unless `add`, the first step overwrites acc.
// No commit.
template <int N>
__device__ __forceinline__ void logits_chunk(float (&acc)[N / 2], uint32_t a, uint32_t b,
                                             bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::Wgmma<N>::template ss<0>(acc, hopper::desc(a + kk * 32, 16, 1024),
                                     hopper::desc(b + kk * 32, 16, 1024), add || kk > 0);
}

// acc (64 x COLS) += F (64 x TILE, register fragments) . X (TILE streamed
// rows at `x`, columns [col0, col0 + COLS), MN-major). No commit.
template <typename L>
__device__ __forceinline__ void accumulate(float (&acc)[L::COLS / 2],
                                           const uint32_t (&f)[L::TILE / 16][4], uint32_t x,
                                           int col0) {
  const uint32_t base = x + (col0 / 64) * L::TILE * 128;
#pragma unroll
  for (int j = 0; j < L::TILE / 16; ++j)
    hopper::Wgmma<L::COLS>::template rs<1>(acc, f[j],
                                           hopper::desc(base + j * 2048, L::TILE * 128, 1024), 1);
}

// rows r and r + 8 of this thread (row0, row0 + 8) of a 64 x COLS fp32 sum,
// times `mul`, rounded to bf16 into dst (rows `tok` apart, column col0 +
// 2(lane%4) at dst); rows >= valid are not written
template <int COLS>
__device__ __forceinline__ void store_rows(const float (&acc)[COLS / 2], float mul,
                                           __nv_bfloat16* dst, long long tok, int row0,
                                           int valid) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < valid) {
      __nv_bfloat16* d = dst + row * tok;
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(d + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
attn_dq_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, float qscale, float scale) {
  using L = Bf16Tile<D, false>;
  using namespace hopper;
  constexpr int TILE = L::TILE, COLS = L::COLS, STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                  // owned q, then dO
  uint8_t* gs = qs + L::OWN_BYTES;
  uint8_t* ring = gs + L::OWN_BYTES;   // stages of (k, v)
  uint64_t* obar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = obar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BF16_ROWS, col0 = blockIdx.z * COLS;
  const int ntiles = (S + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(obar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one lane starts every load
    if (lane == 0 && L::CHUNKED) {
      // per key tile: DCH stages of (q, dO, k, v) chunk c, then K's columns
      // [col0, col0 + COLS)
      for (int t = 0, u = 0; t < ntiles; ++t)
        for (int c = 0; c <= L::DCH; ++c, ++u) {
          const int s = u % STAGES;
          mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * L::STAGE_BYTES;
          if (c < L::DCH) {
            mbar_expect_tx(&full[s], L::STAGE_BYTES);
            tma_load_4d(st, &qmap, &full[s], 64 * c, h, q0, b);
            tma_load_4d(st + L::OWN_CHUNK, &gmap, &full[s], 64 * c, h, q0, b);
            tma_load_4d(st + 2 * L::OWN_CHUNK, &kmap, &full[s], 64 * c, h, t * TILE, b);
            tma_load_4d(st + 2 * L::OWN_CHUNK + L::TILE_CHUNK, &vmap, &full[s], 64 * c, h,
                        t * TILE, b);
          } else {
            mbar_expect_tx(&full[s], L::SLICE_BYTES);
            for (int i = 0; i < COLS / 64; ++i)
              tma_load_4d(st + i * L::TILE_CHUNK, &kmap, &full[s], col0 + 64 * i, h, t * TILE, b);
          }
        }
    } else if (lane == 0) {
      mbar_expect_tx(obar, 2 * L::OWN_BYTES);
      for (int c = 0; c < L::DCH; ++c) {
        tma_load_4d(qs + c * BF16_ROWS * 128, &qmap, obar, 64 * c, h, q0, b);
        tma_load_4d(gs + c * BF16_ROWS * 128, &gmap, obar, 64 * c, h, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        uint8_t* ks = ring + s * L::STAGE_BYTES;
        for (int c = 0; c < L::DCH; ++c) {
          tma_load_4d(ks + c * TILE * 128, &kmap, &full[s], 64 * c, h, t * TILE, b);
          tma_load_4d(ks + L::TILE_BYTES + c * TILE * 128, &vmap, &full[s], 64 * c, h, t * TILE, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's query rows row0 and row0 + 8
  const int quad = lane % 4;
  const int row0 = q0 + warp * 16 + lane / 4;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    lr[r] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    dr[r] = t < Tq ? delta[(long long)bh * Tq + t] : 0.f;
  }
  float acc[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
  float sacc[TILE / 2], pacc[TILE / 2];
  uint32_t dsa[TILE / 16][4];
  const uint32_t q_addr = smem_u32(qs), g_addr = smem_u32(gs), ring_addr = smem_u32(ring);
  if (!L::CHUNKED) mbar_wait(obar, 0);

  for (int t = 0; t < ntiles; ++t) {
    int s;            // the stage that holds K (chunked: K's output columns)
    uint32_t k_addr;
    if constexpr (L::CHUNKED) {
      for (int c = 0; c < L::DCH; ++c) {
        const int u = t * (L::DCH + 1) + c;
        s = u % STAGES;
        const uint32_t a = ring_addr + s * L::STAGE_BYTES;
        mbar_wait(&full[s], (u / STAGES) & 1);
        wgmma_fence();
        logits_chunk<TILE>(sacc, a, a + 2 * L::OWN_CHUNK, c > 0);   // S += Q_c.K_c^T
        logits_chunk<TILE>(pacc, a + L::OWN_CHUNK, a + 2 * L::OWN_CHUNK + L::TILE_CHUNK,
                           c > 0);                                   // dP += dO_c.V_c^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      const int u = t * (L::DCH + 1) + L::DCH;
      s = u % STAGES;
      k_addr = ring_addr + s * L::STAGE_BYTES;
      mbar_wait(&full[s], (u / STAGES) & 1);
    } else {
      s = t % STAGES;
      k_addr = ring_addr + s * L::STAGE_BYTES;
      const uint32_t v_addr = k_addr + L::TILE_BYTES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      wgmma_fence();
      logits<L, TILE>(sacc, q_addr, k_addr);   // S = Q.K^T
      logits<L, TILE>(pacc, g_addr, v_addr);   // dP = dO.V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
    }
    // p and ds in registers; k-step j of dS.K takes accumulator columns
    // [16j, 16j + 16): sacc[8j .. 8j + 8) in pairs
    const int key0 = t * TILE + 2 * quad;
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * j + 2 * r, key = key0 + 8 * (2 * j + r / 2), hr = r % 2;
        const float p0 = key < S ? ex2(sacc[i] * qscale - lr[hr]) : 0.f;
        const float p1 = key + 1 < S ? ex2(sacc[i + 1] * qscale - lr[hr]) : 0.f;
        dsa[j][r] = pack_bf16(p0 * (pacc[i] - dr[hr]), p1 * (pacc[i + 1] - dr[hr]));
      }
    fence_frags(dsa);
    fence_regs(acc);
    wgmma_fence();
    accumulate<L>(acc, dsa, k_addr, L::CHUNKED ? 0 : col0);   // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long tok = (long long)H * D;
  store_rows<COLS>(acc, scale, dq + (long long)b * Tq * tok + (long long)h * D + col0 + 2 * quad,
                   tok, row0, Tq);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
attn_dkv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq, int S,
               int H, float qscale, float scale) {
  using L = Bf16Tile<D, true>;
  using namespace hopper;
  constexpr int TILE = L::TILE, COLS = L::COLS, STAGES = L::STAGES, OUTS = L::OUTS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                  // owned k, then v
  uint8_t* vs = ks + L::OWN_BYTES;
  uint8_t* ring = vs + L::OWN_BYTES;   // stages of (q, dO)
  float* rows = reinterpret_cast<float*>(smem + L::ROWS_OFF);  // [STAGES][lse, delta][TILE]
  uint64_t* obar = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = obar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BF16_ROWS;
  // grid.z: the column slice, and (one output a block) which output: 0 dv, 1 dk
  const int pass = OUTS == 2 ? 2 : blockIdx.z % 2;
  const int col0 = (OUTS == 2 ? blockIdx.z : blockIdx.z / 2) * COLS;
  const bool want_dk = pass != 0;   // dv alone needs neither v nor dp
  const int ntiles = (Tq + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(obar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, after its lse and delta rows
      mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 && L::CHUNKED) {
    // per query tile: DCH stages of (k, v, q, dO) chunk c (v and dO only for
    // dk), then the tile's Q (dk) or dO (dv) at columns [col0, col0 + COLS)
    // and its lse and delta rows; every lane arrives on every stage
    const uint32_t chunk_bytes = (want_dk ? 2 : 1) * (L::OWN_CHUNK + L::TILE_CHUNK);
    for (int t = 0, u = 0; t < ntiles; ++t)
      for (int c = 0; c <= L::DCH; ++c, ++u) {
        const int s = u % STAGES;
        mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * L::STAGE_BYTES;
        if (c == L::DCH) {
          float* rs = rows + s * 2 * TILE;
          for (int i = lane; i < TILE; i += 32) {
            const int q = t * TILE + i;
            rs[i] = q < Tq ? lse[(long long)bh * Tq + q] : 0.f;
            rs[TILE + i] = q < Tq ? delta[(long long)bh * Tq + q] : 0.f;
          }
        }
        if (lane != 0) {
          mbar_arrive(&full[s]);
        } else if (c < L::DCH) {
          mbar_expect_tx(&full[s], chunk_bytes);
          tma_load_4d(st, &kmap, &full[s], 64 * c, h, k0, b);
          tma_load_4d(st + 2 * L::OWN_CHUNK, &qmap, &full[s], 64 * c, h, t * TILE, b);
          if (want_dk) {
            tma_load_4d(st + L::OWN_CHUNK, &vmap, &full[s], 64 * c, h, k0, b);
            tma_load_4d(st + 2 * L::OWN_CHUNK + L::TILE_CHUNK, &gmap, &full[s], 64 * c, h,
                        t * TILE, b);
          }
        } else {
          mbar_expect_tx(&full[s], L::SLICE_BYTES);
          for (int i = 0; i < COLS / 64; ++i)
            tma_load_4d(st + i * L::TILE_CHUNK, want_dk ? &qmap : &gmap, &full[s],
                        col0 + 64 * i, h, t * TILE, b);
        }
      }
    return;
  }
  if (warp == 4) {  // the producer warp: lane 0 starts the loads, all copy the rows
    if (lane == 0) {
      mbar_expect_tx(obar, (want_dk ? 2 : 1) * L::OWN_BYTES);
      for (int c = 0; c < L::DCH; ++c) {
        tma_load_4d(ks + c * BF16_ROWS * 128, &kmap, obar, 64 * c, h, k0, b);
        if (want_dk) tma_load_4d(vs + c * BF16_ROWS * 128, &vmap, obar, 64 * c, h, k0, b);
      }
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
      float* rs = rows + s * 2 * TILE;
      for (int i = lane; i < TILE; i += 32) {
        const int q = t * TILE + i;
        rs[i] = q < Tq ? lse[(long long)bh * Tq + q] : 0.f;
        rs[TILE + i] = q < Tq ? delta[(long long)bh * Tq + q] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        uint8_t* qt = ring + s * L::STAGE_BYTES;
        for (int c = 0; c < L::DCH; ++c) {
          tma_load_4d(qt + c * TILE * 128, &qmap, &full[s], 64 * c, h, t * TILE, b);
          tma_load_4d(qt + L::TILE_BYTES + c * TILE * 128, &gmap, &full[s], 64 * c, h, t * TILE, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's key rows row0 and row0 + 8
  const int quad = lane % 4;
  const int row0 = k0 + warp * 16 + lane / 4;
  float acc0[COLS / 2];                       // dv, or the block's one output
  float acc1[OUTS == 2 ? COLS / 2 : 2];       // dk, when the block takes both
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (OUTS == 2 ? COLS / 2 : 2); ++i) acc1[i] = 0.f;
  float sacc[TILE / 2], pacc[TILE / 2];
  // dsa: dS^T, or P^T in a block that takes dv alone; pa: P^T beside dS^T
  uint32_t pa[OUTS == 2 ? TILE / 16 : 1][4], dsa[TILE / 16][4];
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs), ring_addr = smem_u32(ring);
  if (!L::CHUNKED) mbar_wait(obar, 0);

  for (int t = 0; t < ntiles; ++t) {
    int s;  // the stage that holds Q and dO (chunked: the one output's operand)
    uint32_t q_addr, g_addr;
    if constexpr (L::CHUNKED) {
      for (int c = 0; c < L::DCH; ++c) {
        const int u = t * (L::DCH + 1) + c;
        s = u % STAGES;
        const uint32_t a = ring_addr + s * L::STAGE_BYTES;
        mbar_wait(&full[s], (u / STAGES) & 1);
        wgmma_fence();
        logits_chunk<TILE>(sacc, a, a + 2 * L::OWN_CHUNK, c > 0);   // S^T += K_c.Q_c^T
        if (want_dk)                                                 // dP^T += V_c.dO_c^T
          logits_chunk<TILE>(pacc, a + L::OWN_CHUNK, a + 2 * L::OWN_CHUNK + L::TILE_CHUNK, c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(pacc);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      const int u = t * (L::DCH + 1) + L::DCH;
      s = u % STAGES;
      q_addr = g_addr = ring_addr + s * L::STAGE_BYTES;
      mbar_wait(&full[s], (u / STAGES) & 1);
    } else {
      s = t % STAGES;
      q_addr = ring_addr + s * L::STAGE_BYTES;
      g_addr = q_addr + L::TILE_BYTES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      wgmma_fence();
      logits<L, TILE>(sacc, k_addr, q_addr);                // S^T = K.Q^T
      if (want_dk) logits<L, TILE>(pacc, v_addr, g_addr);   // dP^T = V.dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
    }
    const float* rl = rows + s * 2 * TILE;
    // P^T and dS^T in registers: accumulator column c is query t*TILE + c
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * j + 2 * r, c = 8 * (2 * j + r / 2) + 2 * quad, q = t * TILE + c;
        const float2 l2 = *reinterpret_cast<const float2*>(rl + c);
        const float p0 = q < Tq ? ex2(sacc[i] * qscale - l2.x) : 0.f;
        const float p1 = q + 1 < Tq ? ex2(sacc[i + 1] * qscale - l2.y) : 0.f;
        const uint32_t pp = pack_bf16(p0, p1);
        if constexpr (OUTS == 2) pa[j][r] = pp;
        if (want_dk) {
          const float2 d2 = *reinterpret_cast<const float2*>(rl + TILE + c);
          dsa[j][r] = pack_bf16(p0 * (pacc[i] - d2.x), p1 * (pacc[i + 1] - d2.y));
        } else {
          dsa[j][r] = pp;
        }
      }
    fence_frags(pa);
    fence_frags(dsa);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
    if constexpr (OUTS == 2) {
      accumulate<L>(acc0, pa, g_addr, col0);    // dV += P^T.dO
      accumulate<L>(acc1, dsa, q_addr, col0);   // dK += dS^T.Q
    } else {   // dK += dS^T.Q, or dV += P^T.dO
      accumulate<L>(acc0, dsa, want_dk ? q_addr : g_addr, L::CHUNKED ? 0 : col0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long tok = (long long)H * D;
  const long long out0 = (long long)b * S * tok + (long long)h * D + col0 + 2 * quad;
  if constexpr (OUTS == 2) {
    store_rows<COLS>(acc0, 1.f, dv + out0, tok, row0, S);
    store_rows<COLS>(acc1, scale, dk + out0, tok, row0, S);
  } else {
    store_rows<COLS>(acc0, want_dk ? scale : 1.f, (want_dk ? dk : dv) + out0, tok, row0, S);
  }
}

// ---- fp32, exact, on the CUDA cores -------------------------------------------

using attn_f32::F32_ROWS;
using attn_f32::F32_THREADS;
constexpr int F32_REG_BUDGET = 128;  // phase-1 partial sums + the output sums, registers a thread

// floats of a block's shared memory at P slices a patch and B buffers: the
// owned rows (pitch PO), B buffers of two streamed tiles (pitch PS) and
// their lse and delta, p and ds (pitch TILE + 1), the owned rows' lse and delta
template <int D, int P>
constexpr long long f32_smem(int bufs) {
  using S = attn_f32::Stream<D, P>;
  return 4LL * (2 * F32_ROWS * S::PO + bufs * (2 * S::TILE * S::PS + 2 * S::TILE) +
                2 * F32_ROWS * (S::TILE + 1) + 2 * F32_ROWS);
}
// the forward's slices (attention_f32.cuh), or 32 where even one buffer of
// its tiles does not fit (dh 960)
template <int D>
constexpr int f32_bwd_parts() {
  return f32_smem<D, attn_f32::f32_parts(D)>(1) <= SMEM_LIMIT ? attn_f32::f32_parts(D) : 32;
}

// the shared streamed tile (attention_f32.cuh), and this kernel's layout
template <int D, bool DKV>
struct F32Tile : attn_f32::Stream<D, f32_bwd_parts<D>()> {
  using S = attn_f32::Stream<D, f32_bwd_parts<D>()>;
  static constexpr int PATCHES = (F32_ROWS / 4) * (S::TILE / 4);  // of z and dp per PARTS lanes
  static constexpr int VALS = 32 / S::PARTS;                      // sums a lane keeps
  static constexpr int PT = S::TILE + 1;                          // p and ds pitch
  static constexpr int OWN = 2 * F32_ROWS * S::PO;                // floats: the owned rows
  static constexpr int BUF = 2 * S::TILE * S::PS + 2 * S::TILE;   // a buffer: 2 tiles, lse, delta
  static constexpr int PDS = 2 * F32_ROWS * PT;                   // p and ds
  static constexpr int OROWS = 2 * F32_ROWS;                      // the owned rows' lse and delta
  static constexpr int BUFS = f32_smem<D, S::PARTS>(2) <= SMEM_LIMIT ? 2 : 1;
  // dk/dv: both outputs in one block where their sums fit the budget
  static constexpr int OUTS = DKV && 32 + 8 * S::NC <= F32_REG_BUDGET ? 2 : 1;
  static constexpr int PASSES = DKV ? 2 / OUTS : 1;               // grid.z
  static constexpr size_t SMEM = 4 * (size_t)(OWN + BUFS * BUF + PDS + OROWS);
  static_assert(S::PARTS * PATCHES == F32_THREADS, "parts");
  static_assert((long long)SMEM == f32_smem<D, S::PARTS>(BUFS) && (long long)SMEM <= SMEM_LIMIT,
                "227 KB of shared memory a block");
};

// start copying streamed rows [r0, r0 + TILE) of x and y (rows sx, sy apart;
// rows >= n read as 0) into a buffer, 8 bytes a copy when `vec`; with `lse`,
// their lse and delta too
template <int D, bool DKV>
__device__ __forceinline__ void load_tile(float* buf, const float* x, long long sx,
                                          const float* y, long long sy, int r0, int n, bool vec,
                                          const float* lse, const float* delta) {
  using L = F32Tile<D, DKV>;
  attn_f32::load_rows<D, L::PARTS>(buf, x, sx, y, sy, r0, n, vec);
  if (lse != nullptr)
    for (int i = threadIdx.x; i < L::TILE; i += F32_THREADS) {
      const bool ok = r0 + i < n;
      hopper::cp_async<4>(buf + 2 * L::TILE * L::PS + i, lse + (ok ? r0 + i : 0), ok);
      hopper::cp_async<4>(buf + 2 * L::TILE * L::PS + L::TILE + i, delta + (ok ? r0 + i : 0), ok);
    }
}

// DKV false: dq (o1). DKV true: dk (o1) and dv (o2); with one output a block
// (OUTS 1), grid.z 0 takes dv and 1 dk. The block owns rows [r0, r0 + 16) of
// q and dO (dq) or of k and v (dk/dv) and streams the others.
template <int D, bool DKV>
__global__ void __launch_bounds__(F32_THREADS, 1)
attn_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ o1, float* __restrict__ o2, int Tq, int S, int H, float qscale,
             float scale, Strides st, int vec) {
  using L = F32Tile<D, DKV>;
  constexpr int TILE = L::TILE, PARTS = L::PARTS, NC = L::NC, BUFS = L::BUFS;
  constexpr bool BOTH = DKV && L::OUTS == 2;   // dv and dk in this block
  extern __shared__ __align__(16) float smem[];
  float* own = smem;                  // [2][16][PO]: q, dO (dq) or k, v (dk/dv)
  float* bufs = own + L::OWN;         // [BUFS][BUF]: streamed k, v (dq) or q, dO, lse, delta
  float* pds = bufs + BUFS * L::BUF;  // [2][16][PT]: p (dk/dv), ds
  float* orow = pds + L::PDS;         // [2][16]: lse, delta of the owned rows (dq)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int r0 = blockIdx.x * F32_ROWS;
  // dq and dk take ds (and the second streamed operand's partner), dv p
  const bool want_dk = !DKV || BOTH || blockIdx.z == 1;
  const long long tok = (long long)H * D;
  const float* qb = q + b * st.qb + (long long)h * D;
  const float* kb = k + b * st.kb + (long long)h * D;
  const float* vb = v + b * st.vb + (long long)h * D;
  const float* gb = dout + (long long)b * Tq * tok + (long long)h * D;
  // owned (a0, a1) and streamed (x0, x1) operands, their row strides and counts
  const float* a0 = DKV ? kb : qb;
  const float* a1 = DKV ? vb : gb;
  const float* x0 = DKV ? qb : kb;
  const float* x1 = DKV ? gb : vb;
  const long long sa0 = DKV ? st.kt : st.qt, sa1 = DKV ? st.vt : tok;
  const long long sx0 = DKV ? st.qt : st.kt, sx1 = DKV ? tok : st.vt;
  const int n_own = DKV ? S : Tq, n_str = DKV ? Tq : S;
  const float* lse_bh = lse + (long long)bh * Tq;
  const float* delta_bh = delta + (long long)bh * Tq;
  const int ntiles = (n_str + TILE - 1) / TILE;

  if constexpr (BUFS == 2) {
    load_tile<D, DKV>(bufs, x0, sx0, x1, sx1, 0, n_str, vec != 0, DKV ? lse_bh : nullptr,
                      delta_bh);
    hopper::cp_async_commit();
  }
  for (int e = tid; e < F32_ROWS * D; e += F32_THREADS) {
    const int r = e / D, d = e % D, row = r0 + r;
    own[r * L::PO + d] = row < n_own ? a0[row * sa0 + d] : 0.f;
    own[(F32_ROWS + r) * L::PO + d] = row < n_own ? a1[row * sa1 + d] : 0.f;
  }
  if (!DKV && tid < F32_ROWS) {
    orow[tid] = r0 + tid < n_own ? lse_bh[r0 + tid] : 0.f;
    orow[F32_ROWS + tid] = r0 + tid < n_own ? delta_bh[r0 + tid] : 0.f;
  }

  // phase 1: patch (rb, cb) = owned rows [4rb, 4rb + 4) x streamed rows
  // [4cb, 4cb + 4), head-dim slice d = part (mod PARTS); a warp's patches
  // share cb, so its streamed reads broadcast and its owned reads spread
  const int part = tid % PARTS, patch = tid / PARTS, rb = patch % 4, cb = patch / 4;
  // phase 3: owned rows [4rg, 4rg + 4), columns ct + 64 i
  const int rg = tid / 64, ct = tid % 64;
  float out0[4][NC], out1[4][BOTH ? NC : 1];   // dq, or dv (or the one output) and dk
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) out0[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (BOTH ? NC : 1); ++i) out1[r][i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if constexpr (BUFS == 1) {  // one buffer: load tile t, then use it
      load_tile<D, DKV>(bufs, x0, sx0, x1, sx1, t * TILE, n_str, vec != 0,
                        DKV ? lse_bh : nullptr, delta_bh);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
    } else if (t + 1 < ntiles) {
      load_tile<D, DKV>(bufs + ((t + 1) & 1) * L::BUF, x0, sx0, x1, sx1, (t + 1) * TILE, n_str,
                        vec != 0, DKV ? lse_bh : nullptr, delta_bh);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // tile t and the owned rows visible
    const float* xs = bufs + (BUFS == 2 ? (t & 1) * L::BUF : 0);   // [2][TILE][PS], lse, delta

    // (1) z = A0.X0^T and dp = A1.X1^T on the patch, over this lane's slice
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    attn_f32::patch_products<D, 2, PARTS>(acc, own, F32_ROWS * L::PO, xs, TILE * L::PS, rb, cb,
                                          part);
    // sum the PARTS slices: lane `part` ends with acc[0 .. VALS) = values
    // [part * VALS, + VALS)
    attn_f32::fold<PARTS, 32>(acc, part);
    // (2) p and ds of element e from its pair (z, dp)
    auto p_ds = [&](int e, float z, float dp) {
      const int row = 4 * rb + e / 4, col = 4 * cb + e % 4;
      const bool ok = r0 + row < n_own && t * TILE + col < n_str;
      const float l = DKV ? xs[2 * TILE * L::PS + col] : orow[row];
      const float dl = DKV ? xs[2 * TILE * L::PS + TILE + col] : orow[F32_ROWS + row];
      const float p = ok ? exp2f(z * qscale - l) : 0.f;
      pds[(F32_ROWS + row) * L::PT + col] = p * (dp - dl);
      if (DKV) pds[row * L::PT + col] = p;
    };
    if constexpr (L::VALS >= 2) {
#pragma unroll
      for (int m = 0; m < L::VALS / 2; ++m)
        p_ds(part * (L::VALS / 2) + m, acc[2 * m], acc[2 * m + 1]);
    } else {  // 32 slices: lane `part` holds value `part`; the even lane takes the pair
      const float mate = __shfl_xor_sync(0xffffffffu, acc[0], 1);
      if (part % 2 == 0) p_ds(part / 2, acc[0], mate);
    }
    __syncthreads();
    // (3) dq += ds.K, or dv += p.dO and dk += ds.Q (one of them: OUTS 1)
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float ds[4], p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ds[r] = pds[(F32_ROWS + 4 * rg + r) * L::PT + j];
        if (DKV) p[r] = pds[(4 * rg + r) * L::PT + j];
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = ct + 64 * i;
        if (D % 64 == 0 || c < D) {
          const float x = xs[j * L::PS + c];
          const float y = DKV ? xs[(TILE + j) * L::PS + c] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (BOTH) {
              out0[r][i] = fmaf(p[r], y, out0[r][i]);
              out1[r][i] = fmaf(ds[r], x, out1[r][i]);
            } else if constexpr (DKV) {
              out0[r][i] = want_dk ? fmaf(ds[r], x, out0[r][i]) : fmaf(p[r], y, out0[r][i]);
            } else {
              out0[r][i] = fmaf(ds[r], x, out0[r][i]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration's load reuses this buffer
  }

  // dq, dk (scaled) and dv
  float* ob = o1 + (long long)b * n_own * tok + (long long)h * D;
  float* vb_out = DKV ? o2 + (long long)b * n_own * tok + (long long)h * D : nullptr;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * rg + r;
    if (row >= n_own) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = ct + 64 * i;
      if (D % 64 != 0 && c >= D) continue;
      if constexpr (BOTH) {
        ob[row * tok + c] = out1[r][i] * scale;          // dk
        vb_out[row * tok + c] = out0[r][i];              // dv
      } else if (want_dk) {
        ob[row * tok + c] = out0[r][i] * scale;          // dq or dk
      } else {
        vb_out[row * tok + c] = out0[r][i];              // dv
      }
    }
  }
}

// ---- host --------------------------------------------------------------------

template <int D>
int launch_f32(bool dkv, const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* o1, void* o2, int B, int Tq, int S,
               int H, float qscale, float scale, Strides st, cudaStream_t s) {
  using LQ = F32Tile<D, false>;
  using LK = F32Tile<D, true>;
  // 8-byte copies where every row of q, k, v and dO starts 8-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  const int vec = any % 8 == 0 && strides % 2 == 0;
  cudaError_t err = dkv ? hopper::set_smem_once<attn_bwd_f32<D, true>>(LK::SMEM)
                        : hopper::set_smem_once<attn_bwd_f32<D, false>>(LQ::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(((dkv ? S : Tq) + F32_ROWS - 1) / F32_ROWS), (unsigned)(B * H),
            (unsigned)(dkv ? LK::PASSES : 1));
  auto* kernel = dkv ? attn_bwd_f32<D, true> : attn_bwd_f32<D, false>;
  kernel<<<grid, F32_THREADS, dkv ? LK::SMEM : LQ::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), lse, delta, static_cast<float*>(o1),
      static_cast<float*>(o2), Tq, S, H, qscale, scale, st, vec);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(bool dkv, const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* o1, void* o2, int B, int Tq, int S,
                int H, float qscale, float scale, Strides st, cudaStream_t s) {
  using Q = Bf16Tile<D, false>;
  using K = Bf16Tile<D, true>;
  // TMA: 16-byte aligned bases and byte strides; 4-byte aligned output pairs
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(o1) |
                        (dkv ? reinterpret_cast<uintptr_t>(o2) : 0);
  const long long strides = st.qb | st.qt | st.kb | st.kt | st.vb | st.vt;
  if (any % 16 != 0 || strides % 8 != 0) return (int)cudaErrorMisalignedAddress;
  // 4-D maps over (d, head, token, batch); the box is 64 columns of one head
  // and the owned (64) or streamed (the tile's) rows
  const long long tok = (long long)H * D;
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Tq, (uint64_t)B};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t qstr[3] = {2ull * D, 2ull * st.qt, 2ull * st.qb};
  const uint64_t kstr[3] = {2ull * D, 2ull * st.kt, 2ull * st.kb};
  const uint64_t vstr[3] = {2ull * D, 2ull * st.vt, 2ull * st.vb};
  const uint64_t gstr[3] = {2ull * D, 2ull * tok, 2ull * Tq * tok};
  const uint32_t own[4] = {64, 1, (uint32_t)BF16_ROWS, 1};
  const uint32_t tile[4] = {64, 1, (uint32_t)(dkv ? K::TILE : Q::TILE), 1};
  const uint32_t* qbox = dkv ? tile : own;   // q and dO: owned by dq, streamed by dk/dv
  const uint32_t* kbox = dkv ? own : tile;
  CUtensorMap qm, km, vm, gm;
  int code = hopper::make_map(&qm, q, 4, qdims, qstr, qbox);
  if (code == 0) code = hopper::make_map(&km, k, 4, kdims, kstr, kbox);
  if (code == 0) code = hopper::make_map(&vm, v, 4, kdims, vstr, kbox);
  if (code == 0) code = hopper::make_map(&gm, g, 4, qdims, gstr, qbox);
  if (code != 0) return code;
  if (dkv) {
    cudaError_t err = hopper::set_smem_once<attn_dkv_wgmma<D>>(K::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((S + BF16_ROWS - 1) / BF16_ROWS), (unsigned)(B * H),
              (unsigned)(K::SLICES * K::PASSES));
    attn_dkv_wgmma<D><<<grid, BF16_THREADS, K::SMEM, s>>>(
        qm, km, vm, gm, lse, delta, static_cast<__nv_bfloat16*>(o1),
        static_cast<__nv_bfloat16*>(o2), Tq, S, H, qscale, scale);
  } else {
    cudaError_t err = hopper::set_smem_once<attn_dq_wgmma<D>>(Q::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((Tq + BF16_ROWS - 1) / BF16_ROWS), (unsigned)(B * H),
              (unsigned)(Q::SLICES * Q::PASSES));
    attn_dq_wgmma<D><<<grid, BF16_THREADS, Q::SMEM, s>>>(
        qm, km, vm, gm, lse, delta, static_cast<__nv_bfloat16*>(o1), Tq, S, H, qscale, scale);
  }
  return (int)cudaGetLastError();
}

int entry(bool dkv, const void* q, const void* k, const void* v, const void* g,
          const void* lse, const void* delta, void* o1, void* o2, int B, int T, int S, int H,
          int D, float qscale, float scale, Strides st, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define DPM_BWD_CASE(DH)                                                                    \
  case DH:                                                                                  \
    return dtype == 0 ? launch_f32<DH>(dkv, q, k, v, g, l, dl, o1, o2, B, T, S, H, qscale,  \
                                       scale, st, s)                                        \
                      : launch_bf16<DH>(dkv, q, k, v, g, l, dl, o1, o2, B, T, S, H, qscale, \
                                        scale, st, s);
    DPM_BWD_CASE(32) DPM_BWD_CASE(40) DPM_BWD_CASE(64) DPM_BWD_CASE(80) DPM_BWD_CASE(96)
    DPM_BWD_CASE(128) DPM_BWD_CASE(160) DPM_BWD_CASE(192) DPM_BWD_CASE(256)
    DPM_BWD_CASE(384) DPM_BWD_CASE(512) DPM_BWD_CASE(576) DPM_BWD_CASE(960)
#undef DPM_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share it;
// bf16 pointers 16-byte aligned, bf16 strides multiples of 8). q, k, v take
// the forward's strides (elements; channel stride 1); dout, dq, dk and dv are
// contiguous (B, T|S, H*D); lse (the forward's, base 2) and delta are float32
// (B*H, T). qscale = scale * log2(e). D is one of 32, 40, 64, 80, 96, 128,
// 160, 192, 256, 384, 512, 576 and 960; the tile is the compiled one of (D,
// dtype). Each returns the
// cudaError_t of its launch, or a TMA-encoding error code (>= 10000).
extern "C" int dpm_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int B, int T, int S, int H, int D, float qscale,
                                    float scale, long long q_bs, long long q_ts, long long k_bs,
                                    long long k_ts, long long v_bs, long long v_ts, int dtype,
                                    void* stream) {
  return entry(false, q, k, v, dout, lse, delta, dq, nullptr, B, T, S, H, D, qscale, scale,
               Strides{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts}, dtype, stream);
}

extern "C" int dpm_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int T, int S, int H, int D,
                                     float qscale, float scale, long long q_bs, long long q_ts,
                                     long long k_bs, long long k_ts, long long v_bs,
                                     long long v_ts, int dtype, void* stream) {
  return entry(true, q, k, v, dout, lse, delta, dk, dv, B, T, S, H, D, qscale, scale,
               Strides{q_bs, q_ts, k_bs, k_ts, v_bs, v_ts}, dtype, stream);
}
