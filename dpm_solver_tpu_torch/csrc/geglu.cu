// GEGLU feed-forward, out = (h * gelu(gate)) . W2 + b2 with [h | gate] = x . W1 + b1,
// for sm_90a.
//
// Replaces the Pallas kernel dpm_solver_tpu/ops/geglu.py::_geglu_pallas (body
// `_kernel`). That kernel walked the inner dimension as the sequential last
// grid axis, carrying an fp32 (TM, d) accumulator in VMEM scratch from one
// step to the next. Hopper blocks run in parallel and in no order, so here a
// loop inside the block takes the place of that axis:
//
//   for each inner tile i0 (64 wide):
//     h, gate = x . W1[i0 + (0..63), :]^T, x . W1[I + i0 + (0..63), :]^T  (fp32, + b1)
//     p       = bf16(h * gelu(gate))          gelu exact: 0.5 g (1 + erf(g / sqrt 2))
//     acc    += p . W2[:, i0 + (0..63)]^T     (fp32)
//   out = bf16(acc + b2)
//
// W1 (2I, d) and W2 (d, I) are in torch's Linear layout, so a module passes
// its weights as it holds them, with no transpose; both are staged in shared
// memory with the reduction axis contiguous and read as column-major WMMA B
// fragments.
//
// so the (M, 4d) intermediate never reaches device memory. The gate uses
// `erff`: the Abramowitz-Stegun erf of the Pallas kernel (1.5e-7) was a
// workaround for Mosaic, which has no erf, not part of the function.
//
// What bounds it on the H100: 24 * M * d^2 flops (d -> 8d -> d) against
// about 4 * M * d bytes of x and out plus 24 * d^2 bytes of weights: some
// thousands of flops per byte at the SD-2.1 sites, so it is compute-bound
// and the products belong on the tensor cores (WMMA 16x16x16 bf16 fragments
// with fp32 accumulators, `mma.sync`).
//
// The fp32 (TM, d) accumulator does not fit a block at d = 1,280 (5 KB a
// row: 320 KB at TM = 64), so the output columns are split across blocks:
// a block owns TM rows and a DN-wide column slice of the output, keeps its
// accumulator in registers (at most 8 fragments, 64 registers a thread),
// and recomputes h * gelu(gate) for its slice. That costs the first product
// (two thirds of the flops) once per slice: d = 320 takes 2 slices of 160
// (1.67x the flops of the unsplit form), d = 640 three of 224 and d = 1,280
// three of 448 (2.33x each). The x tile stays resident in shared memory for
// the whole inner loop: TM = 64 rows for d <= 640, 32 rows above, so that
// the block fits (d = 1,280: 178,688 bytes; d = 640: 168,448). Eight warps:
// TM/16 along the rows, the rest along the columns. `wgmma`, TMA and
// keeping p in registers (the accumulator layout of `mma.sync` feeds the
// next product directly) are the later steps.
//
// fp32: `geglu_f32`, the exact form on the CUDA cores, 16 rows and 64 output
// columns per block, for the card-against-CPU trajectory check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
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

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2 and out share it); b1 and b2
// are float32. All contiguous, w1 and w2 in torch's Linear layout: x (M, d),
// w1 (2I, d) with [h | gate] row halves, b1 (2I,), w2 (d, I), b2 (d,),
// out (M, d). Returns the cudaError_t of the launch.
extern "C" int dpm_geglu_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int M, int d, int I, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || d <= 0 || I <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(x, w1, b1, w2, b2, out, M, d, I, s);
  if (dtype == 1) return launch_bf16(x, w1, b1, w2, b2, out, M, d, I, s);
  return (int)cudaErrorInvalidValue;
}
