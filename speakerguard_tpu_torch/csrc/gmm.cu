// The fused GMM frame log-likelihood of the exact path on Hopper (sm_90a).
// (The fast path's Baum-Welch statistics are csrc/gmm_stats_fwd.cu and
// csrc/gmm_stats_bwd.cu.)
//
// Replaces speakerguard_tpu/ops/pallas_gmm.py fused_loglike /
// fused_loglike_batch (kernel _make_kernel):
//    out[n, c] = gconsts[c] + sum_f aug(x_n)[f] quad_proj[f, c]
// in float32, with aug(x) = [x, triu(x x^T)] (np.triu_indices order; F = D
// + D(D+1)/2 = 2700 columns at D = 72).  On the TPU it runs at
// Precision.HIGHEST, the ~6-pass bf16 emulation of f32; here the same
// scheme puts the f32 product on the tensor cores.  Each f32 value v is
// split into three bf16 pieces
//    a1 = bf16(v),  a2 = bf16(v - a1),  a3 = bf16(v - a1 - a2),
// which carry v's 24-bit significand, and the product is the six terms
// a_i b_j with i + j <= 4: each exact in the f32 accumulator, the three
// left out of order 2^-26 |a b|.
// Bound at (19200 rows, F 2700, C 2048): the six products, 6 x 212 GFLOP
// at the 989 TFLOP/s bf16 rate, 1.29 ms (the f32 product on the CUDA
// cores: 3.17 ms at 67 TFLOP/s); the function's bytes (x, quad_proj, out:
// ~185 MB) take 0.055 ms (chip_smoke.py gmm_bounds).
//
// Two launches on the N = B T flattened rows (the wrapper builds the B
// operand, projS, in plain torch between them):
//
//  1  aug_split_kernel   augS (N, 3 F_pad) bf16 = [a1 | a2 | a3] of aug(x),
//                        each piece F_pad = round_up(F, 64) wide (2752 at
//                        D = 72) with zero pad columns; each aug value is
//                        formed once in f32 (x, or x_r x_c rounded once) and
//                        split; 16-byte stores, 8 columns a thread.
//  2  loglike_split_gemm_kernel  out (N, C) f32 = the six products
//                        augS piece . projS piece^T, summed, + gconsts, with
//                        projS (C, 3 F_pad) the same split of quad_proj,
//                        K-major.  The persistent TMA + wgmma GEMM of
//                        wgmma_gemm.cuh with its own plan (SplitPlan): a
//                        stage holds the three A and three B pieces of one
//                        64-column k-tile and runs the six products on
//                        them, smallest first (a3b1, a2b2, a1b3, a2b1,
//                        a1b2, a1b1), so each piece is read once, not once
//                        per product; 128 x 128 tiles; each stage's
//                        tensor-core partial sum (384 exact terms) is added
//                        into the tile's total with f32 adds.  The epilogue
//                        adds gconsts and masks its stores.
//
// What the design answers:
//  - accuracy: the tensor cores' f32 accumulation rounds worse than an
//    f32 add, and summing all 6 x 2752 terms into one wgmma accumulator
//    missed the plain f32 product's accuracy at the main shape; a partial
//    sum per stage, added in f32, beats it (chip_smoke.py holds the kernel
//    to 2x the plain product's error against float64).  The second
//    accumulator costs 64 registers a thread, so the tile is 128 x 128
//    where the statistics' GEMMs run 128 x 256;
//  - bytes: at 128 x 128, loading one (A piece, B piece) pair a stage
//    would read 20 GB from L2 at the main shape (2400 tiles x 12 boxes
//    of 16 KB per k-tile x 43 k-tiles); three pieces of each a stage (96
//    KB, two stages) halve that to 10 GB.
//
// Moved on purpose beyond the function's own bytes: augS written and read
// (2 x 317 MB at the main shape) and projS (34 MB): ~0.2 ms at 3.35 TB/s.
// In return the f32 product runs on the tensor cores, where the previous
// design (kernel A: an f32 SIMT tile rebuilding the aug slice for each of
// its 8 column blocks) ran 212 GFLOP of FMA at ~27 TFLOP/s.
//
// Every C entry point returns cudaGetLastError() after its launch; a tensor
// map that cannot be encoded returns 10000 + its CUresult.

#include "wgmma_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1: augS.  A block stages the f32 x of AUG_ROWS rows in shared memory.
// Each thread owns 8-column chunks of the row: it decodes their sources
// once, then builds the chunk in every row of the block and stores each
// piece as one 16-byte word.  ``pairs`` maps a packed index p to (r, c) =
// np.triu_indices(D)[:, p] as r | c << 16.  The _rn intrinsics keep the
// compiler from contracting x_r x_c - a1 into an FMA: the plain version
// rounds the product before it splits it.
// ---------------------------------------------------------------------------
constexpr int AUG_ROWS = 32;
constexpr int AUG_THREADS = 128;

__global__ void __launch_bounds__(AUG_THREADS)
aug_split_kernel(const float* __restrict__ x, const int* __restrict__ pairs,
                 bf16* __restrict__ aug, int rows, int d, int f_pad) {
  extern __shared__ float xs[];  // [AUG_ROWS][d]
  const int r0 = blockIdx.x * AUG_ROWS;
  const int n_rows = min(AUG_ROWS, rows - r0);
  const int f_aug = d + d * (d + 1) / 2;
  for (int i = threadIdx.x; i < n_rows * d; i += AUG_THREADS)
    xs[i] = x[(size_t)r0 * d + i];
  __syncthreads();
  for (int f0 = 8 * threadIdx.x; f0 < f_pad; f0 += 8 * AUG_THREADS) {
    // column f0 + j is xr[ia] (ib < 0), xr[ia] xr[ib], or 0 (ia < 0)
    int ia[8], ib[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = f0 + j;
      ia[j] = f < d ? f : -1;
      ib[j] = -1;
      if (f >= d && f < f_aug) {
        const int pr = __ldg(pairs + (f - d));
        ia[j] = pr & 0xffff;
        ib[j] = pr >> 16;
      }
    }
    for (int m = 0; m < n_rows; ++m) {
      const float* xr = xs + m * d;
      __align__(16) bf16 p1[8], p2[8], p3[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = 0.f;
        if (ia[j] >= 0)
          v = ib[j] < 0 ? xr[ia[j]] : __fmul_rn(xr[ia[j]], xr[ib[j]]);
        p1[j] = __float2bfloat16_rn(v);
        const float r = __fsub_rn(v, __bfloat162float(p1[j]));
        p2[j] = __float2bfloat16_rn(r);
        p3[j] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(p2[j])));
      }
      bf16* row = aug + (size_t)(r0 + m) * (3 * f_pad) + f0;
      *reinterpret_cast<uint4*>(row) = *reinterpret_cast<const uint4*>(p1);
      *reinterpret_cast<uint4*>(row + f_pad) =
          *reinterpret_cast<const uint4*>(p2);
      *reinterpret_cast<uint4*>(row + 2 * f_pad) =
          *reinterpret_cast<const uint4*>(p3);
    }
  }
}

// ---------------------------------------------------------------------------
// 2: the split GEMM's plan (wgmma_gemm.cuh GemmShape): 128 x 128 tiles, a
// stage holds the three pieces of A and of B for one 64-column k-tile (96
// KB, 2 stages) and runs the six products on them, smallest first:
// a3b1, a2b2, a1b3, a2b1, a1b2, a1b1 (A piece (0x001012 >> 4 i) & 15, B
// piece (0x010210 >> 4 i) & 15 for product i).  Piece p of k-tile kt is
// column p F_pad + 64 kt of augS and of projS.  Each stage's partial sum
// is promoted into the total with f32 adds.
// ---------------------------------------------------------------------------
struct SplitPlan : GemmShape<128, 2, 3, 6, true> {
  int f_pad;
  __device__ __forceinline__ int col(int kt, int p) const {
    return p * f_pad + kt * GK;
  }
  __device__ __forceinline__ static int2 product(int i) {
    return make_int2((0x001012 >> (4 * i)) & 15, (0x010210 >> (4 * i)) & 15);
  }
};

// VEC: 8-byte gconsts loads and out stores (c even, gconsts 8-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
loglike_split_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ gconsts,
                          float* __restrict__ out, int rows, int c,
                          int f_pad, int n_ct, int n_tiles) {
  constexpr int BN = SplitPlan::BN;
  auto epi = [=](float (&acc)[BN / 2], int row0, int n0, int, int q) {
    const int row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (VEC) {
        if (col < c) {
          const float2 g =
              __ldg(reinterpret_cast<const float2*>(gconsts + col));
          if (row0 < rows)
            *reinterpret_cast<float2*>(out + (size_t)row0 * c + col) =
                make_float2(acc[4 * j] + g.x, acc[4 * j + 1] + g.y);
          if (row1 < rows)
            *reinterpret_cast<float2*>(out + (size_t)row1 * c + col) =
                make_float2(acc[4 * j + 2] + g.x, acc[4 * j + 3] + g.y);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < c) {
            const float g = __ldg(gconsts + col + e);
            if (row0 < rows)
              out[(size_t)row0 * c + col + e] = acc[4 * j + e] + g;
            if (row1 < rows)
              out[(size_t)row1 * c + col + e] = acc[4 * j + 2 + e] + g;
          }
        }
      }
    }
  };
  SplitPlan plan;
  plan.f_pad = f_pad;
  gemm_persistent(&map_a, &map_b, f_pad / GK, n_ct, n_tiles, epi, plan);
}

}  // namespace

// 1.  x (rows, d) f32, pairs (d(d+1)/2,) int32 -> aug (rows, 3 f_pad) bf16.
// f_pad a multiple of 8, at least d + d(d+1)/2.
extern "C" int sg_loglike_aug_split(const float* x, const int* pairs,
                                    void* aug, int rows, int d, int f_pad,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * AUG_ROWS * d;
  cudaError_t err = prepare(aug_split_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  aug_split_kernel<<<(rows + AUG_ROWS - 1) / AUG_ROWS, AUG_THREADS, smem,
                     s>>>(x, pairs, static_cast<bf16*>(aug), rows, d, f_pad);
  return (int)cudaGetLastError();
}

// 2.  aug (rows, 3 f_pad) bf16, proj (c, 3 f_pad) bf16, gconsts (c,) f32 ->
// out (rows, c) f32.  f_pad a multiple of 64.
extern "C" int sg_loglike_split_gemm(const void* aug, const void* proj,
                                     const float* gconsts, float* out,
                                     int rows, int c, int f_pad,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_pad % GK != 0) return (int)cudaErrorInvalidValue;
  constexpr int BN = SplitPlan::BN;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, aug, rows, 3 * f_pad, 3 * f_pad, GM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, proj, c, 3 * f_pad, 3 * f_pad, BN);
  if (rc != 0) return rc;
  const int n_ct = (c + BN - 1) / BN;
  const int n_tiles = n_ct * ((rows + GM - 1) / GM);
  auto kernel =
      c % 2 == 0 && reinterpret_cast<uintptr_t>(gconsts) % 8 == 0
          ? loglike_split_gemm_kernel<true>
          : loglike_split_gemm_kernel<false>;
  return launch_gemm<SplitPlan>(kernel, n_tiles, s, map_a, map_b, gconsts,
                                out, rows, c, f_pad, n_ct, n_tiles);
}
