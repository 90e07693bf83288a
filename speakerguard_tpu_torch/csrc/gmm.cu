// Fused GMM kernels for Hopper (sm_90a): the frame log-likelihood of the
// exact path and the backward of the Baum-Welch statistics of the fast
// attack-gradient path.  (Their forward is csrc/gmm_stats_fwd.cu.)
//
// Both share one idea with the Pallas TPU kernels they replace: the
// augmented features aug(x) = [x, triu(x x^T)] (D + D(D+1)/2 = 2700 columns
// at D = 72) are built tile by tile in shared memory from the block's x rows
// and never written to device memory.  ``pairs`` maps a packed index p to
// its (r, c) = np.triu_indices(D)[:, p] as r | c << 16.
//
// A  loglike_kernel      speakerguard_tpu/ops/pallas_gmm.py fused_loglike /
//                        fused_loglike_batch (kernel _make_kernel).
//    out[n, c] = gconsts[c] + sum_f aug(x_n)[f] quad_proj[f, c], float32
//    throughout (FMA, no TF32: it lies on the exact scoring path).
//    Bound at (19200 rows, F 2700, C 2048): 212 GFLOP at the 67 TFLOP/s f32
//    rate, 3.2 ms; its bytes (x, quad_proj, out: ~185 MB) take 0.055 ms.
//    Design: a 64 x 256 output tile per block, 8 x 8 register micro-tiles,
//    K-slices of 16 aug columns built from the block's x rows in shared
//    memory (each slice serves 256 components).  One launch covers every
//    (b, t) row.
//
// C  stats_bwd_*_kernel  speakerguard_tpu/ops/pallas_gmm_stats.py _stats_bwd
//                        (kernel _bwd_kernel).
//    dp = dz + x16 . bf16(df)^T, dl = posts (dp - sum_c posts dp),
//    daug = bf16(dl) . proj16^T (f32 accumulation), then
//    dx = chain(daug[:, D:], x) + daug[:, :D] + posts16 . bf16(df).
//    Bound: 2 x 19200 x 2700 x 2048 + the two (T, C, D) products = 224
//    GFLOP of bf16 products, 0.23 ms; ~138 MB, 0.04 ms.
//    daug is 2700 f32 columns per frame, too wide for shared memory at any
//    useful tile, so the backward tiles F: launch 1 (a block per (b, 64
//    frames)) sweeps C twice, for the row sums and then dl, writes bf16(dl)
//    (N, C) and the direct term; launch 2 (a block per 64 frames of the
//    flattened batch and share of the F tiles) walks 64-column F tiles,
//    each a WMMA product bf16(dl) . proj16^T (the tensor cores, 16x16x16
//    bf16, f32 accumulators), and applies the chain rule of that tile at
//    once into per-row dx sums held in shared memory; launch 3 adds the
//    shares' partial dx in a fixed order, and the direct term.  Splitting F
//    gives ~1000 blocks where the batch alone gives 300.
//
// The bf16 tiles are staged with 16-byte loads when C % 8 == 0.
//
// Every launch returns cudaGetLastError() through the C entry points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int TM = 64;        // rows (frames) of an output tile
constexpr int TN = 64;        // columns of an output tile
constexpr int BK = 64;        // K-slice of the tensor-core products
constexpr int ALD = BK + 8;   // bf16 leading dims of the staged tiles
constexpr int CLD = TN + 4;   // f32 leading dim of the output tile

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ __forceinline__ size_t align_up(size_t v) {
  return (v + 127) / 128 * 128;
}

// aug(x)[m, f] from a shared-memory row block xs (row stride ld), in f32
// (0 past the last column).  For bf16-valued x the product is exact, so one
// rounding of it to bf16 is the bf16 product.
__device__ __forceinline__ float aug_value(const float* xs, int ld, int m,
                                           int f, int d, int f_aug,
                                           const int* __restrict__ pairs) {
  if (f < d) return xs[m * ld + f];
  if (f >= f_aug) return 0.f;
  const int pr = __ldg(pairs + (f - d));
  return xs[m * ld + (pr & 0xffff)] * xs[m * ld + (pr >> 16)];
}

// ---------------------------------------------------------------------------
// A: float32 fused loglike.  A block computes 64 rows x 256 components, so
// each slice of the aug tile it builds serves 256 columns; each thread
// holds an 8 x 8 register tile (rows 8 ty + u, columns 8 tx + v) fed by
// 16-byte shared-memory loads.  VEC: 16-byte loads of quad_proj
// (C % 4 == 0).
// ---------------------------------------------------------------------------
constexpr int LK = 16;    // K-slice of the f32 product
constexpr int LN = 256;   // components per block

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
loglike_kernel(const float* __restrict__ x, const float* __restrict__ proj,
               const float* __restrict__ gconsts,
               const int* __restrict__ pairs, float* __restrict__ out,
               int rows, int d, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = d + 1;
  float* as = reinterpret_cast<float*>(smem);       // [LK][TM]
  float* bs = as + LK * TM;                         // [LK][LN]
  float* xs = bs + LK * LN;                         // [TM][d + 1]
  const int f_aug = d + d * (d + 1) / 2;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * LN;

  for (int i = threadIdx.x; i < TM * d; i += THREADS) {
    const int m = i / d, k = i % d;
    xs[m * ldx + k] = (m0 + m < rows) ? x[(size_t)(m0 + m) * d + k] : 0.f;
  }
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  float acc[8][8] = {};
  for (int k0 = 0; k0 < f_aug; k0 += LK) {
    __syncthreads();  // xs written; the previous slice consumed
    for (int i = threadIdx.x; i < LK * TM; i += THREADS) {
      const int k = i / TM, m = i % TM;
      as[i] = aug_value(xs, ldx, m, k0 + k, d, f_aug, pairs);
    }
    if (VEC) {
      for (int i = threadIdx.x; i < LK * LN / 4; i += THREADS) {
        const int k = i / (LN / 4), n = (i % (LN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < f_aug && n0 + n < c)
          v = __ldg(reinterpret_cast<const float4*>(
              proj + (size_t)(k0 + k) * c + n0 + n));
        *reinterpret_cast<float4*>(bs + k * LN + n) = v;
      }
    } else {
      for (int i = threadIdx.x; i < LK * LN; i += THREADS) {
        const int k = i / LN, n = i % LN;
        bs[i] = (k0 + k < f_aug && n0 + n < c)
                    ? proj[(size_t)(k0 + k) * c + n0 + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(as + k * TM + 8 * ty);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(as + k * TM + 8 * ty + 4);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(bs + k * LN + 8 * tx);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(bs + k * LN + 8 * tx + 4);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] += a[u] * b[v];
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = m0 + 8 * ty + u;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int col = n0 + 8 * tx + v;
      if (row < rows && col < c)
        out[(size_t)row * c + col] = acc[u][v] + gconsts[col];
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core tile product of C's daug launch:
//   cs[TM][N + 4] = A (TM x K) . B (K x N),  N = 32 WN
// fill_a(k0) stages A[:, k0:k0+BK] into as[m * ALD + k]; fill_b(k0) stages
// B[k0:k0+BK, :] into bs, row-major bs[k * (N + 8) + n] or, B_COL,
// column-major bs[n * ALD + k].  8 warps: warp w owns rows 16 (w / 2) and
// WN 16-column blocks from WN (w % 2) on.  cs may alias as/bs: it is
// written after the last barrier of the K loop.
// ---------------------------------------------------------------------------
template <bool B_COL, int WN, class FillA, class FillB>
__device__ void mma_tile(int k_total, FillA fill_a, FillB fill_b, bf16* as,
                         bf16* bs, float* cs) {
  constexpr int BLD = B_COL ? ALD : 32 * WN + 8;
  constexpr int CL = 32 * WN + 4;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = (warp % 2) * WN;
  typedef typename std::conditional<B_COL, wmma::col_major,
                                    wmma::row_major>::type BLayout;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WN];
#pragma unroll
  for (int j = 0; j < WN; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < k_total; k0 += BK) {
    fill_a(k0);
    fill_b(k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, as + wr * 16 * ALD + kk, ALD);
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
        const bf16* bp = B_COL ? bs + (wc + j) * 16 * BLD + kk
                               : bs + kk * BLD + (wc + j) * 16;
        wmma::load_matrix_sync(fb, bp, BLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < WN; ++j)
    wmma::store_matrix_sync(cs + wr * 16 * CL + (wc + j) * 16, acc[j], CL,
                            wmma::mem_row_major);
  __syncthreads();
}

// Stages rows [r0, r0 + 64) x columns [c0, c0 + COLS) of a row-major bf16
// matrix (nrows x ncols, leading dim ncols) into dst[r * DLD + k], zeros
// outside it.  VEC: 16-byte loads and stores, for ncols % 8 == 0 (c0 is a
// multiple of 64, so no load straddles the edge).
template <bool VEC, int COLS, int DLD>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src,
                                           int r0, int nrows, int c0,
                                           int ncols, bf16* dst) {
  if (VEC) {
    for (int i = threadIdx.x; i < 64 * COLS / 8; i += THREADS) {
      const int r = i / (COLS / 8), k = (i % (COLS / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < nrows && c0 + k < ncols)
        v = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)(r0 + r) * ncols + c0 + k));
      *reinterpret_cast<uint4*>(dst + r * DLD + k) = v;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * COLS; i += THREADS) {
      const int r = i / COLS, k = i % COLS;
      dst[r * DLD + k] = (r0 + r < nrows && c0 + k < ncols)
                             ? src[(size_t)(r0 + r) * ncols + c0 + k]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// C, launch 1: bf16(dl) (N, C) and the direct term posts16 . bf16(df)
// (N, D).  Grid (T tiles, B).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
stats_bwd_dl_kernel(const float* __restrict__ x,
                    const bf16* __restrict__ posts16,
                    const float* __restrict__ dz, const float* __restrict__ df,
                    bf16* __restrict__ dl16, float* __restrict__ direct,
                    int t_len, int d, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 1;
  const int t0 = blockIdx.x * TM, b = blockIdx.y;
  float* xs = reinterpret_cast<float*>(smem);  // [TM][d + 1] x16 values
  float* dfs = xs + TM * ld;                   // [TN][d + 1] bf16(df)
  float* ps = dfs + TN * ld;                   // [TM][TN + 1] posts
  float* pd = ps + TM * (TN + 1);              // [TM][TN + 1] posts * dp
  float* dzs = pd + TM * (TN + 1);             // [TN]
  float* srow = dzs + TN;                      // [TM]
  float* ds = srow + TM;                       // [TM][d] direct sums

  const size_t row0 = (size_t)b * t_len + t0;
  for (int i = threadIdx.x; i < TM * d; i += THREADS) {
    const int m = i / d, k = i % d;
    xs[m * ld + k] = (t0 + m < t_len) ? round_bf16(x[row0 * d + i]) : 0.f;
    ds[i] = 0.f;
  }
  if (threadIdx.x < TM) srow[threadIdx.x] = 0.f;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  auto load_chunk = [&](int c0) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < TN * d; i += THREADS) {
      const int n = i / d, k = i % d;
      dfs[n * ld + k] = (c0 + n < c)
          ? round_bf16(df[((size_t)b * c + c0 + n) * d + k]) : 0.f;
    }
    if (threadIdx.x < TN)
      dzs[threadIdx.x] = (c0 + threadIdx.x < c)
                             ? dz[(size_t)b * c + c0 + threadIdx.x] : 0.f;
    for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
      const int m = i / TN, n = i % TN;
      ps[m * (TN + 1) + n] =
          (t0 + m < t_len && c0 + n < c)
              ? __bfloat162float(posts16[(row0 + m) * c + c0 + n]) : 0.f;
    }
    __syncthreads();
  };
  // dp = dz + x16 . bf16(df)^T on a 4 x 4 micro-tile (rows ty + 16u,
  // columns tx + 16v): the same code in both sweeps gives the same values
  auto dp_tile = [&](float (&dp)[4][4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) dp[u][v] = 0.f;
    for (int k = 0; k < d; ++k) {
      float a[4], w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = xs[(ty + 16 * u) * ld + k];
        w[u] = dfs[(tx + 16 * u) * ld + k];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) dp[u][v] += a[u] * w[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) dp[u][v] = dzs[tx + 16 * v] + dp[u][v];
  };

  // sweep 1: s = sum_c posts dp, and the direct term
  for (int c0 = 0; c0 < c; c0 += TN) {
    load_chunk(c0);
    float dp[4][4];
    dp_tile(dp);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = ty + 16 * u, n = tx + 16 * v;
        pd[m * (TN + 1) + n] = ps[m * (TN + 1) + n] * dp[u][v];
      }
    __syncthreads();
    if (threadIdx.x < TM) {
      float s = srow[threadIdx.x];
      for (int n = 0; n < TN; ++n) s += pd[threadIdx.x * (TN + 1) + n];
      srow[threadIdx.x] = s;
    }
    for (int i = threadIdx.x; i < TM * d; i += THREADS) {
      const int m = i / d, k = i % d;
      float acc = ds[i];
      for (int n = 0; n < TN; ++n)
        acc += ps[m * (TN + 1) + n] * dfs[n * ld + k];
      ds[i] = acc;
    }
  }
  // sweep 2: dl = posts (dp - s), stored bf16
  for (int c0 = 0; c0 < c; c0 += TN) {
    load_chunk(c0);
    float dp[4][4];
    dp_tile(dp);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = ty + 16 * u;
      if (t0 + m >= t_len) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = tx + 16 * v;
        if (c0 + n < c)
          dl16[(row0 + m) * c + c0 + n] = __float2bfloat16_rn(
              ps[m * (TN + 1) + n] * (dp[u][v] - srow[m]));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * d; i += THREADS)
    if (t0 + i / d < t_len) direct[row0 * d + i] = ds[i];
}

size_t stats_bwd_dl_smem(int d) {
  return sizeof(float) * ((size_t)(TM + TN) * (d + 1) + 2 * TM * (TN + 1) +
                          TN + TM + (size_t)TM * d);
}

// ---------------------------------------------------------------------------
// C, launch 2: dx over 64 rows of the flattened (B T) batch.  For each
// 64-column F tile: daug = bf16(dl) . proj16^T on the tensor cores, then the
// chain rule of that tile, one thread per row:
//   f < D:            lin[m][f] = daug
//   f = D + p, (r,c): chain[m][r] += daug x_c,  chain[m][c] += daug x_r
// (x unrounded f32).  Grid (row tiles, shares of the F tiles): the block
// writes chain + lin of its share to part[share]; launch 3 sums the shares.
// ---------------------------------------------------------------------------
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
stats_bwd_dx_kernel(const float* __restrict__ x, const bf16* __restrict__ proj,
                    const bf16* __restrict__ dl16,
                    const int* __restrict__ pairs, float* __restrict__ part,
                    int rows, int d, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int f_aug = d + d * (d + 1) / 2;
  const int ld = d + 1;
  const int m0 = blockIdx.x * TM;
  size_t off = 0;
  bf16* as = reinterpret_cast<bf16*>(smem + off);      // [TM][ALD]
  off = align_up(off + sizeof(bf16) * TM * ALD);
  bf16* bs = reinterpret_cast<bf16*>(smem + off);      // [TN][ALD] col-major
  off = align_up(off + sizeof(bf16) * TN * ALD);
  float* cs = reinterpret_cast<float*>(smem + off);    // [TM][CLD]
  off = align_up(off + sizeof(float) * TM * CLD);
  float* xs = reinterpret_cast<float*>(smem + off);    // [TM][d + 1]
  float* ch = xs + TM * ld;                            // [TM][d + 1]
  float* lin = ch + TM * ld;                           // [TM][d + 1]

  for (int i = threadIdx.x; i < TM * d; i += THREADS) {
    const int m = i / d, k = i % d;
    xs[m * ld + k] = (m0 + m < rows) ? x[(size_t)m0 * d + i] : 0.f;
    ch[m * ld + k] = 0.f;
    lin[m * ld + k] = 0.f;
  }

  // this block's share of the F tiles (grid.y splits them)
  const int n_ft = (f_aug + TN - 1) / TN;
  const int per = (n_ft + gridDim.y - 1) / gridDim.y;
  const int ft_end = min(n_ft, (int)(blockIdx.y + 1) * per);
  for (int f0 = blockIdx.y * per * TN; f0 < ft_end * TN; f0 += TN) {
    auto fill_a = [&](int k0) {  // A[m][k] = dl16[m0 + m][k0 + k]
      stage_tile<VEC, BK, ALD>(dl16, m0, rows, k0, c, as);
    };
    auto fill_b = [&](int k0) {  // B[k][n] = proj16[f0 + n][k0 + k]
      stage_tile<VEC, BK, ALD>(proj, f0, f_aug, k0, c, bs);
    };
    mma_tile<true, 2>(c, fill_a, fill_b, as, bs, cs);
    if (threadIdx.x < TM) {
      const int m = threadIdx.x;
      const int n_end = min(TN, f_aug - f0);
      for (int n = 0; n < n_end; ++n) {
        const int f = f0 + n;
        const float v = cs[m * CLD + n];
        if (f < d) {
          lin[m * ld + f] = v;
        } else {
          const int pr = __ldg(pairs + (f - d));
          const int r = pr & 0xffff, cc = pr >> 16;
          ch[m * ld + r] += v * xs[m * ld + cc];
          ch[m * ld + cc] += v * xs[m * ld + r];
        }
      }
    }
    // the next tile's product rewrites cs only after its own barrier
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.y * rows * d;
  for (int i = threadIdx.x; i < TM * d; i += THREADS) {
    const int m = i / d, k = i % d;
    if (m0 + m < rows) out[(size_t)m0 * d + i] = ch[m * ld + k] + lin[m * ld + k];
  }
}

// C, launch 3: dx = (sum of the F splits' partials, in split order) + the
// direct term.
__global__ void __launch_bounds__(THREADS)
stats_bwd_sum_kernel(const float* __restrict__ part,
                     const float* __restrict__ direct, float* __restrict__ dx,
                     int splits, long long n) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    float acc = 0.f;
    for (int y = 0; y < splits; ++y) acc += part[y * n + i];
    dx[i] = acc + direct[i];
  }
}

size_t stats_bwd_dx_smem(int d) {
  size_t off = align_up(sizeof(bf16) * TM * ALD);
  off = align_up(off + sizeof(bf16) * TN * ALD);
  off = align_up(off + sizeof(float) * TM * CLD);
  return off + sizeof(float) * 3 * (size_t)TM * (d + 1);
}

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

// A.  x (rows, d) f32, proj (d + d(d+1)/2, c) f32, gconsts (c,) f32,
// pairs (d(d+1)/2,) int32 -> out (rows, c) f32.
extern "C" int sg_fused_loglike(const float* x, const float* proj,
                                const float* gconsts, const int* pairs,
                                float* out, int rows, int d, int c,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)TM * (d + 1) + LK * (TM + LN));
  auto kernel = c % 4 == 0 ? loglike_kernel<true> : loglike_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + LN - 1) / LN, (rows + TM - 1) / TM);
  kernel<<<grid, THREADS, smem, s>>>(x, proj, gconsts, pairs, out, rows, d,
                                     c);
  return (int)cudaGetLastError();
}

// C.  x (b, t, d) f32, proj (d + d(d+1)/2, c) bf16, posts16 (b, t, c) bf16,
// dz (b, c) f32, df (b, c, d) f32 -> dx (b, t, d) f32; dl16 (b, t, c) bf16,
// direct (b, t, d) f32 and part (splits, b, t, d) f32 are scratch, splits
// the number of blocks sharing one row tile's F tiles.
extern "C" int sg_stats_bwd(const float* x, const void* proj,
                            const void* posts16, const float* dz,
                            const float* df, const int* pairs, void* dl16,
                            float* direct, float* part, float* dx, int b,
                            int t, int d, int c, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = stats_bwd_dl_smem(d), smem2 = stats_bwd_dx_smem(d);
  auto dx_kernel = c % 8 == 0 ? stats_bwd_dx_kernel<true>
                              : stats_bwd_dx_kernel<false>;
  cudaError_t err = prepare(stats_bwd_dl_kernel, smem1);
  if (err == cudaSuccess) err = prepare(dx_kernel, smem2);
  if (err != cudaSuccess) return (int)err;
  bf16* dl = static_cast<bf16*>(dl16);
  stats_bwd_dl_kernel<<<dim3((t + TM - 1) / TM, b), THREADS, smem1, s>>>(
      x, static_cast<const bf16*>(posts16), dz, df, dl, direct, t, d, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = b * t;
  dx_kernel<<<dim3((rows + TM - 1) / TM, splits), THREADS, smem2, s>>>(
      x, static_cast<const bf16*>(proj), dl, pairs, part, rows, d, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * d;
  const long long blocks = (n + THREADS - 1) / THREADS;
  stats_bwd_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), THREADS, 0,
                         s>>>(part, direct, dx, splits, n);
  return (int)cudaGetLastError();
}
