// The forward of the fused GMM Baum-Welch statistics on Hopper (sm_90a).
//
// Replaces speakerguard_tpu/ops/pallas_gmm_stats.py _stats_fwd (kernel
// _fwd_kernel):
//    loglike = aug16 . proj16 + gconsts (bf16 operands, f32 accumulation),
//    posts = softmax over C (f32), zeroth = sum_t posts, first =
//    posts16^T x16, and the bf16 posteriors posts16 as the backward's
//    residual.  x16 = bf16(x), aug16 = [x16, bf16(x16[r] x16[c])].
// Bound at (B 64, T 300, D 72, C 2048; N = B T = 19200 rows, F = 2700):
//    2 N F C + 2 N C D = 218 GFLOP of bf16 products, 0.22 ms at 989
//    TFLOP/s (chip_smoke.py gmm_bounds); its own bytes (x, proj16, zeroth,
//    first, posts16: ~133 MB) take 0.04 ms.
//
// The TPU kernel keeps the 11 MB projection in VMEM and never writes the
// (N, F) augmentation or the (N, C) loglike.  Here three launches on the
// N = B T flattened rows split the work so that the product is a plain
// TMA + wgmma GEMM, run once:
//
//  1  aug16_kernel          aug16 (N, F_pad) bf16, F_pad = round_up(F, 64)
//                           (2752 at D = 72), pad columns 0; 16-byte
//                           stores, 8 columns a thread.
//  2  loglike_gemm_kernel   loglike (N, ld) f32 = aug16 . projK^T + gconsts
//                           with projK (C, F_pad) the K-major copy of proj16
//                           the wrapper builds, and per (row, 256-column
//                           tile) softmax partials (max, sum exp(l - max))
//                           over the columns < C.  The persistent TMA +
//                           wgmma GEMM of wgmma_gemm.cuh (128 x 256 tiles,
//                           a 4-stage TMA ring, two consumer warpgroups on
//                           wgmma m64n256k16) with this epilogue.  TMA
//                           fills rows >= N and columns >= C with zeros;
//                           they are left out of the partials and of the
//                           stores that matter (ld = round_up(C, 256),
//                           columns >= C are scratch).
//  3  normalise_stats_kernel  a block per (utterance, 128 components) walks
//                           T in 64-frame chunks in a fixed order (sums are
//                           reproducible, no atomics): combines each frame's
//                           partials in tile order, posts = exp(l - m) (1/s)
//                           in f32, writes posts16, sums zeroth in f32 and
//                           first = posts16^T x16 on the tensor cores (WMMA,
//                           accumulators held across the T loop).  It moves
//                           the loglike once (bytes bound it): each thread
//                           keeps eight 16-byte loads in flight.
//
// Moved on purpose beyond the function's own bytes: aug16 written and read
// (2 x 106 MB at the main shape), loglike written and read (2 x 157 MB),
// projK (11 MB): ~0.55 GB, ~0.17 ms at 3.35 TB/s.  In return the product,
// 212 GFLOP of the 218, runs once as a textbook tensor-core GEMM, where
// building the augmentation inside the product's blocks made the previous
// design rebuild it 32 times with the tensor cores idle.
//
// Every C entry point returns cudaGetLastError() after its launch; a tensor
// map that cannot be encoded returns 10000 + its CUresult.

#include <mma.h>

#include "wgmma_gemm.cuh"

namespace {

using namespace nvcuda;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// 1: aug16.  A block stages the bf16-rounded x of AUG_ROWS rows in shared
// memory.  Each thread owns 8-column chunks of the row: it decodes their
// sources once, then builds the chunk in every row of the block and stores
// it as one 16-byte word (a warp writes 512 neighbouring bytes).  ``pairs``
// maps a packed index p to (r, c) = np.triu_indices(D)[:, p] as r | c << 16.
// x16 x16 is exact in f32, so one rounding of it is the bf16 product.
// ---------------------------------------------------------------------------
constexpr int AUG_ROWS = 32;
constexpr int AUG_THREADS = 128;

__global__ void __launch_bounds__(AUG_THREADS)
aug16_kernel(const float* __restrict__ x, const int* __restrict__ pairs,
             bf16* __restrict__ aug, int rows, int d, int f_pad) {
  extern __shared__ float xs[];  // [AUG_ROWS][d]
  const int r0 = blockIdx.x * AUG_ROWS;
  const int n_rows = min(AUG_ROWS, rows - r0);
  const int f_aug = d + d * (d + 1) / 2;
  for (int i = threadIdx.x; i < n_rows * d; i += AUG_THREADS)
    xs[i] = round_bf16(x[(size_t)r0 * d + i]);
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
      __align__(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = 0.f;
        if (ia[j] >= 0) a = ib[j] < 0 ? xr[ia[j]] : xr[ia[j]] * xr[ib[j]];
        v[j] = __float2bfloat16_rn(a);
      }
      *reinterpret_cast<uint4*>(aug + (size_t)(r0 + m) * f_pad + f0) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// 2: the loglike GEMM (wgmma_gemm.cuh) with an epilogue that adds gconsts,
// writes the loglike (ld = n_ct 256 columns, columns >= c are scratch) and
// each row's softmax partials over the 256-column tile's columns < c.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GEMM_THREADS, 1)
loglike_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const float* __restrict__ gconsts,
                    float* __restrict__ loglike, float* __restrict__ part,
                    int rows, int c, int k_tiles, int n_ct, int n_tiles) {
  const int ld = n_ct * GN;
  auto epi = [=](float (&acc)[128], int row0, int n0, int ct, int q) {
    const int row1 = row0 + 8;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * q + e;
        if (col < c) {
          const float g = __ldg(gconsts + col);
          acc[4 * j + e] += g;
          acc[4 * j + 2 + e] += g;
          mx0 = fmaxf(mx0, acc[4 * j + e]);
          mx1 = fmaxf(mx1, acc[4 * j + 2 + e]);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n0 + 8 * j + 2 * q + e < c) {
          s0 += expf(acc[4 * j + e] - mx0);
          s1 += expf(acc[4 * j + 2 + e] - mx1);
        }
      }
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;  // < ld: ld is a multiple of GN
      if (row0 < rows)
        *reinterpret_cast<float2*>(loglike + (size_t)row0 * ld + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row1 < rows)
        *reinterpret_cast<float2*>(loglike + (size_t)row1 * ld + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (q == 0) {
      if (row0 < rows) {
        float* p = part + ((size_t)row0 * n_ct + ct) * 2;
        p[0] = mx0;
        p[1] = s0;
      }
      if (row1 < rows) {
        float* p = part + ((size_t)row1 * n_ct + ct) * 2;
        p[0] = mx1;
        p[1] = s1;
      }
    }
  };
  gemm_persistent(&map_a, &map_b, k_tiles, n_ct, n_tiles, epi);
}

// ---------------------------------------------------------------------------
// 3: normalise and statistics.  Grid (C tiles of NT, B), 256 threads.
// Thread (g, q) = (tid / 32, tid % 32) holds columns 4 q .. 4 q + 3 of the
// frames g, g + 8, ..., g + 56 of a chunk: it loads all 32 loglikes first
// (eight 16-byte loads in flight), then normalises them.  A warp reads 512
// neighbouring bytes of one frame.  The next chunk's x and partials are
// copied to shared memory (cp.async) while this one is normalised, so no
// step waits on device memory but the loglike loads.  Warp w owns
// components 16 w .. 16 w + 15 of first, NF = D_pad / 16 WMMA accumulators
// held across the T loop.  VEC: 16-byte loads and 8-byte posts16 stores,
// for ld % 4 == 0 and c % 4 == 0.
// ---------------------------------------------------------------------------
constexpr int NT = 128;       // components per block
constexpr int TT = 64;        // frames per chunk
constexpr int NORM_THREADS = 256;
constexpr int NG = NORM_THREADS / 32;  // frame groups of a chunk
constexpr int MAXF = 8;       // NF <= MAXF: D <= 128
constexpr int PLD = NT + 8;   // bf16 leading dim of the posts16 chunk

size_t normalise_smem(int d, int n_ct) {
  const size_t dp = (d + 15) / 16 * 16;
  size_t off = align_up(sizeof(bf16) * TT * PLD);
  off = align_up(off + sizeof(bf16) * TT * (dp + 8));
  off = align_up(off + sizeof(float) * NT * (dp + 4));
  off = align_up(off + sizeof(float) * TT * d);
  off = align_up(off + sizeof(float) * TT * n_ct * 2);
  return off + sizeof(float) * (2 * TT + NG * NT);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <bool VEC, int NF>
__global__ void __launch_bounds__(NORM_THREADS, 2)
normalise_stats_kernel(const float* __restrict__ loglike, int ld,
                       const float* __restrict__ part, int n_ct,
                       const float* __restrict__ x,
                       float* __restrict__ zeroth, float* __restrict__ first,
                       bf16* __restrict__ posts16, int t_len, int d, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int dp = 16 * NF, xld = dp + 8, cld = dp + 4;
  size_t off = 0;
  bf16* ps = reinterpret_cast<bf16*>(smem + off);    // [TT][PLD] posts16
  off = align_up(off + sizeof(bf16) * TT * PLD);
  bf16* xs = reinterpret_cast<bf16*>(smem + off);    // [TT][xld] x16
  off = align_up(off + sizeof(bf16) * TT * xld);
  float* cs = reinterpret_cast<float*>(smem + off);  // [NT][cld] first
  off = align_up(off + sizeof(float) * NT * cld);
  float* xr = reinterpret_cast<float*>(smem + off);  // [TT][d] staged x
  off = align_up(off + sizeof(float) * TT * d);
  float* pr = reinterpret_cast<float*>(smem + off);  // [TT][n_ct][2] staged
  off = align_up(off + sizeof(float) * TT * n_ct * 2);
  float* row_m = reinterpret_cast<float*>(smem + off);  // [TT]
  float* row_r = row_m + TT;                             // [TT] 1 / sum
  float* zs = row_r + TT;                                // [NG][NT]

  const int n0 = blockIdx.x * NT, b = blockIdx.y;
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32, g = warp;
  const int c0 = n0 + 4 * q;  // this thread's first column
  const size_t frame0 = (size_t)b * t_len;
  // x and the partials of frames t0 .. t0 + TT - 1 (those < t_len) into xr
  // and pr, asynchronously
  auto stage = [&](int t0) {
    const int nfr = min(TT, t_len - t0);
    const float* xsrc = x + (frame0 + t0) * d;
    for (int i = threadIdx.x; i < nfr * d; i += NORM_THREADS)
      cp_async4(xr + i, xsrc + i);
    const float* psrc = part + (frame0 + t0) * n_ct * 2;
    for (int i = threadIdx.x; i < nfr * n_ct * 2; i += NORM_THREADS)
      cp_async4(pr + i, psrc + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
  float zacc[4] = {0.f, 0.f, 0.f, 0.f};

  stage(0);
  for (int t0 = 0; t0 < t_len; t0 += TT) {
    // this thread's loglikes of the chunk, issued before anything waits
    float l[TT / NG][4];
#pragma unroll
    for (int i = 0; i < TT / NG; ++i) {
      const int m = g + NG * i;
      const float* src = loglike + (frame0 + t0 + m) * ld + c0;
      const bool frame_ok = t0 + m < t_len;
      if (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (frame_ok && c0 < c) v = __ldg(reinterpret_cast<const float4*>(src));
        l[i][0] = v.x;
        l[i][1] = v.y;
        l[i][2] = v.z;
        l[i][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[i][e] = (frame_ok && c0 + e < c) ? __ldg(src + e) : 0.f;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the staged chunk is in; ps and xs are consumed
    const int nfr = min(TT, t_len - t0);
    for (int i = threadIdx.x; i < TT * dp; i += NORM_THREADS) {
      const int m = i / dp, k = i % dp;
      xs[m * xld + k] =
          __float2bfloat16_rn((m < nfr && k < d) ? xr[m * d + k] : 0.f);
    }
    if (threadIdx.x < TT) {  // the frame's max and sum, in tile order
      const int m = threadIdx.x;
      float mx = 0.f, s = 1.f;
      if (m < nfr) {
        const float* p = pr + m * n_ct * 2;
        mx = -INFINITY;
        for (int j = 0; j < n_ct; ++j) mx = fmaxf(mx, p[2 * j]);
        s = 0.f;
        for (int j = 0; j < n_ct; ++j) s += p[2 * j + 1] * expf(p[2 * j] - mx);
      }
      row_m[m] = mx;
      row_r[m] = 1.f / s;
    }
    __syncthreads();  // xr and pr are consumed
    if (t0 + TT < t_len) stage(t0 + TT);
#pragma unroll
    for (int i = 0; i < TT / NG; ++i) {
      const int m = g + NG * i;
      const bool frame_ok = m < nfr;
      const float mx = row_m[m], r = row_r[m];
      __align__(8) bf16 p16[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = 0.f;
        // times the reciprocal: an IEEE division takes a slow path for
        // each denormal quotient, and most of a frame's 2048 posteriors
        // are that small (it doubled the launch's time)
        if (frame_ok && c0 + e < c) p = expf(l[i][e] - mx) * r;
        zacc[e] += p;
        p16[e] = __float2bfloat16_rn(p);
      }
      *reinterpret_cast<uint2*>(ps + m * PLD + 4 * q) =
          *reinterpret_cast<const uint2*>(p16);
      bf16* dst = posts16 + (frame0 + t0 + m) * c + c0;
      if (VEC) {
        if (frame_ok && c0 < c)
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(p16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (frame_ok && c0 + e < c) dst[e] = p16[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TT; kk += 16) {
      // A = posts16^T (component x frame), column-major in ps
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, ps + kk * PLD + warp * 16, PLD);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, xs + kk * xld + j * 16, xld);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(cs + warp * 16 * cld + j * 16, acc[j], cld,
                            wmma::mem_row_major);
#pragma unroll
  for (int e = 0; e < 4; ++e) zs[g * NT + 4 * q + e] = zacc[e];
  __syncthreads();
  if (threadIdx.x < NT && n0 + threadIdx.x < c) {  // frame groups in order
    float z = 0.f;
    for (int j = 0; j < NG; ++j) z += zs[j * NT + threadIdx.x];
    zeroth[(size_t)b * c + n0 + threadIdx.x] = z;
  }
  for (int i = threadIdx.x; i < NT * d; i += NORM_THREADS) {
    const int n = i / d, k = i % d;
    if (n0 + n < c) first[((size_t)b * c + n0 + n) * d + k] = cs[n * cld + k];
  }
}

}  // namespace

// 1.  x (rows, d) f32, pairs (d(d+1)/2,) int32 -> aug16 (rows, f_pad) bf16,
// f_pad a multiple of 8 (the wrapper pads to 64).
extern "C" int sg_stats_fwd_aug16(const float* x, const int* pairs,
                                  void* aug16, int rows, int d, int f_pad,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_pad % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * AUG_ROWS * d;
  cudaError_t err = prepare(aug16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  aug16_kernel<<<(rows + AUG_ROWS - 1) / AUG_ROWS, AUG_THREADS, smem, s>>>(
      x, pairs, static_cast<bf16*>(aug16), rows, d, f_pad);
  return (int)cudaGetLastError();
}

// 2.  aug16 (rows, f_pad) bf16, projk (c, f_pad) bf16, gconsts (c,) f32 ->
// loglike (rows, ld) f32 with ld = round_up(c, 256) (columns >= c are
// scratch) and part (rows, ld / 256, 2) f32.  f_pad a multiple of 64.
extern "C" int sg_stats_fwd_loglike(const void* aug16, const void* projk,
                                    const float* gconsts, float* loglike,
                                    float* part, int rows, int c, int f_pad,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_pad % GK != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, aug16, rows, f_pad, f_pad, GM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, projk, c, f_pad, f_pad, GN);
  if (rc != 0) return rc;
  const int n_ct = (c + GN - 1) / GN;
  const int n_tiles = n_ct * ((rows + GM - 1) / GM);
  return launch_gemm(loglike_gemm_kernel, n_tiles, s, map_a, map_b, gconsts,
                     loglike, part, rows, c, f_pad / GK, n_ct, n_tiles);
}

// 3.  loglike (b t, ld) f32, part (b t, ceil(c / 256), 2) f32, x (b, t, d)
// f32 -> zeroth (b, c) f32, first (b, c, d) f32, posts16 (b, t, c) bf16.
// d <= 128.
extern "C" int sg_stats_fwd_normalise(const float* loglike, int ld,
                                      const float* part, const float* x,
                                      float* zeroth, float* first,
                                      void* posts16, int b, int t, int d,
                                      int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 16 * MAXF) return (int)cudaErrorInvalidValue;
  typedef void (*Kernel)(const float*, int, const float*, int, const float*,
                         float*, float*, bf16*, int, int, int);
  static const Kernel kernels[2][MAXF] = {
      {normalise_stats_kernel<false, 1>, normalise_stats_kernel<false, 2>,
       normalise_stats_kernel<false, 3>, normalise_stats_kernel<false, 4>,
       normalise_stats_kernel<false, 5>, normalise_stats_kernel<false, 6>,
       normalise_stats_kernel<false, 7>, normalise_stats_kernel<false, 8>},
      {normalise_stats_kernel<true, 1>, normalise_stats_kernel<true, 2>,
       normalise_stats_kernel<true, 3>, normalise_stats_kernel<true, 4>,
       normalise_stats_kernel<true, 5>, normalise_stats_kernel<true, 6>,
       normalise_stats_kernel<true, 7>, normalise_stats_kernel<true, 8>}};
  const int n_ct = (c + GN - 1) / GN;
  const size_t smem = normalise_smem(d, n_ct);
  const Kernel kernel =
      kernels[ld % 4 == 0 && c % 4 == 0][(d + 15) / 16 - 1];
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + NT - 1) / NT, b);
  kernel<<<grid, NORM_THREADS, smem, s>>>(
      loglike, ld, part, n_ct, x, zeroth, first,
      static_cast<bf16*>(posts16), t, d, c);
  return (int)cudaGetLastError();
}
