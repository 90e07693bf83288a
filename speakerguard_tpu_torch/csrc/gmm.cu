// The fused GMM frame log-likelihood of the exact path for Hopper (sm_90a).
// (The fast path's Baum-Welch statistics are csrc/gmm_stats_fwd.cu and
// csrc/gmm_stats_bwd.cu.)
//
// It shares one idea with the Pallas TPU kernel it replaces: the augmented
// features aug(x) = [x, triu(x x^T)] (D + D(D+1)/2 = 2700 columns at D = 72)
// are built tile by tile in shared memory from the block's x rows and never
// written to device memory.  ``pairs`` maps a packed index p to
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
// The launch returns cudaGetLastError() through the C entry point.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 64;        // rows (frames) of an output tile

// aug(x)[m, f] from a shared-memory row block xs (row stride ld), in f32
// (0 past the last column).
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
