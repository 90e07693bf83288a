// Batched upper Cholesky factorization R^T R = A for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel speakerguard_tpu/ops/pallas_chol.py
// cholesky_rt (kernel body _make_kernel), which the i-vector SPD solve
// (models/ivector.py spd_solve) calls once per forward pass.
//
// Contract (same as the TPU kernel):
//   A: (B, N, N) float32 or bfloat16, symmetric; only the upper triangle
//      and the diagonal are read.  A bf16 input is converted in the kernel.
//   R: (B, N, N) float32, R^T R = A, strictly-lower triangle exactly 0.
//   bf16_updates: the operands of the O(N^3) trailing updates are rounded
//      to bf16 (accumulation stays f32); the per-column pivot steps stay f32.
//
// Bound on an H100 SXM: N^3/3 flops per matrix, and per matrix N(N+1)/2
// input elements read (the upper triangle) and N^2 f32 written.  At B = 64,
// N = 600 f32 that is 4.6 GFLOP (0.069 ms at the 67 TFLOP/s f32 rate) and
// 138 MB (0.041 ms at 3.35 TB/s): both are well under 0.1 ms, and the
// sequential chain of N pivots is what costs.
//
// Design.  A 600x600 f32 matrix is 1.44 MB, far more than the 227 KB of
// shared memory a block can use, so unlike the TPU kernel (one VMEM-resident
// batch tile) the factor lives in device memory and the sweep is split into
// O(N/NB) launches of a right-looking blocked algorithm:
//
//   init    work = upper(f32(A)); R's strictly-lower triangle = 0.
//   for each panel of NB rows [k0, k1):
//     panel   grid (column chunks, B).  Each block loads the NB x NB
//             diagonal block and its own CW-column chunk of the panel rows
//             into shared memory, and runs the NB sequential pivot steps
//             on both (the tiny diagonal factorization is repeated by every
//             block of a matrix so that the chunks need no grid-wide sync).
//             The result is written to R.
//     update  grid (upper TILE x TILE tiles of the trailing matrix, B).
//             work[k1:, k1:] -= P^T P with P = R[k0:k1, k1:], upper
//             triangle only, a 4x4 register micro-tile per thread.
//
// work (updated A) and R are separate buffers: a panel block reads work and
// writes R, an update block reads R and writes work, so no block of one
// launch reads what another block of the same launch writes.  The launches
// (1 + 2*ceil(N/NB) - 1 per call, 38 at N = 600) amortise over B matrices
// each.  More than B blocks are in flight in both steps (B = 64 < 132 SMs).
// wgmma/TMA for the trailing update are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;       // panel rows (sequential pivot steps per panel)
constexpr int CW = 128;      // panel columns handled by one block
constexpr int TILE = 64;     // trailing-update output tile edge
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void init_kernel(const T* __restrict__ a, float* __restrict__ work,
                            float* __restrict__ out, int n, long long total) {
  const long long nn = (long long)n * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long rc = i % nn;
    const int r = (int)(rc / n), c = (int)(rc % n);
    if (c >= r) {
      work[i] = to_f32(a[i]);
    } else {
      work[i] = 0.f;
      out[i] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
panel_kernel(const float* __restrict__ work, float* __restrict__ out, int n,
             int k0) {
  __shared__ float d[NB][NB + 1];
  __shared__ float pc[NB][CW + 1];
  const int p = min(NB, n - k0);
  const int k1 = k0 + p;
  const int c0 = k1 + blockIdx.x * CW;          // first chunk column
  const int w = max(0, min(CW, n - c0));        // 0 on the last panel
  const size_t base = (size_t)blockIdx.y * n * n;
  const float* wk = work + base;
  float* r_out = out + base;

  for (int i = threadIdx.x; i < NB * NB; i += THREADS) {
    const int r = i / NB, c = i % NB;
    d[r][c] = (r < p && c < p && c >= r)
                  ? wk[(size_t)(k0 + r) * n + k0 + c] : 0.f;
  }
  for (int i = threadIdx.x; i < NB * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    pc[r][c] = (r < p && c < w) ? wk[(size_t)(k0 + r) * n + c0 + c] : 0.f;
  }
  __syncthreads();

  for (int j = 0; j < p; ++j) {
    const float piv = sqrtf(d[j][j]);
    const float inv = 1.f / piv;
    __syncthreads();  // every thread has read d[j][j] before it changes
    for (int c = j + threadIdx.x; c < p; c += THREADS)
      d[j][c] = (c == j) ? piv : d[j][c] * inv;
    for (int c = threadIdx.x; c < w; c += THREADS) pc[j][c] *= inv;
    __syncthreads();
    const int rows = p - j - 1;
    for (int i = threadIdx.x; i < rows * NB; i += THREADS) {
      const int r = j + 1 + i / NB, c = i % NB;
      if (c >= r && c < p) d[r][c] -= d[j][r] * d[j][c];
    }
    for (int i = threadIdx.x; i < rows * CW; i += THREADS) {
      const int r = j + 1 + i / CW, c = i % CW;
      if (c < w) pc[r][c] -= d[j][r] * pc[j][c];
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < p * p; i += THREADS) {
      const int r = i / p, c = i % p;
      r_out[(size_t)(k0 + r) * n + k0 + c] = (c >= r) ? d[r][c] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < p * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    if (c < w) r_out[(size_t)(k0 + r) * n + c0 + c] = pc[r][c];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
update_kernel(const float* __restrict__ out, float* __restrict__ work, int n,
              int k0) {
  __shared__ float pr[NB][TILE];
  __shared__ float pq[NB][TILE];
  const int p = min(NB, n - k0);
  const int k1 = k0 + p;
  const int nt = (n - k1 + TILE - 1) / TILE;
  // linear index over the upper tiles (tj >= ti) of the trailing matrix
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int r0 = k1 + ti * TILE, q0 = k1 + tj * TILE;
  const size_t base = (size_t)blockIdx.y * n * n;
  const float* r_in = out + base;
  float* wk = work + base;

  for (int i = threadIdx.x; i < NB * TILE; i += THREADS) {
    const int k = i / TILE, x = i % TILE;
    float vr = 0.f, vq = 0.f;
    if (k < p) {
      const size_t row = (size_t)(k0 + k) * n;
      if (r0 + x < n) vr = r_in[row + r0 + x];
      if (q0 + x < n) vq = r_in[row + q0 + x];
    }
    if (BF16) {
      vr = round_bf16(vr);
      vq = round_bf16(vq);
    }
    pr[k][x] = vr;
    pq[k][x] = vq;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k = 0; k < p; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = pr[k][ty * 4 + u];
      b[u] = pq[k][tx * 4 + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int row = r0 + ty * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = q0 + tx * 4 + v;
      if (row < n && col < n && col >= row)
        wk[(size_t)row * n + col] -= acc[u][v];
    }
  }
}

}  // namespace

// a: (batch, n, n) f32 or bf16 (a_is_bf16); work, out: (batch, n, n) f32
// buffers from the caller.  Launches on `stream`; returns cudaGetLastError()
// as an int (0 = every launch was accepted).
extern "C" int sg_cholesky_rt(const void* a, int a_is_bf16, float* work,
                              float* out, int batch, int n, int bf16_updates,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * n * n;
  const int init_blocks =
      (int)(total / THREADS + 1 < 132 * 32 ? total / THREADS + 1 : 132 * 32);
  if (a_is_bf16)
    init_kernel<<<init_blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), work, out, n, total);
  else
    init_kernel<<<init_blocks, THREADS, 0, s>>>(static_cast<const float*>(a),
                                                work, out, n, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  for (int k0 = 0; k0 < n; k0 += NB) {
    const int k1 = k0 + NB < n ? k0 + NB : n;
    const int m = n - k1;
    const int chunks = m > 0 ? (m + CW - 1) / CW : 1;
    panel_kernel<<<dim3(chunks, batch), THREADS, 0, s>>>(work, out, n, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (m > 0) {
      const int nt = (m + TILE - 1) / TILE;
      const dim3 grid(nt * (nt + 1) / 2, batch);
      if (bf16_updates)
        update_kernel<true><<<grid, THREADS, 0, s>>>(out, work, n, k0);
      else
        update_kernel<false><<<grid, THREADS, 0, s>>>(out, work, n, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// The panel height NB, so the host can check that its plain version groups
// the trailing updates the same way.
extern "C" int sg_cholesky_rt_nb() { return NB; }
