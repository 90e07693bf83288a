// The Cholesky family for Hopper (sm_90a): batched upper Cholesky
// factorization R^T R = A, with the inverses of R's diagonal blocks, or with
// a right-hand side carried through to x = A^-1 v.
//
// Replaces the Pallas TPU kernels of speakerguard_tpu/ops/pallas_chol.py,
// which the i-vector SPD solve (models/ivector.py spd_solve) calls once per
// forward pass, one of them as its solver argument selects:
//   sg_cholesky_rt       cholesky_rt       (kernel body _make_kernel)
//   sg_cholesky_rt_dinv  cholesky_rt_dinv  (_make_kernel_dinv)
//   sg_chol_solve        chol_solve        (_make_solve_kernel)
//
// Contract (same as the TPU kernels):
//   A: (B, N, N) float32 or bfloat16 (chol_solve: float32), symmetric; only
//      the upper triangle and the diagonal are read.  A bf16 input is
//      converted in the kernel.
//   R: (B, N, N) float32, R^T R = A, strictly-lower triangle exactly 0.
//   bf16_updates: the operands of the O(N^3) trailing updates are rounded
//      to bf16 (accumulation stays f32); the per-column pivot steps stay f32.
//   dinv_t: (B, ceil(N/128), 128, 128) float32, [:, i] = inv(R_ii)^T for the
//      128 x 128 diagonal blocks of R padded with identity past N.
//   chol_solve: v (B, N) float32 -> x (B, N) float32.
//
// Bound on an H100 SXM: N^3/3 flops per matrix, and per matrix N(N+1)/2
// input elements read (the upper triangle) and N^2 f32 written.  At B = 64,
// N = 600 f32 that is 4.6 GFLOP (0.069 ms at the 67 TFLOP/s f32 rate) and
// 138 MB (0.041 ms at 3.35 TB/s): both are well under 0.1 ms, and the
// sequential chain of N pivots is what costs.  The block inversions add
// 128^3/3 flops per full block and 21 MB of dinv_t; the right-hand side 2N^2
// flops and 2N floats per matrix.
//
// Design.  A 600x600 f32 matrix is 1.44 MB, far more than the 227 KB of
// shared memory a block can use, so unlike the TPU kernels (one
// VMEM-resident batch tile) the factor lives in device memory and the sweep
// is split into O(N/NB) launches of a right-looking blocked algorithm:
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
//
// cholesky_rt_dinv.  The TPU kernel appends an identity block that rides
// the row operations inside each 128-row outer block of its two-level
// sweep.  This sweep has no 128-row stage for it to ride (its NB-row
// panels update the whole trailing matrix), so the sweep runs exactly as
// for cholesky_rt (R bit-identical) and one more launch inverts the
// diagonal blocks of the finished R (dinv_kernel: a block per (128-block,
// matrix), D and X = inv(D) in 132 KB of dynamic shared memory).
//
// chol_solve.  As in the TPU kernel, v rides the sweep as one more column:
// the block of each panel launch that factors the diagonal also applies the
// pivot steps to the panel rows' entries of v, and each update launch has
// one more column of blocks that subtracts P^T y[k0:k1] from the trailing
// entries, so the sweep leaves y = R^-T v.  One more launch, a block per
// matrix, back-substitutes R x = y (backsub_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;       // panel rows (sequential pivot steps per panel)
constexpr int CW = 128;      // panel columns handled by one block
constexpr int TILE = 64;     // trailing-update output tile edge
constexpr int THREADS = 256;
constexpr int DM = 128;      // diagonal-block edge of cholesky_rt_dinv

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

template <bool RHS>
__global__ void __launch_bounds__(THREADS)
panel_kernel(const float* __restrict__ work, float* __restrict__ out,
             const float* __restrict__ y_work, float* __restrict__ y, int n,
             int k0) {
  __shared__ float d[NB][NB + 1];
  __shared__ float pc[NB][CW + 1];
  __shared__ float pv[NB];  // RHS: the panel rows' entries of v
  const int p = min(NB, n - k0);
  const int k1 = k0 + p;
  const int c0 = k1 + blockIdx.x * CW;          // first chunk column
  const int w = max(0, min(CW, n - c0));        // 0 on the last panel
  const size_t base = (size_t)blockIdx.y * n * n;
  const float* wk = work + base;
  float* r_out = out + base;
  // v rides the row operations of the block that also writes the diagonal
  const bool rhs = RHS && blockIdx.x == 0;

  for (int i = threadIdx.x; i < NB * NB; i += THREADS) {
    const int r = i / NB, c = i % NB;
    d[r][c] = (r < p && c < p && c >= r)
                  ? wk[(size_t)(k0 + r) * n + k0 + c] : 0.f;
  }
  for (int i = threadIdx.x; i < NB * CW; i += THREADS) {
    const int r = i / CW, c = i % CW;
    pc[r][c] = (r < p && c < w) ? wk[(size_t)(k0 + r) * n + c0 + c] : 0.f;
  }
  if (rhs && threadIdx.x < NB)
    pv[threadIdx.x] =
        threadIdx.x < p ? y_work[(size_t)blockIdx.y * n + k0 + threadIdx.x]
                        : 0.f;
  __syncthreads();

  for (int j = 0; j < p; ++j) {
    const float piv = sqrtf(d[j][j]);
    const float inv = 1.f / piv;
    __syncthreads();  // every thread has read d[j][j] before it changes
    for (int c = j + threadIdx.x; c < p; c += THREADS)
      d[j][c] = (c == j) ? piv : d[j][c] * inv;
    for (int c = threadIdx.x; c < w; c += THREADS) pc[j][c] *= inv;
    if (rhs && threadIdx.x == 0) pv[j] *= inv;
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
    if (rhs)
      for (int r = j + 1 + threadIdx.x; r < p; r += THREADS)
        pv[r] -= d[j][r] * pv[j];
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
  if (rhs)
    for (int r = threadIdx.x; r < p; r += THREADS)
      y[(size_t)blockIdx.y * n + k0 + r] = pv[r];
}

template <bool BF16, bool RHS>
__global__ void __launch_bounds__(THREADS)
update_kernel(const float* __restrict__ out, float* __restrict__ work,
              const float* __restrict__ y, float* __restrict__ y_work, int n,
              int k0) {
  __shared__ float pr[NB][TILE];
  __shared__ float pq[NB][TILE];
  const int p = min(NB, n - k0);
  const int k1 = k0 + p;
  const int nt = (n - k1 + TILE - 1) / TILE;
  const size_t base = (size_t)blockIdx.y * n * n;
  const float* r_in = out + base;
  float* wk = work + base;

  if (RHS && blockIdx.x >= nt * (nt + 1) / 2) {
    // one more column tile: v[rows] -= P[:, rows]^T y[k0:k1], a thread a
    // row (the block is uniform in this branch, so no barrier is skipped
    // by part of it)
    const int row = k1 + (blockIdx.x - nt * (nt + 1) / 2) * TILE +
                    threadIdx.x;
    if (threadIdx.x < TILE && row < n) {
      const float* yb = y + (size_t)blockIdx.y * n;
      float acc = 0.f;
      for (int k = 0; k < p; ++k)
        acc += r_in[(size_t)(k0 + k) * n + row] * yb[k0 + k];
      y_work[(size_t)blockIdx.y * n + row] -= acc;
    }
    return;
  }

  // linear index over the upper tiles (tj >= ti) of the trailing matrix
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int r0 = k1 + ti * TILE, q0 = k1 + tj * TILE;

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

// cholesky_rt_dinv's last launch: grid (K = ceil(n / DM), B).  A block
// loads R's DM x DM diagonal block D (identity past n) into shared memory
// and solves D X = I by back-substitution, one thread a column of X: row i
// of X is (e_i - sum_{k > i} D[i, k] X[k, :]) / D[i, i], for i from DM - 1
// down.  Row i of D is a broadcast read; each thread reads and writes only
// its own column of X, so the rows need no barrier between them.  Then the
// block writes X^T.  Four partial sums break the chain of dependent adds;
// the k loop starts at the multiple of 4 at or below i, where D[i, k < i]
// and X[i, :] (not yet solved) are 0.
__global__ void __launch_bounds__(DM)
dinv_kernel(const float* __restrict__ out, float* __restrict__ dinv_t,
            int n) {
  extern __shared__ float smem[];
  float* d = smem;                    // [DM][DM + 1]
  float* x = smem + DM * (DM + 1);    // [DM][DM + 1]
  const int o = blockIdx.x * DM;
  const float* r = out + (size_t)blockIdx.y * n * n;
  for (int i = threadIdx.x; i < DM * DM; i += DM) {
    const int rr = i / DM, c = i % DM;
    float v;
    if (o + rr < n && o + c < n)
      v = c >= rr ? r[(size_t)(o + rr) * n + o + c] : 0.f;
    else
      v = rr == c ? 1.f : 0.f;
    d[rr * (DM + 1) + c] = v;
    x[rr * (DM + 1) + c] = 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x;
  for (int i = DM - 1; i >= 0; --i) {
    const float* di = d + i * (DM + 1);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int k = i & ~3; k < DM; k += 4) {
      s0 += di[k] * x[k * (DM + 1) + c];
      s1 += di[k + 1] * x[(k + 1) * (DM + 1) + c];
      s2 += di[k + 2] * x[(k + 2) * (DM + 1) + c];
      s3 += di[k + 3] * x[(k + 3) * (DM + 1) + c];
    }
    x[i * (DM + 1) + c] =
        ((i == c ? 1.f : 0.f) - ((s0 + s1) + (s2 + s3))) / di[i];
  }
  __syncthreads();

  float* dst = dinv_t + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                            DM * DM;
  for (int i = threadIdx.x; i < DM * DM; i += DM) {
    const int rr = i / DM, cc = i % DM;
    dst[i] = x[cc * (DM + 1) + rr];
  }
}

// chol_solve's last launch: grid (B).  Solves R x = y by NB-row blocks from
// the bottom: each warp takes rows of the block and reduces their products
// with the solved x below the block (x lives in device memory; the block's
// barrier makes warp 0's writes visible), then warp 0 solves the NB x NB
// triangle upward with one lane a row, x_j broadcast by shuffle.
__global__ void __launch_bounds__(THREADS)
backsub_kernel(const float* __restrict__ out, const float* __restrict__ y,
               float* x, int n) {
  __shared__ float d[NB][NB + 1];
  __shared__ float rhs[NB];
  const float* r = out + (size_t)blockIdx.x * n * n;
  const float* yb = y + (size_t)blockIdx.x * n;
  float* xb = x + (size_t)blockIdx.x * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k0 = (n - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int p = min(NB, n - k0), k1 = k0 + p;
    for (int i = threadIdx.x; i < NB * NB; i += THREADS) {
      const int rr = i / NB, c = i % NB;
      d[rr][c] = (rr < p && c < p) ? r[(size_t)(k0 + rr) * n + k0 + c] : 0.f;
    }
    for (int rr = warp; rr < p; rr += THREADS / 32) {
      const float* row = r + (size_t)(k0 + rr) * n;
      float s = 0.f;
      for (int c = k1 + lane; c < n; c += 32) s += row[c] * xb[c];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) rhs[rr] = yb[k0 + rr] - s;
    }
    __syncthreads();
    if (warp == 0) {
      float val = lane < p ? rhs[lane] : 0.f;
      for (int j = p - 1; j >= 0; --j) {
        const float xj = __shfl_sync(0xffffffffu, val, j) / d[j][j];
        if (lane < j)
          val -= d[lane][j] * xj;
        else if (lane == j)
          val = xj;
      }
      if (lane < p) xb[k0 + lane] = val;
    }
    __syncthreads();
  }
}

// The sweep of every entry point: init, then a panel and an update launch
// per NB rows.  RHS: v (already copied to y_work) rides as one more column
// and the sweep leaves y = R^-T v in y.
template <bool RHS>
int sweep(const void* a, int a_is_bf16, float* work, float* out,
          float* y_work, float* y, int batch, int n, int bf16_updates,
          cudaStream_t s) {
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
    panel_kernel<RHS><<<dim3(chunks, batch), THREADS, 0, s>>>(
        work, out, y_work, y, n, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (m > 0) {
      const int nt = (m + TILE - 1) / TILE;
      const dim3 grid(nt * (nt + 1) / 2 + (RHS ? nt : 0), batch);
      if (bf16_updates)
        update_kernel<true, RHS><<<grid, THREADS, 0, s>>>(out, work, y,
                                                          y_work, n, k0);
      else
        update_kernel<false, RHS><<<grid, THREADS, 0, s>>>(out, work, y,
                                                           y_work, n, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

// a: (batch, n, n) f32 or bf16 (a_is_bf16); work, out: (batch, n, n) f32
// buffers from the caller.  Launches on `stream`; returns cudaGetLastError()
// as an int (0 = every launch was accepted).
extern "C" int sg_cholesky_rt(const void* a, int a_is_bf16, float* work,
                              float* out, int batch, int n, int bf16_updates,
                              void* stream) {
  return sweep<false>(a, a_is_bf16, work, out, nullptr, nullptr, batch, n,
                      bf16_updates, static_cast<cudaStream_t>(stream));
}

// As sg_cholesky_rt (the same launches, so R is bit-identical), then the
// inversion launch: dinv_t (batch, ceil(n / 128), 128, 128) f32.
extern "C" int sg_cholesky_rt_dinv(const void* a, int a_is_bf16, float* work,
                                   float* out, float* dinv_t, int batch,
                                   int n, int bf16_updates, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = sweep<false>(a, a_is_bf16, work, out, nullptr, nullptr, batch, n,
                        bf16_updates, s);
  if (rc != 0) return rc;
  const int smem = 2 * DM * (DM + 1) * (int)sizeof(float);  // 132,096 B
  cudaError_t err = cudaFuncSetAttribute(
      dinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dinv_kernel<<<dim3((n + DM - 1) / DM, batch), DM, smem, s>>>(out, dinv_t,
                                                               n);
  return (int)cudaGetLastError();
}

// a: (batch, n, n) f32, v: (batch, n) f32 -> x = a^-1 v (batch, n).  work,
// out: (batch, n, n) and y_work, y: (batch, n) f32 scratch from the caller.
extern "C" int sg_chol_solve(const float* a, const float* v, float* work,
                             float* out, float* y_work, float* y, float* x,
                             int batch, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(y_work, v, sizeof(float) * batch * n,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  int rc = sweep<true>(a, 0, work, out, y_work, y, batch, n, 0, s);
  if (rc != 0) return rc;
  backsub_kernel<<<batch, THREADS, 0, s>>>(out, y, x, n);
  return (int)cudaGetLastError();
}

// The panel height NB, so the host can check that its plain version groups
// the trailing updates the same way.
extern "C" int sg_cholesky_rt_nb() { return NB; }
