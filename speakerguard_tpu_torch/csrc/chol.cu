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
//      converted in the kernel.  1 <= N <= MAX_N (1780, below).
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
// 138 MB (0.041 ms at 3.35 TB/s).  The block inversions add 128^3/3 flops
// per full block and 21 MB of dinv_t; the right-hand side 2N^2 flops and 2N
// floats per matrix.  With one block per matrix, as below, only B of the
// 132 SMs work, and the trailing updates read and write the factor once per
// panel: at N = 600 that is 86.5 MFLOP on 64 x 64 tiles (~0.17 ms at one
// SM's f32 FMA peak) and 10.8 MB per matrix (0.69 GB for the batch, 0.21 ms
// at 3.35 TB/s), besides the chain of N pivot steps.
//
// Design: the sweep is one launch, grid (B), one 512-thread block per
// matrix.  A 600 x 600 f32 matrix is 1.44 MB, far more than the 227 KB of
// shared memory a block can use, so the factor lives in device memory (in
// `out`, updated in place: only the block that owns a matrix touches it) and
// the block runs a right-looking blocked sweep over it, with NB = 32-row
// panels and __syncthreads between the steps:
//
//   zero    R's strictly-lower triangle = 0.  Nothing copies A: the first
//           panel's steps read A (converting bf16) where later panels read
//           the factor, and y = v likewise for chol_solve.
//   for each panel of NB rows [k0, k1):
//     diag    warp 0 factors the NB x NB diagonal block, lane c holding
//             column c in registers, each pivot row broadcast through
//             shared memory; it keeps the factored block and 1/piv_j in
//             shared memory and writes the block to R.  Meanwhile the other
//             warps load their first stripe column.
//     stripe  each thread takes whole columns of the panel stripe (rows
//             k0:k1, columns k1:N; for chol_solve y[k0:k1] is one more
//             column) in registers and applies the pivot steps j = 0..p-1
//             in order: scale row j by 1/piv_j, subtract d[j][i] x_j from the
//             later rows.  No barrier inside.  The stripe goes to R and to
//             shared memory (bf16-rounded there with bf16_updates).
//     update  out[k1:, k1:] -= P^T P over the upper 64 x 64 tiles of the
//             trailing matrix, P read from the shared stripe as float4: each
//             half of the block (256 threads) walks every other tile with a
//             4 x 4 register micro-tile per thread.  A thread issues the
//             loads of its 16 entries of out (float4 rows inside the
//             triangle) before the tile's 512 FMAs and stores after them.
//             chol_solve: y[k1:] -= P^T y[k0:k1] first.
//
// Every element sees the same sequence of f32 operations as in the earlier
// multi-launch sweep and in ops/chol.py's plain version: the pivot steps in
// order, each trailing update summed over the panel's k in order and then
// subtracted.
//
// ptxas (nvcc 12.9, sm_90a): 128 registers a thread, the cap that 512
// threads leave; no spill in the f32 sweeps without v, 16 bytes with v, 172
// in the bf16-input ones.  Holding more in registers (the next tile's
// entries, a fully unrolled factorization of full panels, a 17th warp that
// factors the next panel's diagonal block during the update) spilled and
// ran slower on the card (tools/chol_sweep_phases.py times each step).
//
// Shared memory: the stripe NB x LD f32 (LD = N rounded up to 4, room for
// the widest stripe, N - NB columns, plus chol_solve's column), the
// diagonal block NB x NB, NB inverse pivots and two NB-float row buffers:
// 128 LD + 4480 bytes, at most 232,448, so MAX_N = 1780 (ops/chol.py checks
// N against it before a launch).
//
// Launches per call: cholesky_rt 1 (the sweep); cholesky_rt_dinv 2 (the
// sweep, then dinv_kernel); chol_solve 2 (the sweep, then backsub_kernel).
// The multi-launch sweep this replaces made 38, 39 and 39 at N = 600.
//
// cholesky_rt_dinv.  The TPU kernel appends an identity block that rides
// the row operations inside each 128-row outer block of its two-level
// sweep.  This sweep has no 128-row stage for it to ride (its NB-row
// panels update the whole trailing matrix), so the sweep runs exactly as
// for cholesky_rt (R bit-identical) and one more launch inverts the
// diagonal blocks of the finished R (dinv_kernel: a block per (128-block,
// matrix), D and X = inv(D) in 132 KB of dynamic shared memory).
//
// chol_solve.  As in the TPU kernel, v rides the sweep as one more column,
// so the sweep leaves y = R^-T v.  One more launch, a block per matrix,
// back-substitutes R x = y (backsub_kernel).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;       // panel rows (sequential pivot steps per panel)
constexpr int TILE = 64;     // trailing-update output tile edge
constexpr int SWEEP_THREADS = 512;  // two halves of 256, one tile each
constexpr int THREADS = 256;        // backsub_kernel
constexpr int DM = 128;      // diagonal-block edge of cholesky_rt_dinv
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
// the diagonal block NB x NB, its inverse pivots NB, two row buffers 2 NB
constexpr int FIXED_SMEM = (NB * NB + 3 * NB) * (int)sizeof(float);
// 1780; ops/chol.py MAX_N must agree (checked when the library loads)
constexpr int MAX_N = (SMEM_LIMIT - FIXED_SMEM) / (NB * 4) / 4 * 4;

__host__ __device__ constexpr int stripe_ld(int n) { return (n + 3) & ~3; }
constexpr int sweep_smem(int n) {
  return NB * stripe_ld(n) * (int)sizeof(float) + FIXED_SMEM;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements, 16-byte (f32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // one 8-byte load
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element i of A's upper triangle as f32 on the first panel (`first`),
// else element i of the factor being updated.
template <typename T>
__device__ __forceinline__ float entry(const T* a, const float* r, bool first,
                                       size_t i) {
  return first ? to_f32(a[i]) : r[i];
}

// dst[i] = src[i] for the float4 groups that hold an i >= from (the other
// entries are left unset); src 16-byte aligned.
__device__ __forceinline__ void load_row(float (&dst)[NB], const float* src,
                                         int from) {
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    if (4 * q + 3 >= from) {
      const float4 v4 = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = v4.x;
      dst[4 * q + 1] = v4.y;
      dst[4 * q + 2] = v4.z;
      dst[4 * q + 3] = v4.w;
    }
  }
}

// Warp 0's part of a panel: the p x p diagonal block at (k0, k0) (upper
// triangle, zeros elsewhere in the NB x NB frame), lane c holding column c
// in registers.  Pivot step j: every lane posts its row-j entry to a row
// buffer in shared memory (two, alternating, so one __syncwarp a step
// suffices), reads the whole row back as a broadcast, and scales it by
// 1/piv_j itself (the same product the owning lane forms).  Keeps 1/piv_j in
// ivs, leaves the factored block in d (NB x NB) for the stripe and writes it
// to r.
template <typename T>
__device__ void factor_diag(const T* a, float* r, bool first, float* d,
                            float* ivs, float* rowbuf, int n, int k0, int p,
                            int lane) {
  float x[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    x[i] = (i < p && lane < p && lane >= i)
               ? entry(a, r, first, (size_t)(k0 + i) * n + k0 + lane) : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < p) {
      float* row = rowbuf + (j & 1) * NB;
      row[lane] = x[j];
      __syncwarp();
      float dj[NB];
      load_row(dj, row, j);
      const float piv = sqrtf(dj[j]);
      const float inv = __frcp_rn(piv);  // == 1.f / piv, correctly rounded
      if (lane == j)
        x[j] = piv;
      else if (lane > j)
        x[j] *= inv;
      if (lane == 0) ivs[j] = inv;
#pragma unroll
      for (int i = j + 1; i < NB; ++i) {
        const float dji = dj[i] * inv;  // d[j][i], as lane i scaled it
        if (lane >= i) x[i] -= dji * x[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    d[i * NB + lane] = x[i];
    if (i < p && lane >= i && lane < p)
      r[(size_t)(k0 + i) * n + k0 + lane] = x[i];
  }
}

// One linear step through the upper tiles (tj >= ti) of an nt x nt grid,
// row by row; ti == nt past the last.
__device__ __forceinline__ void next_tile(int& ti, int& tj, int nt) {
  if (++tj == nt) {
    ++ti;
    tj = ti;
  }
}

// The whole sweep of one matrix per block (see the header).  The first
// panel reads A itself, so nothing copies A into out first.  RHS: v rides
// as one more column and the sweep leaves y = R^-T v in y.
template <typename T, bool BF16, bool RHS>
__global__ void __launch_bounds__(SWEEP_THREADS, 1)
sweep_kernel(const T* __restrict__ a, const float* __restrict__ v,
             float* __restrict__ out, float* __restrict__ y, int n) {
  extern __shared__ float4 smem4[];
  const int ld = stripe_ld(n);
  float* s = reinterpret_cast<float*>(smem4);  // stripe [NB][ld]
  float* d = s + NB * ld;    // the factored diagonal block [NB][NB]
  float* ivs = d + NB * NB;  // 1/piv_j
  float* rowbuf = ivs + NB;  // factor_diag's row buffers [2][NB]
  const size_t base = (size_t)blockIdx.x * n * n;
  const T* ab = a + base;
  float* r = out + base;
  const float* vb = RHS ? v + (size_t)blockIdx.x * n : nullptr;
  float* yb = RHS ? y + (size_t)blockIdx.x * n : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // R's strictly-lower triangle (no step reads it)
  for (int row = warp + 1; row < n; row += SWEEP_THREADS / 32)
    for (int c = lane; c < row; c += 32) r[(size_t)row * n + c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += NB) {
    const int p = min(NB, n - k0), k1 = k0 + p, m = n - k1;
    const bool first = k0 == 0;
    // column cc of the stripe, rows k0:k1; cc == m is y's (RHS), which is
    // v on the first panel
    auto load_col = [&](float (&x)[NB], int cc) {
      if (RHS && cc == m) {
#pragma unroll
        for (int i = 0; i < NB; ++i)
          x[i] = i < p ? (first ? vb[k0 + i] : yb[k0 + i]) : 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < NB; ++i)
          x[i] = i < p ? entry(ab, r, first,
                               (size_t)(k0 + i) * n + k1 + cc) : 0.f;
      }
    };
    const int w = m + (RHS ? 1 : 0);
    float x[NB];
    // in flight while warp 0 factors (warp 0 loads after: its registers go
    // to the factorization)
    if (warp != 0 && tid < w) load_col(x, tid);
    if (warp == 0)
      factor_diag(ab, r, first, d, ivs, rowbuf, n, k0, p, lane);
    __syncthreads();

    for (int cc = tid; cc < w; cc += SWEEP_THREADS) {
      const bool rhs = RHS && cc == m;
      if (cc != tid || warp == 0) load_col(x, cc);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < p) {
          x[j] *= ivs[j];
          float dj[NB];
          load_row(dj, d + j * NB, j + 1);
#pragma unroll
          for (int i = j + 1; i < NB; ++i) x[i] -= dj[i] * x[j];
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (i < p) {
          if (rhs)
            yb[k0 + i] = x[i];
          else
            r[(size_t)(k0 + i) * n + k1 + cc] = x[i];
          s[i * ld + cc] = BF16 && !rhs ? round_bf16(x[i]) : x[i];
        }
      }
    }
    if (m == 0) break;  // the last panel: nothing trails it
    __syncthreads();

    // p == NB from here: only the last panel is short, and it has m == 0
    if (RHS)
      for (int i = tid; i < m; i += SWEEP_THREADS) {
        float acc = 0.f;
        for (int k = 0; k < NB; ++k) acc += s[k * ld + i] * s[k * ld + m];
        yb[k1 + i] = (first ? vb[k1 + i] : yb[k1 + i]) - acc;
      }

    const int nt = (m + TILE - 1) / TILE;
    const int t = tid % 256, ty = t / 16, tx = t % 16;
    int ti = 0, tj = 0;
    if (tid >= 256) next_tile(ti, tj, nt);  // halves take every other tile
    // A thread's 4 x 4 block of a tile starts at (row0, c0).  A block
    // wholly inside the trailing upper triangle reads and writes it with
    // float4 when rows are aligned (N % 4 == 0 and A's pointer aligned to 4
    // elements; c0 is a multiple of 4); a block across the diagonal or past
    // N touches only its entries in the triangle (the others' sums are
    // discarded).
    const bool vec =
        (n & 3) == 0 && reinterpret_cast<uintptr_t>(a) % (4 * sizeof(T)) == 0;
    auto inside = [&](int row0, int c0) {
      return row0 + 3 < n && c0 + 3 < n && c0 >= row0 + 3;
    };
    auto load = [&](float (&dst)[4][4], int row0, int c0) {
      const size_t o = (size_t)row0 * n + c0;
      if (inside(row0, c0)) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 v4;
          if (vec)
            v4 = first ? load4(ab + o + (size_t)u * n)
                       : load4(r + o + (size_t)u * n);
          else
            v4 = make_float4(entry(ab, r, first, o + (size_t)u * n),
                             entry(ab, r, first, o + (size_t)u * n + 1),
                             entry(ab, r, first, o + (size_t)u * n + 2),
                             entry(ab, r, first, o + (size_t)u * n + 3));
          dst[u][0] = v4.x;
          dst[u][1] = v4.y;
          dst[u][2] = v4.z;
          dst[u][3] = v4.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[u][q] = (row0 + u < n && c0 + q < n && c0 + q >= row0 + u)
                            ? entry(ab, r, first, o + (size_t)u * n + q)
                            : 0.f;
      }
    };
    while (ti < nt) {
      const int row0 = k1 + ti * TILE + ty * 4, c0 = k1 + tj * TILE + tx * 4;
      float cur[4][4];
      load(cur, row0, c0);  // in flight during the tile's FMAs

      // stripe columns of this thread's rows and columns; a float4 past
      // the stripe's row (only past m, whose sums are discarded) reads
      // column 0 instead
      int ca = ti * TILE + ty * 4, cb = tj * TILE + tx * 4;
      if (ca >= ld) ca = 0;
      if (cb >= ld) cb = 0;
      float acc[4][4] = {};
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(s + k * ld + ca);
        const float4 b4 = *reinterpret_cast<const float4*>(s + k * ld + cb);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[u][q] += av[u] * bv[q];
      }
      const size_t o = (size_t)row0 * n + c0;
      if (inside(row0, c0)) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v4 = make_float4(
              cur[u][0] - acc[u][0], cur[u][1] - acc[u][1],
              cur[u][2] - acc[u][2], cur[u][3] - acc[u][3]);
          float* dst = r + o + (size_t)u * n;
          if (vec) {
            *reinterpret_cast<float4*>(dst) = v4;
          } else {
            dst[0] = v4.x;
            dst[1] = v4.y;
            dst[2] = v4.z;
            dst[3] = v4.w;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (row0 + u < n && c0 + q < n && c0 + q >= row0 + u)
              r[o + (size_t)u * n + q] = cur[u][q] - acc[u][q];
      }
      next_tile(ti, tj, nt);
      next_tile(ti, tj, nt);
    }
    __syncthreads();
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

// Launches the sweep kernel for A's type and the update mode, with its
// dynamic shared memory.  RHS: v -> y = R^-T v.
template <typename T, bool BF16, bool RHS>
int launch_sweep(const void* a, const float* v, float* out, float* y,
                 int batch, int n, cudaStream_t s) {
  const int smem = sweep_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<T, BF16, RHS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<T, BF16, RHS><<<batch, SWEEP_THREADS, smem, s>>>(
      static_cast<const T*>(a), v, out, y, n);
  return (int)cudaGetLastError();
}

int sweep(const void* a, int a_is_bf16, float* out, int batch, int n,
          int bf16_updates, cudaStream_t s) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  if (a_is_bf16)
    return bf16_updates
               ? launch_sweep<__nv_bfloat16, true, false>(a, nullptr, out,
                                                          nullptr, batch, n, s)
               : launch_sweep<__nv_bfloat16, false, false>(
                     a, nullptr, out, nullptr, batch, n, s);
  return bf16_updates
             ? launch_sweep<float, true, false>(a, nullptr, out, nullptr,
                                                batch, n, s)
             : launch_sweep<float, false, false>(a, nullptr, out, nullptr,
                                                 batch, n, s);
}

}  // namespace

// a: (batch, n, n) f32 or bf16 (a_is_bf16); out: (batch, n, n) f32 from
// the caller.  One launch on `stream`; returns cudaGetLastError() as an int
// (0 = the launch was accepted).
extern "C" int sg_cholesky_rt(const void* a, int a_is_bf16, float* out,
                              int batch, int n, int bf16_updates,
                              void* stream) {
  return sweep(a, a_is_bf16, out, batch, n, bf16_updates,
               static_cast<cudaStream_t>(stream));
}

// As sg_cholesky_rt (the same launch, so R is bit-identical), then the
// inversion launch: dinv_t (batch, ceil(n / 128), 128, 128) f32.
extern "C" int sg_cholesky_rt_dinv(const void* a, int a_is_bf16, float* out,
                                   float* dinv_t, int batch, int n,
                                   int bf16_updates, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = sweep(a, a_is_bf16, out, batch, n, bf16_updates, s);
  if (rc != 0) return rc;
  const int smem = 2 * DM * (DM + 1) * (int)sizeof(float);  // 132,096 B
  cudaError_t err = cudaFuncSetAttribute(
      dinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dinv_kernel<<<dim3((n + DM - 1) / DM, batch), DM, smem, s>>>(out, dinv_t,
                                                               n);
  return (int)cudaGetLastError();
}

// a: (batch, n, n) f32, v: (batch, n) f32 -> x = a^-1 v (batch, n).  out:
// (batch, n, n) and y: (batch, n) f32 scratch from the caller.  Two
// launches: the sweep (v -> y = R^-T v), then the back-substitution.
extern "C" int sg_chol_solve(const float* a, const float* v, float* out,
                             float* y, float* x, int batch, int n,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  int rc = launch_sweep<float, false, true>(a, v, out, y, batch, n, s);
  if (rc != 0) return rc;
  backsub_kernel<<<batch, THREADS, 0, s>>>(out, y, x, n);
  return (int)cudaGetLastError();
}

// The panel height NB, so the host can check that its plain version groups
// the trailing updates the same way.
extern "C" int sg_cholesky_rt_nb() { return NB; }

// The largest N the sweep's shared memory holds.
extern "C" int sg_cholesky_rt_max_n() { return MAX_N; }
