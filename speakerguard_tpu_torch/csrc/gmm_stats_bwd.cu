// The backward of the fused GMM Baum-Welch statistics on Hopper (sm_90a).
//
// Replaces speakerguard_tpu/ops/pallas_gmm_stats.py _stats_bwd (kernel
// _bwd_kernel): from the forward's bf16 posteriors posts16 and the
// cotangents dz (of zeroth) and df (of first),
//    dp = dz + x16 . bf16(df)^T,  dl = posts (dp - sum_c posts dp)  (f32),
//    daug = bf16(dl) . proj16^T   (bf16 operands, f32 accumulation),
//    dx = chain(daug[:, D:], x) + daug[:, :D] + posts16 . bf16(df),
// with posts = f32(posts16), x16 = bf16(x) and x unrounded in the chain.
// Bound at (B 64, T 300, D 72, C 2048; N = B T = 19200 rows, F = 2700):
//    2 N F C + 4 N C D = 224 GFLOP of bf16 products, 0.23 ms at 989
//    TFLOP/s (chip_smoke.py gmm_bounds); its own bytes (x, proj16, posts16,
//    dz, df, dx: ~138 MB) take 0.04 ms.
//
// The TPU kernel keeps daug (frames, F) in VMEM.  Here daug in f32 is ~216
// MB, so three launches on the N = B T flattened rows split the work and
// the product runs as the plain TMA + wgmma GEMM of wgmma_gemm.cuh:
//
//  1  dl_direct_kernel   a block per (utterance, 64 frames) sweeps C twice
//                        in 64-component chunks.  Sweep 1: the direct term
//                        posts16 . df16 on the tensor cores (WMMA bf16, each
//                        chunk summed from zero and added in f32 to
//                        accumulators held across the sweep, D padded to a
//                        multiple of 16) and pz = sum_c posts dz; then each
//                        row's sum_c posts dp = pz + x16 . direct (the same
//                        exact products as sum_c posts (dz + x16 . df16^T),
//                        summed over c first).  Sweep 2: dp = x16 . df16^T
//                        (WMMA) and bf16(dl) (N, ldc), ldc = round_up(C, 8),
//                        pad columns 0.  Every sum runs in a fixed order.
//                        df arrives as df16 (B, C, round_up(D, 16)) bf16
//                        with zero pad columns (the wrapper's copy, plain
//                        torch), so a chunk of it is whole 16-byte words.
//                        The next chunk's posts16, df16 and dz are loaded
//                        into registers while this one is computed.
//  2  daug_gemm_kernel   daug (N, ldf) f32 = bf16(dl) . proj16^T, ldf =
//                        round_up(F, 256), K = C: proj16 (F, C) as stored
//                        is the K-major B operand.  TMA fills rows >= N,
//                        rows >= F and columns >= C with zeros; the epilogue
//                        stores columns < F of rows < N.
//  3  chain_sum_kernel   a warp per row: copies the row's daug and x to
//                        shared memory (cp.async, all in flight at once),
//                        then each lane forms outputs i =
//                        lane, lane + 32, ...:  dx_i = daug_i + sum_j Q_ij
//                        x_j + Q_ii x_i + direct_i, Q the symmetric D x D
//                        matrix of the packed daug[D:], j in order.
//
// Moved on purpose beyond the function's own bytes: bf16(dl) written and
// read (2 x 79 MB at the main shape), posts16 read a second time (79 MB),
// daug written and read (2 x 216 MB), direct (2 x 5.5 MB), df16 (21 MB
// written, read from L2): ~0.7 GB, ~0.2 ms at 3.35 TB/s.  In return the
// 212 GFLOP product runs once on wgmma fed by TMA, and the chain rule is a
// pass over daug in a fixed order.
//
// Every C entry point returns cudaGetLastError() after its launch; a tensor
// map that cannot be encoded returns 10000 + its CUresult.

#include <mma.h>

#include "wgmma_gemm.cuh"

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// 1: bf16(dl) and the direct term.  Grid (T tiles of DL_ROWS, B).  Warp w
// owns the direct term's rows 16 (w / 2) .. + 15, its 16-column blocks
// w % 2, w % 2 + 2, ..., and dp's rows 16 (w / 2), columns 32 (w % 2) .. +
// 31 of a chunk.  Thread (m, q) = (tid / 4, tid % 4) owns row m, columns
// 16 q .. 16 q + 15 of each chunk for pz and dl.  VEC: 16-byte posts16
// loads (C % 8 == 0).
// ---------------------------------------------------------------------------
constexpr int DL_ROWS = 64;              // frames of a block
constexpr int DL_CHUNK = 64;             // components of a step
constexpr int DL_THREADS = 256;
constexpr int DL_PLD = DL_CHUNK + 8;     // bf16 leading dim of posts16
constexpr int DL_DLD = DL_CHUNK + 4;     // f32 leading dim of dp
constexpr int MAXF = 8;                  // NF = D_pad / 16 <= 8: D <= 128

size_t dl_smem(int nf) {
  const size_t dp = 16 * nf;
  size_t off = align_up(sizeof(bf16) * DL_ROWS * (dp + 8));     // x16
  off = align_up(off + sizeof(bf16) * DL_CHUNK * (dp + 8));     // df16
  off = align_up(off + sizeof(bf16) * DL_ROWS * DL_PLD);        // posts16
  off = align_up(off + sizeof(float) * DL_ROWS * DL_DLD);       // dp
  off = align_up(off + sizeof(float) * DL_ROWS * (dp + 4));     // direct
  return off + sizeof(float) * DL_CHUNK;                        // dz
}

// four bf16 posteriors from shared memory, in f32
__device__ __forceinline__ void load4(const bf16* p, float (&pv)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const bf16* pb = reinterpret_cast<const bf16*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) pv[e] = __bfloat162float(pb[e]);
}

// Three blocks an SM: 80 registers a thread, a 64-byte spill at D = 72.
// Two (128 registers, no spill) timed slower at the main shape on an H100
// SXM, measured with the direct term summed in one accumulator chain.
template <bool VEC, int NF>
__global__ void __launch_bounds__(DL_THREADS, 3)
dl_direct_kernel(const float* __restrict__ x, const bf16* __restrict__ posts16,
                 const float* __restrict__ dz, const bf16* __restrict__ df16,
                 bf16* __restrict__ dl16, int ldc,
                 float* __restrict__ direct, int t_len, int d, int c) {
  constexpr int DP = 16 * NF, XLD = DP + 8, SLD = DP + 4;
  constexpr int WORDS = DP / 8;  // 16-byte words of a df16 row
  constexpr int DF_PER = (DL_CHUNK * WORDS + DL_THREADS - 1) / DL_THREADS;
  constexpr int NB = (NF + 1) / 2;  // the warp's 16-column direct blocks
  extern __shared__ __align__(128) unsigned char smem[];
  size_t off = 0;
  bf16* xs = reinterpret_cast<bf16*>(smem + off);    // [DL_ROWS][XLD] x16
  off = align_up(off + sizeof(bf16) * DL_ROWS * XLD);
  bf16* dfs = reinterpret_cast<bf16*>(smem + off);   // [DL_CHUNK][XLD] df16
  off = align_up(off + sizeof(bf16) * DL_CHUNK * XLD);
  bf16* ps = reinterpret_cast<bf16*>(smem + off);    // [DL_ROWS][DL_PLD]
  off = align_up(off + sizeof(bf16) * DL_ROWS * DL_PLD);
  float* dps = reinterpret_cast<float*>(smem + off);  // [DL_ROWS][DL_DLD]
  off = align_up(off + sizeof(float) * DL_ROWS * DL_DLD);
  float* dst = reinterpret_cast<float*>(smem + off);  // [DL_ROWS][SLD]
  off = align_up(off + sizeof(float) * DL_ROWS * SLD);
  float* dzs = reinterpret_cast<float*>(smem + off);  // [DL_CHUNK]

  const int t0 = blockIdx.x * DL_ROWS, b = blockIdx.y;
  const size_t row0 = (size_t)b * t_len + t0;  // the block's first row
  const int n_rows = min(DL_ROWS, t_len - t0);
  const int tid = threadIdx.x, warp = tid / 32;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int i = tid; i < DL_ROWS * DP; i += DL_THREADS) {  // x16
    const int m = i / DP, k = i % DP;
    xs[m * XLD + k] = __float2bfloat16_rn(
        (m < n_rows && k < d) ? x[(row0 + m) * d + k] : 0.f);
  }

  // the next chunk's operands, held in registers while this one is computed
  uint4 pv[2], fv[DF_PER];
  float zv = 0.f;
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // 64 rows x 8 words of 8 posteriors
      const int i = tid + DL_THREADS * u;
      const int m = i / 8, n = (i % 8) * 8;
      pv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (m < n_rows) {
        const bf16* src = posts16 + (row0 + m) * c + c0 + n;
        if (VEC) {
          if (c0 + n < c) pv[u] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __align__(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = (c0 + n + e < c) ? src[e] : zero;
          pv[u] = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DF_PER; ++u) {  // DL_CHUNK rows x WORDS words
      const int i = tid + DL_THREADS * u, n = i / WORDS;
      fv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < DL_CHUNK * WORDS && c0 + n < c)
        fv[u] = __ldg(reinterpret_cast<const uint4*>(
                          df16 + ((size_t)b * c + c0 + n) * DP) +
                      i % WORDS);
    }
    zv = (tid < DL_CHUNK && c0 + tid < c) ? dz[(size_t)b * c + c0 + tid]
                                          : 0.f;
  };
  auto stage = [&]() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + DL_THREADS * u;
      *reinterpret_cast<uint4*>(ps + (i / 8) * DL_PLD + (i % 8) * 8) = pv[u];
    }
#pragma unroll
    for (int u = 0; u < DF_PER; ++u) {
      const int i = tid + DL_THREADS * u;
      if (i < DL_CHUNK * WORDS)
        *reinterpret_cast<uint4*>(dfs + (i / WORDS) * XLD + (i % WORDS) * 8) =
            fv[u];
    }
    if (tid < DL_CHUNK) dzs[tid] = zv;
  };

  const int rb = warp / 2;              // the warp's 16-row block
  const int m = tid / 4, q = tid % 4;   // the thread's row and quarter
  const int n_chunks = (c + DL_CHUNK - 1) / DL_CHUNK;
  const bf16* prow = ps + m * DL_PLD + 16 * q;
  const float* zrow = dzs + 16 * q;

  // sweep 1: direct = posts16 . df16 and pz = sum_c posts dz
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) wmma::fill_fragment(dacc[j], 0.f);
  float pz = 0.f;
  fetch(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();  // the previous chunk is consumed (and x16 written)
    stage();
    __syncthreads();
    fetch((ch + 1) % n_chunks * DL_CHUNK);  // the last fetches sweep 2's first
    // the chunk's 64 products summed on the tensor cores from zero, then
    // added in f32 to the running sum: one tensor-core accumulator chain
    // over all of C drifted past 2e-6 of the absolute terms
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int cb = warp % 2 + 2 * j;
      if (cb < NF) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cacc;
        wmma::fill_fragment(cacc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DL_CHUNK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa;
          wmma::load_matrix_sync(fa, ps + rb * 16 * DL_PLD + kk * 16,
                                 DL_PLD);
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, dfs + kk * 16 * XLD + cb * 16, XLD);
          wmma::mma_sync(cacc, fa, fb, cacc);
        }
#pragma unroll
        for (int e = 0; e < cacc.num_elements; ++e) dacc[j].x[e] += cacc.x[e];
      }
    }
    float part = 0.f;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float p4[4];
      load4(prow + 4 * h, p4);
      const float4 z4 = *reinterpret_cast<const float4*>(zrow + 4 * h);
      part += p4[0] * z4.x;
      part += p4[1] * z4.y;
      part += p4[2] * z4.z;
      part += p4[3] * z4.w;
    }
    // the quad's four partial sums, the same order in every lane
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    pz += part;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int cb = warp % 2 + 2 * j;
    if (cb < NF)
      wmma::store_matrix_sync(dst + rb * 16 * SLD + cb * 16, dacc[j], SLD,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < n_rows * d; i += DL_THREADS)
    direct[row0 * d + i] = dst[(i / d) * SLD + i % d];
  // s = sum_c posts dp = pz + x16 . direct (dp = dz + x16 . df16^T summed
  // over c first), k in order, by the quad's first lane
  float s = 0.f;
  if (q == 0) {
    s = pz;
    for (int k = 0; k < d; ++k)
      s += __bfloat162float(xs[m * XLD + k]) * dst[m * SLD + k];
  }
  s = __shfl_sync(0xffffffffu, s, (tid % 32) & ~3);

  // sweep 2: dl = posts (dz + x16 . df16^T - s), stored bf16
  const float* vrow = dps + m * DL_DLD + 16 * q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * DL_CHUNK;
    __syncthreads();  // the previous chunk is consumed
    stage();
    __syncthreads();
    if (ch + 1 < n_chunks) fetch(c0 + DL_CHUNK);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, xs + rb * 16 * XLD + kk * 16, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(
            fb, dfs + ((warp % 2) * 2 + j) * 16 * XLD + kk * 16, XLD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          dps + rb * 16 * DL_DLD + ((warp % 2) * 2 + j) * 16, acc[j], DL_DLD,
          wmma::mem_row_major);
    __syncthreads();  // dps is complete
    __align__(16) bf16 o[16];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float p4[4];
      load4(prow + 4 * h, p4);
      const float4 z4 = *reinterpret_cast<const float4*>(zrow + 4 * h);
      const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * h);
      o[4 * h] = __float2bfloat16_rn(p4[0] * ((z4.x + v4.x) - s));
      o[4 * h + 1] = __float2bfloat16_rn(p4[1] * ((z4.y + v4.y) - s));
      o[4 * h + 2] = __float2bfloat16_rn(p4[2] * ((z4.z + v4.z) - s));
      o[4 * h + 3] = __float2bfloat16_rn(p4[3] * ((z4.w + v4.w) - s));
    }
    if (m < n_rows) {
      bf16* out = dl16 + (row0 + m) * ldc + c0 + 16 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h)  // ldc % 8 == 0: a word is in or out
        if (c0 + 16 * q + 8 * h < ldc)
          *reinterpret_cast<uint4*>(out + 8 * h) =
              reinterpret_cast<const uint4*>(o)[h];
    }
  }
}

// ---------------------------------------------------------------------------
// 2: the daug GEMM (wgmma_gemm.cuh); its epilogue stores the f32 tile's
// columns < f of rows < rows (float2 where both columns are in).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GEMM_THREADS, 1)
daug_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ daug, int ldf, int rows, int f,
                 int k_tiles, int n_ct, int n_tiles) {
  auto epi = [=](float (&acc)[128], int row0, int n0, int, int q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < rows) {
        float* out = daug + (size_t)row * ldf;
#pragma unroll
        for (int j = 0; j < GN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q;
          if (col + 1 < f)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          else if (col < f)
            out[col] = acc[4 * j + 2 * h];
        }
      }
    }
  };
  gemm_persistent(&map_a, &map_b, k_tiles, n_ct, n_tiles, epi);
}

// ---------------------------------------------------------------------------
// 3: the chain rule and the sum.  A warp per row, CH_WARPS rows a block.
// Q_ij = daug[D + p(min(i, j), max(i, j))], p(r, c) = off(r) + c - r with
// off(r) = r D - r (r - 1) / 2 the packed index of (r, r) (np.triu_indices
// order); chain_plain adds dq_(r,r) x_r twice, hence the second Q_ii x_i.
// ---------------------------------------------------------------------------
constexpr int CH_WARPS = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__host__ __device__ __forceinline__ int round4(int v) {
  return (v + 3) / 4 * 4;
}

__global__ void __launch_bounds__(CH_WARPS * 32)
chain_sum_kernel(const float* __restrict__ daug, int ldf,
                 const float* __restrict__ x,
                 const float* __restrict__ direct, float* __restrict__ dx,
                 int rows, int d) {
  extern __shared__ __align__(16) float cs[];
  const int f = d + d * (d + 1) / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * CH_WARPS + warp;
  if (row >= rows) return;
  float* xr = cs + warp * (round4(d) + round4(f));  // [d]
  float* qr = xr + round4(d);                        // [f] the daug row
  // every copy in flight at once, none through registers
  const float* src = daug + (size_t)row * ldf;       // ldf % 4 == 0
  for (int i = lane; i < f / 4; i += 32) cp_async16(qr + 4 * i, src + 4 * i);
  for (int i = f / 4 * 4 + lane; i < f; i += 32) cp_async4(qr + i, src + i);
  for (int i = lane; i < d; i += 32)
    cp_async4(xr + i, x + (size_t)row * d + i);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  const float* qq = qr + d;
  for (int i = lane; i < d; i += 32) {
    const int offi = i * d - i * (i - 1) / 2;
    float acc = 0.f;
    int offj = 0;
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      acc += qq[j < i ? offj + i - j : offi + j - i] * xr[j];
      offj += d - j;
    }
    acc += qq[offi] * xr[i];
    const size_t o = (size_t)row * d + i;
    dx[o] = (qr[i] + acc) + direct[o];
  }
}

}  // namespace

// 1.  x (b, t, d) f32, posts16 (b, t, c) bf16, dz (b, c) f32, df16 (b, c,
// round_up(d, 16)) bf16 (bf16(df), pad columns 0) -> dl16 (b t, ldc) bf16
// (ldc a multiple of 8, >= c; columns >= c are 0) and direct (b t, d) f32.
// d <= 128.
extern "C" int sg_stats_bwd_dl(const float* x, const void* posts16,
                               const float* dz, const void* df16, void* dl16,
                               int ldc, float* direct, int b, int t, int d,
                               int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 16 * MAXF || ldc % 8 != 0 || ldc < c)
    return (int)cudaErrorInvalidValue;
  typedef void (*Kernel)(const float*, const bf16*, const float*,
                         const bf16*, bf16*, int, float*, int, int, int);
  static const Kernel kernels[2][MAXF] = {
      {dl_direct_kernel<false, 1>, dl_direct_kernel<false, 2>,
       dl_direct_kernel<false, 3>, dl_direct_kernel<false, 4>,
       dl_direct_kernel<false, 5>, dl_direct_kernel<false, 6>,
       dl_direct_kernel<false, 7>, dl_direct_kernel<false, 8>},
      {dl_direct_kernel<true, 1>, dl_direct_kernel<true, 2>,
       dl_direct_kernel<true, 3>, dl_direct_kernel<true, 4>,
       dl_direct_kernel<true, 5>, dl_direct_kernel<true, 6>,
       dl_direct_kernel<true, 7>, dl_direct_kernel<true, 8>}};
  const int nf = (d + 15) / 16;
  const size_t smem = dl_smem(nf);
  const Kernel kernel = kernels[c % 8 == 0][nf - 1];
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + DL_ROWS - 1) / DL_ROWS, b);
  kernel<<<grid, DL_THREADS, smem, s>>>(
      x, static_cast<const bf16*>(posts16), dz,
      static_cast<const bf16*>(df16), static_cast<bf16*>(dl16), ldc, direct,
      t, d, c);
  return (int)cudaGetLastError();
}

// 2.  dl16 (rows, c) bf16 with row stride ldc, proj (f, c) bf16 with row
// stride ldp (both multiples of 8) -> daug (rows, ldf) f32, columns < f
// written (ldf even, >= f).
extern "C" int sg_stats_bwd_daug(const void* dl16, int ldc, const void* proj,
                                 int ldp, float* daug, int ldf, int rows,
                                 int c, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ldc % 8 != 0 || ldp % 8 != 0 || ldf % 2 != 0 || ldf < f)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, dl16, rows, c, ldc, GM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, proj, f, c, ldp, GN);
  if (rc != 0) return rc;
  const int n_ct = (f + GN - 1) / GN;
  const int n_tiles = n_ct * ((rows + GM - 1) / GM);
  return launch_gemm(daug_gemm_kernel, n_tiles, s, map_a, map_b, daug, ldf,
                     rows, f, (c + GK - 1) / GK, n_ct, n_tiles);
}

// 3.  daug (rows, ldf) f32 (ldf % 4 == 0, columns < d + d(d+1)/2 read),
// x (rows, d) f32, direct (rows, d) f32 -> dx (rows, d) f32.
extern "C" int sg_stats_bwd_chain(const float* daug, int ldf, const float* x,
                                  const float* direct, float* dx, int rows,
                                  int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = d + d * (d + 1) / 2;
  if (ldf % 4 != 0 || ldf < f) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * CH_WARPS * (round4(d) + round4(f));
  cudaError_t err = prepare(chain_sum_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  chain_sum_kernel<<<(rows + CH_WARPS - 1) / CH_WARPS, CH_WARPS * 32, smem,
                     s>>>(daug, ldf, x, direct, dx, rows, d);
  return (int)cudaGetLastError();
}
