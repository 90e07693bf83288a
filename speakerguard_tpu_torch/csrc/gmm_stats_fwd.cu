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
//                           over the columns < C.  A 128 x 256 output tile
//                           at a time, a persistent block per SM: one
//                           producer warp keeps TMA loads of A 128 x 64 and
//                           B 256 x 64 (128-byte swizzle) in flight in a ring
//                           of 4 stages (48 KB each), running ahead into the
//                           next tile during the epilogue; two consumer
//                           warpgroups issue wgmma m64n256k16 from shared
//                           memory, 128 f32 accumulators a thread;
//                           setmaxnreg moves registers from producer to
//                           consumers.  The C tiles of one row tile are
//                           neighbours in tile order, so the A row tile is
//                           read from L2.  TMA fills rows >= N
//                           and columns >= C with zeros; they are left out
//                           of the partials and of the stores that matter
//                           (ld = round_up(C, 256), columns >= C are scratch).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ __forceinline__ size_t align_up(size_t v) {
  return (v + 127) / 128 * 128;
}

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
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
// 2: the loglike GEMM on TMA + wgmma.
// ---------------------------------------------------------------------------
constexpr int GM = 128;                    // rows of an output tile
constexpr int GN = 256;                    // columns: one wgmma n256
constexpr int GK = 64;                     // K of a stage: a 128-byte row
constexpr int STAGES = 4;
constexpr int A_BYTES = GM * GK * 2;       // 16 KB
constexpr int B_BYTES = GN * GK * 2;       // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int GEMM_THREADS = 384;          // consumers 0-255, producer 256-383
constexpr int CONSUMER_WARPS = 8;
// 1024 bytes of slack to align the stages (128-byte swizzle atoms), the
// stages, and the full / empty barriers
constexpr size_t GEMM_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                             2 * STAGES * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// returns once the phase of parity ``parity`` has completed; a wait of
// 2^24 polls (seconds, where a real one takes microseconds) traps, so a
// pipeline fault ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && ++polls == (1u << 24)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// box at (column c0, row c1) of a 2-D map into dst; completes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (the stride byte offset); the leading
// byte offset is unused in this layout.  Adding 2 advances 32 bytes (16
// bf16 of K) inside the atom.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, K-major) . B (256 x 16, K-major)^T
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Persistent: a block per SM walks the output tiles tile = blockIdx.x,
// + gridDim.x, ...; tile t is C tile t % n_ct of row tile t / n_ct, so the
// C tiles of a row tile run side by side and its A rows come from L2.  The
// producer runs ahead across tiles: it loads the next tile's stages while
// the consumers finish this one's epilogue.  Consumer warpgroup wg owns rows
// m0 + 64 wg .. + 63.  Its accumulator d[4 j + e] (j < 32, e < 4) of thread
// (warp w, lane l) is row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4)
// + e % 2 of the warpgroup's 64 x 256 tile: the four lanes l / 4 alike
// share two rows.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
loglike_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const float* __restrict__ gconsts,
                    float* __restrict__ loglike, float* __restrict__ part,
                    int rows, int c, int k_tiles, int n_ct, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int ld = n_ct * GN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx
      mbar_init(&empty[s], CONSUMER_WARPS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n0 = (tile % n_ct) * GN, m0 = (tile / n_ct) * GM;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(st, &map_a, &full[s], kt * GK, m0);
          tma_load_2d(st + A_BYTES, &map_b, &full[s], kt * GK, n0);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int q = lane & 3;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int ct = tile % n_ct;
      const int n0 = ct * GN, m0 = (tile / n_ct) * GM;
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      // one group of products stays in flight while the next stage's are
      // issued; a stage is released once the group that read it is done
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[s], phase);
        const unsigned char* st = smem + s * STAGE_BYTES;
        const uint64_t da = sw128_desc(st + wg * (64 * GK * 2));
        const uint64_t db = sw128_desc(st + A_BYTES);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk)
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue: + gconsts, the row partials over columns < c, the stores
      const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
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
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (nrows, f_pad) row-major bf16 matrix as GK x box_rows boxes in
// 128-byte swizzle; rows past nrows read as zeros.  0 or 10000 + CUresult.
int make_map(CUtensorMap* map, const void* ptr, int nrows, int f_pad,
             int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)f_pad, (cuuint64_t)nrows};
  const cuuint64_t strides[1] = {(cuuint64_t)f_pad * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
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
  int rc = make_map(&map_a, aug16, rows, f_pad, GM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, projk, c, f_pad, GN);
  if (rc != 0) return rc;
  cudaError_t err = prepare(loglike_gemm_kernel, GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (c + GN - 1) / GN;
  const int n_tiles = n_ct * ((rows + GM - 1) / GM);
  loglike_gemm_kernel<<<n_tiles < sms ? n_tiles : sms, GEMM_THREADS,
                        GEMM_SMEM, s>>>(map_a, map_b, gconsts, loglike, part,
                                        rows, c, f_pad / GK, n_ct, n_tiles);
  return (int)cudaGetLastError();
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
