// The persistent TMA + wgmma GEMM of the GMM kernels on Hopper (sm_90a),
// shared by csrc/gmm_stats_fwd.cu (the loglike GEMM), csrc/gmm_stats_bwd.cu
// (the daug GEMM) and csrc/gmm.cu (fused_loglike's six-product split GEMM).
//
//    out (rows, n) = A (rows, K) . B (n, K)^T, bf16 operands, f32 accumulation
//
// with A and B both K-major (K contiguous) and read through 2-D tensor maps
// (``make_map``).  A 128 x 256 output tile at a time (GemmWide, the default),
// a persistent block per SM: one producer warp keeps TMA loads of A 128 x 64
// and B 256 x 64 (128-byte swizzle) in flight in a ring of 4 stages (48 KB
// each), running ahead into the next tile during the epilogue; two consumer
// warpgroups issue wgmma m64n256k16 from shared memory, 128 f32 accumulators
// a thread; setmaxnreg moves registers from producer to consumers.
// A kernel may bring its own plan (GemmShape): several boxes of A and B a
// stage and several products on them, 128 x 128 tiles, and a partial sum
// per stage that f32 adds promote into a second accumulator, for sums that
// must hold f32 accuracy over many k-tiles.  The n tiles of
// one row tile are neighbours in tile order, so the A row tile is read from
// L2.  TMA fills rows and K columns past a map's extent with zeros, so
// ragged edges need no masks in the main loop; the epilogue, which each
// kernel supplies, masks its stores.
//
// Each kernel is ``gemm_persistent`` with its own epilogue functor, called
// once per tile and consumer thread as
//    epi(acc, row0, n0, ct, q)
// where acc[4 j + e] (j < BN / 8, e < 4) is row row0 + 8 (e / 2), column n0 +
// 8 j + 2 q + e % 2 of the output (the wgmma D-fragment layout: row 16 w +
// l / 4 + 8 (e / 2) of the warpgroup's 64 rows for warp w, lane l, and q =
// l % 4, so the four lanes of a quad share two rows), and ct is the n tile.
// The plan (GemmWide by default) says which columns of A and B a stage
// loads and which products it runs on them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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

constexpr int GM = 128;                    // rows of an output tile
constexpr int GN = 256;                    // columns (GemmWide): one n256
constexpr int GK = 64;                     // K of a stage: a 128-byte row
constexpr int STAGES = 4;                  // (GemmWide)
constexpr int A_BYTES = GM * GK * 2;       // 16 KB
constexpr int GEMM_THREADS = 384;          // consumers 0-255, producer 256-383
constexpr int CONSUMER_WARPS = 8;

// A GEMM's plan: its tile, its ring, and what a stage holds.  A stage holds
// PIECES boxes of A (GM x GK) and as many of B (BN x GK), box p of k-tile
// kt read from column plan.col(kt, p) of each operand, and runs PRODUCTS
// products: product i multiplies A box product(i).x by B box product(i).y.
// PROMOTE: each consumer thread keeps two f32 accumulators of BN / 2; a
// stage's products go into a partial sum that the tensor cores start from
// zero, which is then added into the tile's total with f32 adds
// (round-to-nearest), so the tensor cores' own accumulation sums only one
// stage's terms and its rounding error stays at that scale, not the whole
// sum's.  Without it every product adds into one accumulator.
template <int BN_, int NST_, int PIECES_, int PRODUCTS_, bool PROMOTE_>
struct GemmShape {
  static constexpr int BN = BN_;          // columns of a tile: one wgmma n
  static constexpr int NST = NST_;        // stages of the TMA ring
  static constexpr int PIECES = PIECES_;
  static constexpr int PRODUCTS = PRODUCTS_;
  static constexpr bool PROMOTE = PROMOTE_;
  static constexpr int B_BYTES = BN * GK * 2;
  static constexpr int B_OFF = PIECES * A_BYTES;  // the A boxes, then B's
  static constexpr int STAGE = PIECES * (A_BYTES + B_BYTES);
  // 1024 bytes of slack to align the stages (128-byte swizzle atoms), the
  // stages, and the full / empty barriers
  static constexpr size_t SMEM =
      1024 + (size_t)NST * STAGE + 2 * NST * sizeof(uint64_t);
};

// The default plan: 128 x 256 tiles (wgmma m64n256k16), 4 stages of 48 KB,
// k-tile kt is columns kt * GK .. kt * GK + GK - 1 of A and B, one product
// a stage into one accumulator of 128 registers a consumer thread.
struct GemmWide : GemmShape<GN, STAGES, 1, 1, false> {
  __device__ __forceinline__ int col(int kt, int) const { return kt * GK; }
  __device__ __forceinline__ static int2 product(int) {
    return make_int2(0, 0);
  }
};

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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16, K-major) . B (128 x 16, K-major)^T, plus
// d itself unless ``add`` is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(add));
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

// The body of a GEMM kernel launched with GEMM_THREADS threads and
// Plan::SMEM bytes of dynamic shared memory (``launch_gemm<Plan>``).
// Persistent: a block walks the output tiles tile = blockIdx.x, +
// gridDim.x, ...; tile t is n tile t % n_ct of row tile t / n_ct.  The
// producer runs ahead across tiles: it loads the next tile's stages while
// the consumers run this one's epilogue.  k_tiles counts stages a tile.
template <class Plan = GemmWide, class Epilogue>
__device__ __forceinline__ void gemm_persistent(const CUtensorMap* map_a,
                                                const CUtensorMap* map_b,
                                                int k_tiles, int n_ct,
                                                int n_tiles, Epilogue& epi,
                                                Plan plan = Plan()) {
  constexpr int NST = Plan::NST, BN = Plan::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NST * Plan::STAGE);
  uint64_t* empty = full + NST;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
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
        const int n0 = (tile % n_ct) * BN, m0 = (tile / n_ct) * GM;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * Plan::STAGE;
          mbar_expect_tx(&full[s], Plan::STAGE);
#pragma unroll
          for (int p = 0; p < Plan::PIECES; ++p) {
            const int k = plan.col(kt, p);
            tma_load_2d(st + p * A_BYTES, map_a, &full[s], k, m0);
            tma_load_2d(st + Plan::B_OFF + p * Plan::B_BYTES, map_b,
                        &full[s], k, n0);
          }
          if (++s == NST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int ct = tile % n_ct;
      const int n0 = ct * BN, m0 = (tile / n_ct) * GM;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if constexpr (!Plan::PROMOTE) {
        // one group of products stays in flight while the next stage's are
        // issued; a stage is released once the group that read it is done
        int prev = -1;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&full[s], phase);
          const unsigned char* st = smem + s * Plan::STAGE;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < Plan::PRODUCTS; ++i) {
            const int2 pr = Plan::product(i);
            const uint64_t da =
                sw128_desc(st + pr.x * A_BYTES + wg * (64 * GK * 2));
            const uint64_t db =
                sw128_desc(st + Plan::B_OFF + pr.y * Plan::B_BYTES);
#pragma unroll
            for (int kk = 0; kk < GK / 16; ++kk)
              wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk);
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_acc(acc);
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = s;
          if (++s == NST) {
            s = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);
      } else {
        // the stage's partial sum: its first product overwrites it; once
        // the stage's products are done it is released and part is added
        // into acc
        float part[BN / 2];
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&full[s], phase);
          const unsigned char* st = smem + s * Plan::STAGE;
          fence_acc(part);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < Plan::PRODUCTS; ++i) {
            const int2 pr = Plan::product(i);
            const uint64_t da =
                sw128_desc(st + pr.x * A_BYTES + wg * (64 * GK * 2));
            const uint64_t db =
                sw128_desc(st + Plan::B_OFF + pr.y * Plan::B_BYTES);
#pragma unroll
            for (int kk = 0; kk < GK / 16; ++kk)
              wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk, i + kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(part);
          if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          if (++s == NST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      epi(acc, m0 + wg * 64 + warp * 16 + (lane >> 2), n0, ct, lane & 3);
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

// The first ncols columns of a row-major bf16 matrix (nrows, ld) as GK x
// box_rows boxes in 128-byte swizzle; rows past nrows and columns past
// ncols read as zeros.  ld * 2 bytes must be a multiple of 16.  Returns 0
// or 10000 + the CUresult.
int make_map(CUtensorMap* map, const void* ptr, int nrows, int ncols, int ld,
             int box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)ncols, (cuuint64_t)nrows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// Launches ``kernel`` (a gemm_persistent<Plan> body) on min(n_tiles, SMs)
// blocks with the arguments ``args``; returns cudaGetLastError().
template <class Plan = GemmWide, class K, class... Args>
int launch_gemm(K kernel, int n_tiles, cudaStream_t s, Args... args) {
  cudaError_t err = prepare(kernel, Plan::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles < sms ? n_tiles : sms, GEMM_THREADS, Plan::SMEM, s>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace
