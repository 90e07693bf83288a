// The TDNN's bf16 fast block on Hopper (sm_90a): one dilated convolution
// as an implicit GEMM, forward and input gradient, with the block's own
// elementwise steps fused around the product.
//
// Replaces no TPU kernel: the JAX package leaves the TDNN's convolutions
// (speakerguard_tpu/models/tdnn.py _block_fast_bf16) to XLA.  Added because
// the port's im2col path spent most of the TDNN's time outside its GEMMs:
// k shifted copies of each activation side by side, and a float32 pass for
// each of the bias, the ReLU mask, the BN and each bf16 rounding, forward
// and backward.
//
// What bounds it: the products.  At the x-vector's shapes (512 waves x 300
// frames, 30-512-512-512-512-1500 channels, taps 5, 5, 7, 1, 1) the five
// layers are 1.2 TFLOP a direction, 1.2 ms at 989 TFLOP/s; their own bytes
// (input, weights, output) take ~0.2 ms at 3.35 TB/s, and only layer 1 (30
// input channels) is bound by its bytes.  So the design keeps every byte
// but the operands off the device memory and feeds wgmma from TMA:
//
//  - Layout.  An activation is the first T rows of each utterance of a
//    (B, Ts, ld) row-major bf16 buffer: flat row r = b Ts + t, ld >= C a
//    multiple of 8.  Every layer keeps the row stride Ts of the network's
//    input, so output row r of tap j reads input row r + j dil, one 2-D TMA
//    box of the flat rows: the taps are read in place, never copied.  Rows
//    t >= T_out of an utterance are junk that no valid output reads; they
//    are never stored, and their ReLU mask is written 0.
//  - Main loop: the persistent TMA + wgmma GEMM of wgmma_gemm.cuh, written
//    out here with a ring of its own (its primitives shared, the header
//    unchanged): a 128 x 256 output tile, K runs over (tap, 64-channel
//    block), the A box of tap j at row offset j dil (forward) or j dil -
//    (k - 1) dil (backward: the taps reversed in the packed weights).  TMA
//    fills rows and channels outside the operand with zeros, which replaces
//    the backward's F.pad and the pad columns of layer 1 (30 channels).
//  - Forward epilogue, on the f32 tile, in _BlockFastBf16's order and at its
//    rounding points: y = f32(bf16(sum)) + bias; m = y > 0 (0 on junk
//    rows); out = bf16(((m ? y : 0) - mean) s) with s = rsqrt(var + eps)
//    as torch computes it, stored 16 bytes a thread after a transpose in
//    the quad; the mask is stored as bits, one byte per row and 8
//    channels, so the backward reads 8 bytes a row and k-tile.
//  - Backward prologue: the A operand gy = bf16(m ? f32(g) s : 0) is formed
//    in registers from the TMA-loaded g tile (ldmatrix), the mask bits and
//    s, then fed to a register-A wgmma: no pass of its own.  Junk rows and
//    rows outside the operand have mask 0, so gy is exactly 0 there
//    whatever g holds.  Epilogue: bf16(sum), stored for valid rows and the
//    layer's real input channels (30 on layer 1, in a 64-column tile).
//    ptxas serialises register-A products whose registers are written
//    while an earlier group is in flight, so each k-tile's transform waits
//    for the previous products: the other consumer warpgroup's products
//    fill that time, but the backward runs below the forward's rate.
//
// ECAPA-TDNN's blocks (models/ecapa.py) take the same kernels in a second
// form, its epilogue compiled apart (the AFFINE template flag), so the
// x-vector's launches run the code above unchanged:
//
//  - "same" convolutions with reflect padding need nothing of the kernels:
//    the wrapper gathers the input into Ts = T + 2 P rows an utterance, P =
//    (k - 1) dil / 2, its P rows at each end the reflected rows, and runs
//    the valid convolution of that (T_out = T); the backward's T_in = Ts
//    rows are the padded input's cotangent, whose 2 P edge rows the
//    wrapper folds back onto the rows they reflect.
//  - BN with an affine part: the epilogue computes out = bf16(r a + c)
//    (r = m ? y : 0, a = s gamma, c = beta - mean a: an f32 product, then
//    an f32 add) in place of bf16((r - mean) s); the backward's scale is a.
//  - 128-column tiles (wgmma n128) where the output has at most 128
//    columns: the Res2 branches (C_out = C_in = 128) and the attentive
//    pooling's first layer (4608 -> 128) forward, the Res2 branches and the
//    first layer (80 input channels) backward.
//
// Every C entry point returns cudaGetLastError() after its launch; a tensor
// map that cannot be encoded returns 10000 + its CUresult.

#include "wgmma_gemm.cuh"

namespace {

constexpr int TM = GM;                        // rows of an output tile
constexpr int TN = GN;                        // columns of an output tile
constexpr int TK = GK;                        // channels of a k-tile
constexpr int NST = STAGES;                   // stages of the TMA ring
constexpr int NARROW = 64;                    // the backward's tile for C_in <= 64
constexpr int HALF = 128;                     // the tile for <= 128 columns
constexpr int MAX_SMEM = 232448;

// The stage ring of a tile BN columns wide: a stage holds the A box (TM x
// TK), then the B box (BN x TK); 1024 bytes of slack to align the stages,
// the stages, the full / empty barriers, then the epilogue's vectors.
template <int BN>
struct Ring {
  static constexpr int STAGE = A_BYTES + BN * TK * 2;
  static constexpr int FIXED = 1024 + NST * STAGE + 2 * NST * 8;
};

// One launch: the output (rows, n) = sum over taps j and channel blocks of
// A rows (r + a_shift + j dil) . B (the packed weights) in f32.
struct ConvArgs {
  int rows;       // output rows (flat, in the Ts layout)
  int ts;         // rows an utterance
  int t_valid;    // rows of an utterance that are stored: T_out / T_in
  int n;          // output columns: C_out forward, C_in backward
  int dil;        // dilation
  int a_shift;    // row offset of tap 0 in A: 0 forward, -(k-1) dil backward
  int n_cb;       // 64-channel blocks a tap
  int k_tiles;    // taps x n_cb
  int n_ct;       // column tiles (BN wide)
  int n_tiles;    // row tiles x n_ct
  bf16* out;      // (rows, out_ld) bf16
  int out_ld;
  uint8_t* mask;  // forward: written; backward: read; (mask_rows, mask_ld)
  int mask_ld;    // bytes a row, a multiple of 8
  int mask_rows;  // backward: rows of g and of the mask
  const float* vecs;  // forward: bias, mean, s (AFFINE: bias, c, a), each
                      // vec_len; backward: s (a)
  int vec_len;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// gy of two neighbouring channels: w holds two bf16 of g (low half the even
// channel), bits their mask bits, s their BN scales
__device__ __forceinline__ uint32_t scale_mask(uint32_t w, uint32_t bits,
                                               float2 s) {
  const float lo = (bits & 1u) ? __fmul_rn(__uint_as_float(w << 16), s.x)
                               : 0.f;
  const float hi = (bits & 2u)
                       ? __fmul_rn(__uint_as_float(w & 0xFFFF0000u), s.y)
                       : 0.f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 8 mask bytes (64 channels) of row r in channel block cb; 0 outside
// the mask's rows
__device__ __forceinline__ uint64_t mask_word(const ConvArgs& p, int r,
                                              int cb) {
  if (r < 0 || r >= p.mask_rows) return 0ull;
  return __ldg(reinterpret_cast<const unsigned long long*>(
      p.mask + (size_t)r * p.mask_ld + cb * 8));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers: the four 32-bit
// words of the thread's mma.m16n8k16 A fragment in its warp's 16 rows) .
// B (256 x 16, K-major in shared memory)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (128 x 16,
// K-major in shared memory)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x BN, f32) += A (64 x 16) . B (BN x 16)^T, both K-major in shared
// memory: the forward's products in a 256- or 128-column tile
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  wgmma_m64n256k16(d, da, db);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  wgmma_m64n128k16(d, da, db, 1);
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (64 x 16,
// K-major in shared memory)^T
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// w[k] for a k known only at run time, without local memory
__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int k) {
  return k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
}

// The forward epilogue of one consumer thread's rows row0 and row0 + 8
// (acc in wgmma_gemm.cuh's D-fragment layout: thread q = lane % 4 of a quad
// holds columns 8 j + 2 q, + 1 of each group j of 8).  Four groups at a
// time, the quad transposes its 4 x 4 words so that thread q holds group
// 4 j4 + q whole and stores it as 16 bytes; each mask word (32 channels of
// a row) is gathered across the quad, and thread q stores words q and
// q + 4 of the tile's 8 a row (of a 128-column tile's 4, word q).  A group
// past C_out but inside the row stride writes pad columns, which nothing
// reads.  AFFINE: the BN is out = bf16(r a + c) with (mean, s) holding
// (c, a).
template <int BN, bool AFFINE>
__device__ __forceinline__ void fwd_epilogue(const ConvArgs& p,
                                             const float* vec,
                                             float (&acc)[BN / 2], int row0,
                                             int n0, int q) {
  const float* bias = vec;
  const float* mean = vec + p.vec_len;
  const float* scale = vec + 2 * p.vec_len;
  const int quad = (threadIdx.x & 31) & ~3;
  bool in[2], live[2];
  bf16* orow[2];
  uint32_t* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    in[h] = r < p.rows;
    live[h] = in[h] && (r % p.ts) < p.t_valid;
    orow[h] = p.out + (size_t)r * p.out_ld;
    mrow[h] = reinterpret_cast<uint32_t*>(p.mask + (size_t)r * p.mask_ld +
                                          n0 / 8);
  }
#pragma unroll
  for (int j4 = 0; j4 < BN / 32; ++j4) {
    uint32_t word[2] = {0u, 0u};
    uint32_t w[2][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * j4 + jj;
      const int c = n0 + 8 * j + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      const float2 mm = *reinterpret_cast<const float2*>(mean + c);
      const float2 ss = *reinterpret_cast<const float2*>(scale + c);
      const bool c0 = c < p.n, c1 = c + 1 < p.n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the conv's f32 sums rounded once to bf16, then the bias in f32
        const __nv_bfloat162 y16 = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        const float y0 = __fadd_rn(__low2float(y16), bb.x);
        const float y1 = __fadd_rn(__high2float(y16), bb.y);
        const bool m0 = live[h] && c0 && y0 > 0.f;
        const bool m1 = live[h] && c1 && y1 > 0.f;
        __nv_bfloat162 o;
        if constexpr (AFFINE)
          o = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(m0 ? y0 : 0.f, ss.x), mm.x),
              __fadd_rn(__fmul_rn(m1 ? y1 : 0.f, ss.y), mm.y));
        else
          o = __floats2bfloat162_rn(
              __fmul_rn(__fsub_rn(m0 ? y0 : 0.f, mm.x), ss.x),
              __fmul_rn(__fsub_rn(m1 ? y1 : 0.f, mm.y), ss.y));
        w[h][jj] = *reinterpret_cast<const uint32_t*>(&o);
        word[h] |= ((uint32_t)m0 | ((uint32_t)m1 << 1)) << (8 * jj + 2 * q);
      }
    }
    const int c8 = n0 + 8 * (4 * j4 + q);  // the group this thread stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // thread q gathers word q of each thread of the quad: in round k it
      // sends its word (q + k) % 4 and receives from thread (q - k) % 4
      uint32_t g[4];
      g[0] = pick4(w[h], q);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        g[k] = __shfl_sync(0xFFFFFFFFu, pick4(w[h], (q + k) & 3),
                           quad + ((q - k) & 3));
      // g[k] came from thread (q - k) % 4, which holds columns 2 (q - k)
      const uint4 v = make_uint4(pick4(g, q & 3), pick4(g, (q - 1) & 3),
                                 pick4(g, (q - 2) & 3), pick4(g, (q - 3) & 3));
      if (live[h] && c8 < p.out_ld)
        *reinterpret_cast<uint4*>(orow[h] + c8) = v;
      // the quad's four threads hold the 8 channels of each byte
      word[h] |= __shfl_xor_sync(0xFFFFFFFFu, word[h], 1);
      word[h] |= __shfl_xor_sync(0xFFFFFFFFu, word[h], 2);
      if (in[h] && (j4 & 3) == q && n0 / 8 + 4 * j4 < p.mask_ld)
        mrow[h][j4] = word[h];
    }
  }
}

// The backward epilogue: bf16(sum) for valid rows and columns < n.
template <int BN>
__device__ __forceinline__ void bwd_epilogue(const ConvArgs& p,
                                             float (&acc)[BN / 2], int row0,
                                             int n0, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= p.rows || (r % p.ts) >= p.t_valid) continue;
    bf16* orow = p.out + (size_t)r * p.out_ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      if (c + 1 < p.n)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else if (c < p.n)
        orow[c] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
    }
  }
}

// The body of both kernels, launched with GEMM_THREADS threads: warpgroups
// 0-1 consume (64 rows of the tile each), warpgroup 2's first thread issues
// every TMA load.  Persistent over tiles as gemm_persistent: tile t is
// column tile t % n_ct of row tile t / n_ct, so a row tile's A boxes are
// read from L2 by its neighbours.  BN: the tile's columns (256, or 64 for
// the backward of a layer of at most 64 input channels, 128 for at most 128
// columns).  AFFINE: the forward's affine BN (the header).
template <bool BWD, int BN, bool AFFINE>
__device__ __forceinline__ void conv_body(const CUtensorMap* map_a,
                                          const CUtensorMap* map_b,
                                          const ConvArgs& p) {
  constexpr int STAGE = Ring<BN>::STAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NST * STAGE);
  uint64_t* empty = full + NST;
  float* vec = reinterpret_cast<float*>(empty + NST);
  const int wg = threadIdx.x / 128;

  const int n_vec = (BWD ? 1 : 3) * p.vec_len;
  for (int i = threadIdx.x; i < n_vec; i += GEMM_THREADS) vec[i] = p.vecs[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const int n0 = (tile % p.n_ct) * BN, m0 = (tile / p.n_ct) * TM;
        for (int kt = 0; kt < p.k_tiles; ++kt) {
          const int j = kt / p.n_cb, cb = kt - j * p.n_cb;
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = smem + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          // rows before 0 or past the operand are filled with zeros
          tma_load_2d(st, map_a, &full[s], cb * TK,
                      m0 + p.a_shift + j * p.dil);
          tma_load_2d(st + A_BYTES, map_b, &full[s], kt * TK, n0);
          if (++s == NST) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int q = lane & 3;
  // the row of the tile whose 16 bytes this lane's ldmatrix address names
  const int ld_row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  // the first of the two A-fragment rows this thread holds (and + 8)
  const int frag_row = wg * 64 + warp * 16 + (lane >> 2);
  int s = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int n0 = (tile % p.n_ct) * BN, m0 = (tile / p.n_ct) * TM;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    if constexpr (!BWD) {
      static_assert(BN == TN || BN == HALF, "forward tiles: 256 or 128");
      // one group of products in flight while the next stage's are issued;
      // a stage is released once the group that read it is done
      int prev = -1;
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        mbar_wait(&full[s], phase);
        const unsigned char* st = smem + s * STAGE;
        fence_acc(acc);
        wgmma_fence();
        const uint64_t da = sw128_desc(st + wg * (64 * TK * 2));
        const uint64_t db = sw128_desc(st + A_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_ss(acc, da + 2 * kk, db + 2 * kk);
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
      fwd_epilogue<BN, AFFINE>(p, vec, acc, m0 + frag_row, n0, q);
    } else {
      // the mask bytes of the thread's two rows, one k-tile ahead
      const int r0 = m0 + p.a_shift + frag_row;
      uint64_t mk0 = mask_word(p, r0, 0), mk1 = mask_word(p, r0 + 8, 0);
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int j = kt / p.n_cb, cb = kt - j * p.n_cb;
        mbar_wait(&full[s], phase);
        const unsigned char* st = smem + s * STAGE;
        float2 sc[8];  // s of channels 8 grp + 2 q, + 1 of the block
#pragma unroll
        for (int grp = 0; grp < 8; ++grp)
          sc[grp] = *reinterpret_cast<const float2*>(vec + cb * TK + 8 * grp
                                                     + 2 * q);
        uint32_t a[TK / 16][4];
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          // 128-byte swizzle: 16-byte chunk c of row r sits at c ^ (r % 8)
          const int chunk = 2 * kk + (lane >> 4);
          ldmatrix_x4(a[kk], st + ld_row * 128 + ((chunk ^ (ld_row & 7)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // word i: row + 8 (i % 2), channels 8 (2 kk + i / 2) + 2 q, + 1
            const int grp = 2 * kk + (i >> 1);
            const uint64_t mk = (i & 1) ? mk1 : mk0;
            const uint32_t bits = (uint32_t)(mk >> (8 * grp + 2 * q)) & 3u;
            a[kk][i] = scale_mask(a[kk][i], bits, sc[grp]);
          }
        }
        fence_acc(acc);
        wgmma_fence();
        const uint64_t db = sw128_desc(st + A_BYTES);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_rs(acc, a[kk], db + 2 * kk);
        wgmma_commit();
        if (kt + 1 < p.k_tiles) {  // the next k-tile's mask, in flight now
          const int jn = (kt + 1) / p.n_cb, cbn = kt + 1 - jn * p.n_cb;
          mk0 = mask_word(p, r0 + jn * p.dil, cbn);
          mk1 = mask_word(p, r0 + jn * p.dil + 8, cbn);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == NST) {
          s = 0;
          phase ^= 1;
        }
      }
      bwd_epilogue<BN>(p, acc, m0 + frag_row, n0, q);
    }
  }
}

template <int BN, bool AFFINE>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
tdnn_conv_fwd_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const ConvArgs p) {
  conv_body<false, BN, AFFINE>(&map_a, &map_b, p);
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
tdnn_conv_bwd_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const ConvArgs p) {
  conv_body<true, BN, false>(&map_a, &map_b, p);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Makes the current device's primary context current on this thread: the
// backward runs on autograd's own thread, where no runtime call may have
// bound it yet, and cuTensorMapEncodeTiled needs it.
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

template <int BN, class K>
int launch(K kernel, const CUtensorMap& map_a, const CUtensorMap& map_b,
           const ConvArgs& p, int n_vec, cudaStream_t s) {
  const size_t smem = Ring<BN>::FIXED + sizeof(float) * (size_t)n_vec;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_tiles < sms ? p.n_tiles : sms, GEMM_THREADS, smem, s>>>(
      map_a, map_b, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward.  x: x_rows flat rows of cin channels, row stride x_ld (a
// multiple of 8) bf16; wf (cout, k n_cb 64) bf16, wf[o, (j n_cb + b) 64 +
// c'] = w[o, 64 b + c', j], zero past cin; vecs: bias, mean, s, or with
// ``affine`` bias, c, a (each vec_len >= 256 ceil(cout / 256) floats,
// zero-padded) -> out (rows, out_ld) bf16 (rows with t = r % ts < t_out,
// columns < cout) and the mask bits (rows, mask_ld) bytes, every row <
// rows.  The affine form takes 128-column tiles where cout <= 128.
extern "C" int sg_tdnn_conv_fwd(const void* x, int x_rows, int cin, int x_ld,
                                const void* wf, int k, const float* vecs,
                                int vec_len, void* out, int out_ld,
                                void* mask, int mask_ld, int rows, int ts,
                                int t_out, int cout, int dil, int affine,
                                void* stream) {
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  ConvArgs p;
  const int bn = affine && cout <= HALF ? HALF : TN;
  p.n_cb = cdiv(cin, TK);
  p.n_ct = cdiv(cout, bn);
  if (x_ld % 8 != 0 || mask_ld % 8 != 0 || mask_ld * 8 < cout ||
      vec_len < p.n_ct * bn || out_ld < cout || rows < 1 || ts < t_out)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, x, x_rows, cin, x_ld, TM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, wf, cout, k * p.n_cb * TK, k * p.n_cb * TK, bn);
  if (rc != 0) return rc;
  p.rows = rows;
  p.ts = ts;
  p.t_valid = t_out;
  p.n = cout;
  p.dil = dil;
  p.a_shift = 0;
  p.k_tiles = k * p.n_cb;
  p.n_tiles = cdiv(rows, TM) * p.n_ct;
  p.out = static_cast<bf16*>(out);
  p.out_ld = out_ld;
  p.mask = static_cast<uint8_t*>(mask);
  p.mask_ld = mask_ld;
  p.mask_rows = rows;
  p.vecs = vecs;
  p.vec_len = vec_len;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == HALF)
    return launch<HALF>(tdnn_conv_fwd_kernel<HALF, true>, map_a, map_b, p,
                        3 * vec_len, st);
  return affine ? launch<TN>(tdnn_conv_fwd_kernel<TN, true>, map_a, map_b, p,
                             3 * vec_len, st)
                : launch<TN>(tdnn_conv_fwd_kernel<TN, false>, map_a, map_b,
                             p, 3 * vec_len, st);
}

// Input gradient.  g: g_rows flat rows of cout channels, row stride g_ld (a
// multiple of 8) bf16, and its mask bits (g_rows, mask_ld) bytes; s
// (vec_len >= 64 ceil(cout / 64) floats, zero-padded); wb (cin, k n_cb 64)
// bf16, wb[c, (j n_cb + b) 64 + o'] = w[64 b + o', c, k - 1 - j], zero past
// cout -> gx (rows, gx_ld) bf16 (rows with t = r % ts < t_in, columns <
// cin).
extern "C" int sg_tdnn_conv_bwd(const void* g, int g_rows, int g_ld,
                                const void* mask, int mask_ld,
                                const float* s, int vec_len, const void* wb,
                                int k, void* gx, int gx_ld, int rows, int ts,
                                int t_in, int cin, int cout, int dil,
                                void* stream) {
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  ConvArgs p;
  const int bn = cin <= NARROW ? NARROW : cin <= HALF ? HALF : TN;
  p.n_cb = cdiv(cout, TK);
  p.n_ct = cdiv(cin, bn);
  if (g_ld % 8 != 0 || mask_ld % 8 != 0 || mask_ld < p.n_cb * 8 ||
      vec_len < p.n_cb * TK || gx_ld < cin || rows < 1 || ts < t_in)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, g, g_rows, cout, g_ld, TM);
  if (rc != 0) return rc;
  rc = make_map(&map_b, wb, cin, k * p.n_cb * TK, k * p.n_cb * TK, bn);
  if (rc != 0) return rc;
  p.rows = rows;
  p.ts = ts;
  p.t_valid = t_in;
  p.n = cin;
  p.dil = dil;
  p.a_shift = -(k - 1) * dil;
  p.k_tiles = k * p.n_cb;
  p.n_tiles = cdiv(rows, TM) * p.n_ct;
  p.out = static_cast<bf16*>(gx);
  p.out_ld = gx_ld;
  p.mask = static_cast<uint8_t*>(const_cast<void*>(mask));
  p.mask_ld = mask_ld;
  p.mask_rows = g_rows;
  p.vecs = s;
  p.vec_len = vec_len;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == NARROW)
    return launch<NARROW>(tdnn_conv_bwd_kernel<NARROW>, map_a, map_b, p,
                          vec_len, st);
  if (bn == HALF)
    return launch<HALF>(tdnn_conv_bwd_kernel<HALF>, map_a, map_b, p, vec_len,
                        st);
  return launch<TN>(tdnn_conv_bwd_kernel<TN>, map_a, map_b, p, vec_len, st);
}

// The tile sizes the wrapper pads to (ops/tdnn_conv.py holds them equal).
extern "C" int sg_tdnn_conv_tile_n() { return TN; }
extern "C" int sg_tdnn_conv_tile_k() { return TK; }
