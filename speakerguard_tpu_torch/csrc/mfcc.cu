// The fast path's Kaldi MFCC (ops/kaldi_mfcc.py with fast_dft=True) on
// Hopper (sm_90a): the whole chain from the framing gather to the energy
// column, one launch forward and two for the input gradient.
//
//    frames (Kaldi's mirrored edges) -> dither -> DC removal -> raw log
//    energy -> |DFT|^2 (preemphasis and window folded into the bf16 DFT
//    matrices) -> mel -> log -> DCT -> lifter -> energy column
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (speakerguard_tpu/ops/kaldi_mfcc.py).  Added because in plain torch the
// chain is some 90 launches an attack iteration over the (B, T, 400) f32
// frames and the (B, T, 257) f32 spectra, about 25 times its bound on the
// card.
//
// What bounds it: the bytes.  Forward, the wave and the dither noise are
// read and the features written; backward, the cotangent, the wave and
// the noise read and the wave's gradient written.  The DFT as products
// (62.9 GFLOP a direction at 512 x 300 frames) takes less time on wgmma
// than those bytes.  So no intermediate touches device memory but the mel
// (B, T, num_mel_bins), which the forward keeps for the backward, and the
// backward's gM rows:
//
//  - A block takes 64 consecutive frames of one utterance: one consumer
//    warpgroup, the 64 rows of its wgmma, and a producer warp whose first
//    lane streams the DFT matrices through a ring of TMA stages from L2.
//  - Prologue (both directions): the block's 64 rows of noise and the
//    aligned part of its span of the wave come by bulk TMA copies into
//    shared memory, the span's ends (Kaldi's mirrored edges) by the
//    consumers; x = wave + dither noise is formed in place over the noise,
//    and each quad of lanes builds its two frames' register-A wgmma
//    fragments from there: the mean and the energy in f32 (a quad's
//    shuffles), bf16(x - mean) packed as the 25 k16 steps of the A operand
//    (K = 400 = 25 x 16).
//  - The DFT: N = 512 rows of bf16 matrix, in four chunks of 128, each the
//    cosines of 64 bins and the negated sines of the same bins, so one
//    thread holds re and im of a bin.  Bins 0-255 are all the work: the
//    mel bank's Nyquist column is zero (mel_banks) and the sine of bin 0
//    is exactly zero, so dropping bin 256 changes no value and no gradient.
//  - Forward epilogue: the f32 power of all 256 bins staged in shared
//    memory, then the mel (a filter is a short run of bins, each bin in at
//    most two filters: a warp a filter, its lanes the frames), log, the
//    DCT (a warp eight cepstra), the lifter and the log energy in column
//    0.  Writes the features and the mel.
//  - Backward, first launch: gM = (cot lifter DCT^T) / mel under the
//    clamp's mask for every frame, written beside the mel; it also zeroes
//    the wave's gradient.  Second launch: the DFT recomputed from the wave
//    and noise (cheaper than reading saved spectra: 0.32 GB of them at the
//    cell's shape); while the staged frames are still there, each span
//    sample's fold starts from its covering frames' energy term 2 dE (x -
//    mean); the DFT's epilogue forms bf16(gP re) and bf16(gP im), gP the
//    mel transpose of gM (a bulk copy of the block's gM rows), straight
//    into shared memory as the A operand of the second product (K = 512,
//    N = 400, in two chunks of 200) against the transposed matrix.  Its
//    epilogue folds 2 x that into the block's span of samples, in three
//    passes so that frames that overlap (they share 240 samples) never add
//    at once; last, each span sample takes its covering frames' DC terms
//    (their mean gradients) off, the mirrored edges fold back, and each
//    sample is added once into the zeroed gradient.  A sample is touched
//    by at most two blocks, so its value is 0 + u + v in either order: the
//    same bits every run.
//
// The arithmetic is the fast path's: f32 framing, dither, DC and energy;
// bf16 DFT operands (the frames after DC removal, the matrices, and in
// the backward gP re and gP im) with f32 sums; f32 power, mel, log, DCT
// and lifter.  Only the order of the f32 sums differs.
//
// Every C entry point returns cudaGetLastError() after its launches; a
// tensor map that cannot be encoded returns 10000 + its CUresult.

#include <math.h>

#include "wgmma_gemm.cuh"

namespace {

constexpr int WIN = 400;                 // samples a frame: K of the DFT
constexpr int SHIFT = 160;               // samples between frames
constexpr int PAD = 120;                 // frame t starts at t SHIFT - PAD
constexpr int TR = 64;                   // frames a block
constexpr int KS = WIN / 16;             // k16 steps of the DFT
constexpr int KT1 = 7;                   // its k-tiles of GK (the last: 1 step)
constexpr int N1 = 128;                  // rows of a DFT chunk
constexpr int NC1 = 4;                   // chunks: 4 x 64 bins
constexpr int BINS = 256;
constexpr int KT2 = 8;                   // k-tiles of the backward product
constexpr int N2 = 200;                  // its columns a chunk
constexpr int NC2 = 2;
constexpr int THREADS = 160;             // warps 0-3 consume, warp 4 loads
constexpr int SLOT1 = N1 * GK * 2;       // a DFT stage: 16 KB
constexpr int SLOT2 = N2 * GK * 2;       // a backward stage: 25 KB
constexpr int NST_F = 4;                 // forward ring
constexpr int NST_B = 3;                 // backward ring (slots of SLOT2)
constexpr int EXT = (TR - 1) * SHIFT + WIN;  // samples a block's frames span
constexpr int PLD = BINS + 1;            // row stride of the staged power
constexpr int A2_TILE = TR * GK * 2;     // a k-tile of the backward's A: 8 KB
constexpr int MAX_MEL = 96;              // shared memory's plan (below)
constexpr int MLD_MAX = MAX_MEL + 1;
constexpr int GLD_MAX = (MLD_MAX + 3) / 4 * 4;
constexpr float EPS = 1.1920928955078125e-07f;  // Kaldi's epsilon

// Shared memory, after 1024 bytes of alignment slack.  Region R first
// holds the staged frames: the noise rows, turned in place into the frames
// x (TR x WIN), and the wave's span (EXT, at an offset of up to 3 floats
// that aligns its bulk copy).  Once the A fragments are built it is
// reused: forward for the power (TR x PLD), the log mel, the log energies
// and the transposed DCT; backward for the fold (EXT, where the wave's span
// was), the second product's A operand (KT2 k-tiles) and gM (TR x gld).
constexpr int R_X = 0;
constexpr int R_WAVE = R_X + TR * WIN * 4;
constexpr int R_BYTES = R_WAVE + (EXT + 4) * 4;
constexpr int F_POWER = 0;
constexpr int F_MEL = F_POWER + TR * PLD * 4;
constexpr int F_LE = F_MEL + TR * MLD_MAX * 4;
constexpr int F_DCT = F_LE + TR * 4;
constexpr int B_A2 = 0;
constexpr int B_GM = B_A2 + KT2 * A2_TILE;
constexpr int B_FOLD = R_WAVE;
static_assert(F_DCT + MAX_MEL * MAX_MEL * 4 <= R_BYTES, "forward's R");
static_assert(B_GM + TR * GLD_MAX * 4 <= B_FOLD &&
              B_FOLD + EXT * 4 <= R_BYTES, "backward's R");
// forward: ring | barriers | bin and filter tables | R
constexpr int FS_BARS = NST_F * SLOT1;
constexpr int FS_TAB = FS_BARS + 128;
constexpr int FS_R = FS_TAB + BINS * 12 + 2 * MAX_MEL * 4;
constexpr int FWD_SMEM = 1024 + FS_R + R_BYTES;
// backward: R | ring | barriers | per-frame vectors
constexpr int BS_RING = (R_BYTES + 1023) / 1024 * 1024;
constexpr int BS_BARS = BS_RING + NST_B * SLOT2;
constexpr int BS_VEC = BS_BARS + 128;
constexpr int BWD_SMEM = 1024 + BS_VEC + 4 * TR * 4;
static_assert(FWD_SMEM <= 232448 && BWD_SMEM <= 232448, "shared memory");

struct MfccArgs {
  const float* wav;      // (b, len)
  const float* noise;    // (b, t, WIN) standard normal, or null: no dither
  float dither;          // the noise's scale
  int len, t;            // samples an utterance, frames an utterance
  int nmel, nceps;
  const int* mel_lo;     // (nmel) first bin of each filter
  const int* mel_hi;     // (nmel) one past its last bin
  const int* bin_lo;     // (256) the first filter of each bin
  const float* bin_w;    // (256, 2) its weights in filters bin_lo, + 1
  const float* dct;      // forward: (nmel, nc8) the DCT transposed;
                         // backward: (nceps, nm8); zero-padded to 8 columns
  int dct_ld;            // its row stride: nc8 or nm8
  const float* lifter;   // (nceps)
  float* feat;           // forward: (b, t, nceps)
  float* mel;            // forward: written; backward: read; (b, t, nmel)
  const float* cot;      // backward: (b, t, nceps)
  float* gm;             // backward: (b, t, gld) gM, written by the first
  int gld;               // launch (columns past nmel zero), read by the second
  float* gwav;           // backward: (b, len), zeroed before the launch
};

// the four consumer warps only (the producer warp has returned)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``, both
// 16-byte aligned; completes on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// sample i of a wave of len samples, mirrored at both ends as Kaldi's
// snip_edges=False framing does (-1 -> 0, len -> len - 1)
__device__ __forceinline__ float wave_at(const float* w, int len, int i) {
  i = i < 0 ? -i - 1 : i;
  i = i >= len ? 2 * len - 1 - i : i;
  return __ldg(w + i);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}

// asks L2 for the 128-byte lines of p[off .. off + n), which the block
// reads later
__device__ __forceinline__ void prefetch_rows(const float* p, size_t off,
                                              int n, int tid) {
  const char* c = reinterpret_cast<const char*>(p + off);
  const char* end = reinterpret_cast<const char*>(p + off + n);
  for (c += 128 * tid; c < end; c += 128 * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c));
}

// The block's frames x = wave + dither noise (TR x WIN; rows past nv left
// as they are) into shared memory xs.  Its nv rows of noise (if any) and
// the 16-byte aligned part of the wave's span of (nv - 1) SHIFT + WIN
// samples from sample t0 SHIFT - PAD come by bulk copies on ``bar``, the
// span's ends (mirrored where they leave the wave) by the consumers, into
// ws from index woff; then x, four columns a thread at a time, in place
// over the noise.
__device__ __forceinline__ void stage_frames(const MfccArgs& a, int b, int t0,
                                             int nv, float* xs, float* ws,
                                             uint64_t* bar, int tid) {
  const float* w = a.wav + (size_t)b * a.len;
  const int base = t0 * SHIFT - PAD, ext = (nv - 1) * SHIFT + WIN;
  const int lo = max(base, 0), hi = min(base + ext, a.len);
  // [s0, s1): the samples a bulk copy can move (16-byte aligned at both
  // ends); woff puts s0 at a 16-byte aligned place of ws
  const int head =
      (int)((16 - (reinterpret_cast<uintptr_t>(w + lo) & 15)) & 15) / 4;
  int s0 = lo + head, s1 = s0 + (hi - s0) / 4 * 4;
  if (s1 <= s0) s0 = s1 = lo;
  const int woff = (4 - (s0 - base) % 4) % 4;
  if (tid == 0) {
    const uint32_t nbytes = a.noise != nullptr ? (uint32_t)nv * WIN * 4 : 0;
    const uint32_t wbytes = (uint32_t)(s1 - s0) * 4;
    if (nbytes + wbytes > 0) mbar_expect_tx(bar, nbytes + wbytes);
    if (nbytes > 0)
      bulk_load(xs, a.noise + ((size_t)b * a.t + t0) * WIN, nbytes, bar);
    if (wbytes > 0) bulk_load(ws + woff + s0 - base, w + s0, wbytes, bar);
  }
  for (int i = tid; i < s0 - base; i += 128)
    ws[woff + i] = wave_at(w, a.len, base + i);
  for (int i = s1 - base + tid; i < ext; i += 128)
    ws[woff + i] = wave_at(w, a.len, base + i);
  consumers_sync();
  if (a.noise != nullptr || s1 > s0) mbar_wait(bar, 0);
  const float* wv = ws + woff;
  float4* x4 = reinterpret_cast<float4*>(xs);
#pragma unroll 4
  for (int e = tid; e < nv * (WIN / 4); e += 128) {
    const int r = e / (WIN / 4), c = 4 * e - r * WIN;
    const float* wr = wv + r * SHIFT + c;
    float4 x = make_float4(wr[0], wr[1], wr[2], wr[3]);
    if (a.noise != nullptr) {
      // in f32 as torch rounds ``frames + dither * noise``
      const float4 n = x4[e];
      x.x = __fadd_rn(x.x, __fmul_rn(a.dither, n.x));
      x.y = __fadd_rn(x.y, __fmul_rn(a.dither, n.y));
      x.z = __fadd_rn(x.z, __fmul_rn(a.dither, n.z));
      x.w = __fadd_rn(x.w, __fmul_rn(a.dither, n.w));
    }
    x4[e] = x;
  }
  consumers_sync();
}

// The thread's frames r0 and r0 + 8 of the staged xs (lane q = lane % 4 of
// the quad that owns them) as the DFT's A operand: frag[s][i] holds frame
// r0 + 8 (i % 2), columns 16 s + 8 (i / 2) + 2 q, + 1, as bf16 (the
// mma.m16n8k16 A fragment of the warp's 16 rows), of f = x - mean(x); mu,
// en and fs are the frames' mean, energy sum f^2 and sum f (frames past
// nv: zeros).  The sums are split four and two ways for the adds' latency.
__device__ __forceinline__ void frames_to_fragments(
    const float* xs, int nv, int r0, int q, uint32_t (&frag)[KS][4],
    float (&mu)[2], float (&en)[2], float (&fs)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool ok = r < nv;
    const float* xr = xs + r * WIN + 2 * q;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 x =
              *reinterpret_cast<const float2*>(xr + 16 * s + 8 * half);
          float& t = sum[(2 * s + half) & 3];
          t = __fadd_rn(__fadd_rn(t, x.x), x.y);
        }
    }
    mu[h] = __fdiv_rn(quad_sum(__fadd_rn(__fadd_rn(sum[0], sum[1]),
                                         __fadd_rn(sum[2], sum[3]))),
                      (float)WIN);
    float e[2] = {0.f, 0.f}, f[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float f0 = 0.f, f1 = 0.f;
        if (ok) {
          const float2 x =
              *reinterpret_cast<const float2*>(xr + 16 * s + 8 * half);
          f0 = __fsub_rn(x.x, mu[h]);
          f1 = __fsub_rn(x.y, mu[h]);
          e[half] = fmaf(f1, f1, fmaf(f0, f0, e[half]));
          f[half] = __fadd_rn(__fadd_rn(f[half], f0), f1);
        }
        frag[s][h + 2 * half] = pack_bf16(f0, f1);
      }
    en[h] = quad_sum(__fadd_rn(e[0], e[1]));
    fs[h] = quad_sum(__fadd_rn(f[0], f[1]));
  }
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers: the thread's
// mma.m16n8k16 A fragment of its warp's 16 rows) . B (128 x 16, K-major
// in shared memory)^T
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// d (64 x 200, f32) += A (64 x 16) . B (200 x 16)^T, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss200(float (&d)[100], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99 "
      "}, %100, %101, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "l"(da), "l"(db), "r"(1));
}

// the mean gradients mrs[r] of the frames r < nv that cover span index i
// (frames k - 2, k - 1, k for k = i / SHIFT; frame k - 2 only in its last
// 80 samples), in order
__device__ __forceinline__ float dc_term(const float* mrs, int nv, int i) {
  const int k = i / SHIFT;
  float v = 0.f;
  if (k >= 2 && k - 2 < nv && i - (k - 2) * SHIFT < WIN) v = mrs[k - 2];
  if (k >= 1 && k - 1 < nv) v = __fadd_rn(v, mrs[k - 1]);
  if (k < nv) v = __fadd_rn(v, mrs[k]);
  return v;
}

// One chunk of the DFT: acc (64 frames x 128 rows of the chunk) = the A
// fragments . the chunk's 7 k-tiles, streamed through the ring (slots of
// SLOT bytes, NST of them).  One group of products stays in flight while
// the next stage's are issued; a stage is released once the group that
// read it is done.
template <int NST, int SLOT>
__device__ __forceinline__ void dft_chunk(float (&acc)[64],
                                          const uint32_t (&frag)[KS][4],
                                          unsigned char* ring, uint64_t* full,
                                          uint64_t* empty, int& s,
                                          uint32_t& phase, int lane) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int prev = -1;
#pragma unroll
  for (int kt = 0; kt < KT1; ++kt) {
    mbar_wait(&full[s], phase);
    fence_acc(acc);
    wgmma_fence();
    const uint64_t db = sw128_desc(ring + s * SLOT);
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      if (4 * kt + kk < KS) wgmma_rs128(acc, frag[4 * kt + kk], db + 2 * kk);
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
}

// full[s] (the producer's expect_tx), empty[s] (lane 0 of each consumer
// warp) for the nst stages, and full[nst], full[nst + 1]: the bulk copies'
// barriers (staged frames, gM rows)
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              int nst) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(&full[nst], 1);
    mbar_init(&full[nst + 1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's loads of the DFT's 4 x 7 stages (k-tile kt of chunk c:
// rows 128 c.., columns 64 kt.. of the (512, 400) matrix; columns past 400
// read as zeros) into slots of SLOT bytes.
template <int NST, int SLOT>
__device__ __forceinline__ void load_dft(const CUtensorMap* map,
                                         unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, int& s,
                                         uint32_t& phase) {
  for (int c = 0; c < NC1; ++c)
    for (int kt = 0; kt < KT1; ++kt) {
      mbar_wait(&empty[s], phase ^ 1);
      mbar_expect_tx(&full[s], SLOT1);
      tma_load_2d(ring + s * SLOT, map, &full[s], kt * GK, c * N1);
      if (++s == NST) {
        s = 0;
        phase ^= 1;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
mfcc_fwd_kernel(const __grid_constant__ CUtensorMap map1, const MfccArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + FS_BARS);
  uint64_t* empty = full + NST_F + 2;
  int* bl = reinterpret_cast<int*>(smem + FS_TAB);        // bin_lo
  float2* bw = reinterpret_cast<float2*>(bl + BINS);      // bin_w
  int* mlo = reinterpret_cast<int*>(bw + BINS);           // mel_lo
  int* mhi = mlo + MAX_MEL;                               // mel_hi
  unsigned char* rg = smem + FS_R;
  float* xs = reinterpret_cast<float*>(rg + R_X);
  float* ws = reinterpret_cast<float*>(rg + R_WAVE);
  float* pw = reinterpret_cast<float*>(rg + F_POWER);    // TR x PLD power
  float* lm = reinterpret_cast<float*>(rg + F_MEL);      // TR x mld log mel
  float* le = reinterpret_cast<float*>(rg + F_LE);       // TR log energies
  float* dt = reinterpret_cast<float*>(rg + F_DCT);      // nmel x dct_ld
  const int mld = a.nmel + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * TR;
  const int nv = min(TR, a.t - t0);

  init_barriers(full, empty, NST_F);
  if (warp == 4) {
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      load_dft<NST_F, SLOT1>(&map1, ring, full, empty, s, phase);
    }
    return;
  }

  const int tid = threadIdx.x, q = lane & 3, r0 = warp * 16 + (lane >> 2);
  for (int k = tid; k < BINS; k += 128) {
    bl[k] = __ldg(a.bin_lo + k);
    bw[k] = __ldg(reinterpret_cast<const float2*>(a.bin_w) + k);
  }
  for (int m = tid; m < a.nmel; m += 128) {
    mlo[m] = __ldg(a.mel_lo + m);
    mhi[m] = __ldg(a.mel_hi + m);
  }
  stage_frames(a, b, t0, nv, xs, ws, &full[NST_F], tid);
  uint32_t frag[KS][4];
  float mu[2], en[2], fs[2];
  frames_to_fragments(xs, nv, r0, q, frag, mu, en, fs);
  consumers_sync();  // the staged frames are read: R is reused
  if (q == 0) {
    le[r0] = logf(fmaxf(en[0], EPS));
    le[r0 + 8] = logf(fmaxf(en[1], EPS));
  }
  for (int i = tid; i < a.nmel * a.dct_ld / 4; i += 128)
    reinterpret_cast<float4*>(dt)[i] =
        __ldg(reinterpret_cast<const float4*>(a.dct) + i);

  int s = 0;
  uint32_t phase = 0;
  for (int c = 0; c < NC1; ++c) {
    float acc[64];
    dft_chunk<NST_F, SLOT1>(acc, frag, ring, full, empty, s, phase, lane);
    // acc[4 j + e]: frame r0 + 8 (e / 2), the cosine (j < 8) or negated
    // sine (j >= 8) row of bin 64 c + 8 (j % 8) + 2 q + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float re = acc[4 * j + e], im = acc[4 * (j + 8) + e];
        pw[(r0 + 8 * (e >> 1)) * PLD + 64 * c + 8 * j + 2 * q + (e & 1)] =
            __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
  }
  consumers_sync();

  // the mel: warp w takes filters w, w + 4, ..., its lanes frames lane and
  // lane + 32, a filter's bins in order with the weights from the bin
  // tables (the same for all lanes)
  const float* p0 = pw + lane * PLD;
  const float* p1 = pw + (lane + 32) * PLD;
  for (int m = warp; m < a.nmel; m += 4) {
    const int hi = mhi[m];
    float s0 = 0.f, s1 = 0.f;
    for (int k = mlo[m]; k < hi; ++k) {
      const float w = bl[k] == m ? bw[k].x : bw[k].y;
      s0 = fmaf(p0[k], w, s0);
      s1 = fmaf(p1[k], w, s1);
    }
    const size_t f = (size_t)b * a.t + t0 + lane;
    if (lane < nv) a.mel[f * a.nmel + m] = s0;
    if (lane + 32 < nv) a.mel[(f + 32) * a.nmel + m] = s1;
    lm[lane * mld + m] = logf(fmaxf(s0, EPS));
    lm[(lane + 32) * mld + m] = logf(fmaxf(s1, EPS));
  }
  consumers_sync();
  // the DCT: warp w takes cepstra 8 kb .. 8 kb + 7 for kb = w, w + 4, ...
  // (columns past nceps are zero), its lanes frames lane and lane + 32
  for (int kb = warp; 8 * kb < a.nceps; kb += 4) {
    float d[2][8] = {};
    for (int m = 0; m < a.nmel; ++m) {
      const float v0 = lm[lane * mld + m], v1 = lm[(lane + 32) * mld + m];
      const float4* p =
          reinterpret_cast<const float4*>(dt + m * a.dct_ld + 8 * kb);
      const float4 c0 = p[0], c1 = p[1];
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[0][i] = fmaf(v0, c[i], d[0][i]);
        d[1][i] = fmaf(v1, c[i], d[1][i]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = lane + 32 * h;
      if (row >= nv) continue;
      const size_t f = (size_t)b * a.t + t0 + row;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = 8 * kb + i;
        if (k < a.nceps)
          a.feat[f * a.nceps + k] =
              k == 0 ? le[row] : __fmul_rn(d[h][i], __ldg(a.lifter + k));
      }
    }
  }
}

// The backward's first launch: gM = (cot lifter DCT^T) / mel under the
// clamp's mask (cot's column 0, the log energy's, left out), each row of
// (b t, gld) from a block of TR frames: the DCT and the block's cot lifter
// in shared memory (rows a stride of nceps + 1 apart), thread tid the
// filters 8 mb .. 8 mb + 7 (mb = tid % 4, + 4, ...) of frame tid / 4;
// columns from nmel to gld are zero.  The blocks also zero the wave's
// gradient (n floats), which the second launch adds into.
constexpr int GM_THREADS = 4 * TR;

__global__ void __launch_bounds__(GM_THREADS)
mfcc_bwd_gm_kernel(const MfccArgs a, int rows, size_t n) {
  extern __shared__ float gsm[];
  for (size_t i = (size_t)blockIdx.x * GM_THREADS + threadIdx.x; i < n / 4;
       i += (size_t)gridDim.x * GM_THREADS)
    reinterpret_cast<float4*>(a.gwav)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (blockIdx.x == 0 && threadIdx.x < n % 4)
    a.gwav[n / 4 * 4 + threadIdx.x] = 0.f;
  const int gcl = a.nceps + 1;
  float* dcs = gsm;                          // nceps x dct_ld
  float* gcs = dcs + a.nceps * a.dct_ld;     // TR x gcl
  const int tid = threadIdx.x, f0 = blockIdx.x * TR;
  const int nv = min(TR, rows - f0);
  for (int i = tid; i < a.nceps * a.dct_ld / 4; i += GM_THREADS)
    reinterpret_cast<float4*>(dcs)[i] =
        __ldg(reinterpret_cast<const float4*>(a.dct) + i);
  // warp w reads rows w, w + 8, ..., its lanes a row's columns
  static_assert(MAX_MEL <= 96 && TR % (GM_THREADS / 32) == 0, "gM staging");
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int rr = 0; rr < TR / (GM_THREADS / 32); ++rr) {
    const int r = warp + rr * (GM_THREADS / 32);
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      const int k = lane + 32 * kk;
      if (r < nv && k < a.nceps)
        gcs[r * gcl + k] =
            k > 0 ? __fmul_rn(__ldg(a.cot + ((size_t)f0 + r) * a.nceps + k),
                              __ldg(a.lifter + k))
                  : 0.f;
    }
  }
  __syncthreads();
  const int row = tid >> 2;
  if (row >= nv) return;
  const size_t frame = (size_t)f0 + row;
  const float* gr = gcs + row * gcl;
  for (int mb = tid & 3; 8 * mb < a.gld; mb += 4) {
    float mv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // in flight during the sums
      const int m = 8 * mb + i;
      mv[i] = m < a.nmel ? __ldg(a.mel + frame * a.nmel + m) : 0.f;
    }
    float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 1; k < a.nceps; ++k) {
      const float gc = gr[k];
      const float4* p =
          reinterpret_cast<const float4*>(dcs + k * a.dct_ld + 8 * mb);
      const float4 d0 = p[0], d1 = p[1];
      d[0] = fmaf(gc, d0.x, d[0]);
      d[1] = fmaf(gc, d0.y, d[1]);
      d[2] = fmaf(gc, d0.z, d[2]);
      d[3] = fmaf(gc, d0.w, d[3]);
      d[4] = fmaf(gc, d1.x, d[4]);
      d[5] = fmaf(gc, d1.y, d[5]);
      d[6] = fmaf(gc, d1.z, d[6]);
      d[7] = fmaf(gc, d1.w, d[7]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = 8 * mb + i;
      if (m >= a.gld) break;
      a.gm[frame * a.gld + m] =
          m < a.nmel && mv[i] >= EPS ? __fdiv_rn(d[i], fmaxf(mv[i], EPS))
                                     : 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mfcc_bwd_kernel(const __grid_constant__ CUtensorMap map1,
                const __grid_constant__ CUtensorMap map2, const MfccArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* rg =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* xs = reinterpret_cast<float*>(rg + R_X);
  float* ws = reinterpret_cast<float*>(rg + R_WAVE);
  unsigned char* a2 = rg + B_A2;
  float* g = reinterpret_cast<float*>(rg + B_FOLD);     // EXT: the fold
  float* gm = reinterpret_cast<float*>(rg + B_GM);      // TR x gld
  unsigned char* ring = rg + BS_RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(rg + BS_BARS);
  uint64_t* empty = full + NST_B + 2;
  float* mus = reinterpret_cast<float*>(rg + BS_VEC);   // TR frame means
  float* crs = mus + TR;                                 // TR: 2 dE
  float* fss = crs + TR;                                 // TR: sum f
  float* mrs = fss + TR;                                 // TR: mean gradient
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * TR;
  const int nv = min(TR, a.t - t0);

  init_barriers(full, empty, NST_B);
  if (warp == 4) {
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      load_dft<NST_B, SLOT2>(&map1, ring, full, empty, s, phase);
      for (int ch = 0; ch < NC2; ++ch)
        for (int kt = 0; kt < KT2; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], SLOT2);
          tma_load_2d(ring + s * SLOT2, &map2, &full[s], kt * GK, ch * N2);
          if (++s == NST_B) {
            s = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  const int tid = threadIdx.x, q = lane & 3, r0 = warp * 16 + (lane >> 2);
  prefetch_rows(a.cot, ((size_t)b * a.t + t0) * a.nceps, nv * a.nceps, tid);
  stage_frames(a, b, t0, nv, xs, ws, &full[NST_B], tid);
  uint32_t frag[KS][4];
  float mu[2], en[2], fs[2];
  frames_to_fragments(xs, nv, r0, q, frag, mu, en, fs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (q == 0 && r < nv) {
      // the log energy's gradient dE (the clamp's mask); the energy's
      // gradient is 2 dE f
      const float g0 = a.cot[((size_t)b * a.t + t0 + r) * a.nceps];
      const float de = en[h] >= EPS ? __fdiv_rn(g0, fmaxf(en[h], EPS)) : 0.f;
      mus[r] = mu[h];
      crs[r] = __fmul_rn(2.f, de);
      fss[r] = fs[h];
    }
  }
  consumers_sync();
  // the fold starts from each covering frame's energy term 2 dE (x - mean)
  // at span index i (sample base + i), frames in order (x: the staged
  // frames)
  const int base = t0 * SHIFT - PAD, ext = (nv - 1) * SHIFT + WIN;
#pragma unroll 4
  for (int i = tid; i < ext; i += 128) {
    const int k = i / SHIFT;  // frames k - 2 (its last 80), k - 1, k
    float v = 0.f;
#pragma unroll
    for (int u = 2; u >= 0; --u) {
      const int r = k - u;
      if (r >= 0 && r < nv && i - r * SHIFT < WIN) {
        const float f = __fsub_rn(xs[r * WIN + i - r * SHIFT], mus[r]);
        v = __fadd_rn(v, __fmul_rn(crs[r], f));
      }
    }
    g[i] = v;
  }
  consumers_sync();  // the staged frames are read: R is reused
  if (tid == 0) {  // the frames' gM rows, wanted by the first epilogue
    const uint32_t bytes = (uint32_t)nv * a.gld * 4;
    mbar_expect_tx(&full[NST_B + 1], bytes);
    bulk_load(gm, a.gm + ((size_t)b * a.t + t0) * a.gld, bytes,
              &full[NST_B + 1]);
  }

  int s = 0;
  uint32_t phase = 0;
  for (int c = 0; c < NC1; ++c) {
    float acc[64];
    dft_chunk<NST_B, SLOT2>(acc, frag, ring, full, empty, s, phase, lane);
    if (c == 0) mbar_wait(&full[NST_B + 1], 0);
    // gP of the thread's bins; bf16(gP re) to k-tile 2 c and bf16(gP im)
    // to 2 c + 1 of the backward's A, 128-byte swizzled as TMA would
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float* grow = gm + r * a.gld;
        float vc[2], vs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bin = 64 * c + 8 * j + 2 * q + e;
          const int lo = __ldg(a.bin_lo + bin);
          const float2 w =
              __ldg(reinterpret_cast<const float2*>(a.bin_w) + bin);
          const float gp = fmaf(w.y, grow[lo + 1], __fmul_rn(w.x, grow[lo]));
          vc[e] = __fmul_rn(gp, acc[4 * j + 2 * h + e]);
          vs[e] = __fmul_rn(gp, acc[4 * (j + 8) + 2 * h + e]);
        }
        const int off = r * 128 + ((j ^ (r & 7)) << 4) + 4 * q;
        *reinterpret_cast<uint32_t*>(a2 + 2 * c * A2_TILE + off) =
            pack_bf16(vc[0], vc[1]);
        *reinterpret_cast<uint32_t*>(a2 + (2 * c + 1) * A2_TILE + off) =
            pack_bf16(vs[0], vs[1]);
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();

  float rsum[2] = {0.f, 0.f};
  for (int ch = 0; ch < NC2; ++ch) {
    float acc[100];
#pragma unroll
    for (int i = 0; i < 100; ++i) acc[i] = 0.f;
    int prev = -1;
#pragma unroll
    for (int kt = 0; kt < KT2; ++kt) {
      mbar_wait(&full[s], phase);
      fence_acc(acc);
      wgmma_fence();
      const uint64_t da = sw128_desc(a2 + kt * A2_TILE);
      const uint64_t db = sw128_desc(ring + s * SLOT2);
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)
        wgmma_ss200(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == NST_B) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
    // acc[4 j + e]: frame r0 + 8 (e / 2), column 200 ch + 8 j + 2 q + e % 2
    // of a - b; the power's share of the frame's gradient is 2 (a - b)
#pragma unroll
    for (int i = 0; i < 100; ++i) acc[i] = __fmul_rn(2.f, acc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j)
        rsum[h] = __fadd_rn(__fadd_rn(rsum[h], acc[4 * j + 2 * h]),
                            acc[4 * j + 2 * h + 1]);
    // the fold: frames 3 apart never overlap, so frames r % 3 == p add
    // together, in pass p
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < nv && r % 3 == p) {
          float* gr = g + r * SHIFT + ch * N2 + 2 * q;
#pragma unroll
          for (int j = 0; j < N2 / 8; ++j) {
            gr[8 * j] = __fadd_rn(gr[8 * j], acc[4 * j + 2 * h]);
            gr[8 * j + 1] = __fadd_rn(gr[8 * j + 1], acc[4 * j + 2 * h + 1]);
          }
        }
      }
      consumers_sync();
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the frame's mean gradient: its power share's and its energy term's,
    // 2 dE sum f (0 but for rounding)
    const float t = quad_sum(rsum[h]);
    const int r = r0 + 8 * h;
    if (q == 0 && r < nv)
      mrs[r] = __fdiv_rn(__fadd_rn(t, __fmul_rn(crs[r], fss[r])), (float)WIN);
  }
  consumers_sync();
  // span index i is sample base + i, mirrored into the wave at its ends;
  // each frame covering i takes its DC term (its mean gradient) off it
  const int lo = max(base, 0), hi = min(base + ext, a.len);
  float* gw = a.gwav + (size_t)b * a.len;
#pragma unroll 4
  for (int smp = lo + tid; smp < hi; smp += 128) {
    float v = __fsub_rn(g[smp - base], dc_term(mrs, nv, smp - base));
    const int i1 = -smp - 1 - base;            // mirrored from before 0
    if (i1 >= 0 && i1 < ext)
      v = __fadd_rn(v, __fsub_rn(g[i1], dc_term(mrs, nv, i1)));
    const int i2 = 2 * a.len - 1 - smp - base;  // mirrored from past len
    if (i2 >= 0 && i2 < ext)
      v = __fadd_rn(v, __fsub_rn(g[i2], dc_term(mrs, nv, i2)));
    atomicAdd(gw + smp, v);
  }
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

int check_shape(int b, int len, int t, int nmel, int nceps, int dct_ld,
                int need) {
  if (b < 1 || b > 65535 || t < 1 || len < 1 || nmel < 1 ||
      nmel > MAX_MEL || nceps < 1 || nceps > nmel || dct_ld % 8 != 0 ||
      dct_ld < need)
    return (int)cudaErrorInvalidValue;
  return 0;
}

MfccArgs args(const void* wav, const void* noise, float dither, int len,
              int t, int nmel, int nceps, const void* dct, int dct_ld,
              const void* lifter) {
  MfccArgs a = {};
  a.wav = static_cast<const float*>(wav);
  a.noise = static_cast<const float*>(noise);
  a.dither = dither;
  a.len = len;
  a.t = t;
  a.nmel = nmel;
  a.nceps = nceps;
  a.dct = static_cast<const float*>(dct);
  a.dct_ld = dct_ld;
  a.lifter = static_cast<const float*>(lifter);
  return a;
}

}  // namespace

// Forward.  wav (b, len) f32; noise (b, t, 400) f32 or null; dft (512,
// 400) bf16, chunk c's rows 128 c .. 128 c + 63 the cosines and the next
// 64 the negated sines of bins 64 c .. 64 c + 63 (window and preemphasis
// folded in); the mel bank as each filter's bins [mel_lo, mel_hi) (int32)
// and each bin's first filter bin_lo (256, int32) with its weights bin_w
// (256, 2) f32 in filters bin_lo, bin_lo + 1 (0 where none); dct_t (nmel,
// dct_ld) the DCT transposed, zero past nceps, dct_ld a multiple of 8;
// lifter (nceps) f32 -> feat (b, t, nceps) and mel (b, t, nmel) f32.  t
// frames of 400 samples every 160, the first at sample -120
// (snip_edges=False); len must be long enough that every index is
// mirrored at most once.
extern "C" int sg_mfcc_fwd(const void* wav, const void* noise, float dither,
                           int b, int len, int t, int nmel, int nceps,
                           const void* dft, const void* mel_lo,
                           const void* mel_hi, const void* bin_lo,
                           const void* bin_w, const void* dct_t, int dct_ld,
                           const void* lifter, void* feat, void* mel,
                           void* stream) {
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  int rc = check_shape(b, len, t, nmel, nceps, dct_ld, nceps);
  if (rc != 0) return rc;
  CUtensorMap map1;
  rc = make_map(&map1, dft, NC1 * N1, WIN, WIN, N1);
  if (rc != 0) return rc;
  MfccArgs a = args(wav, noise, dither, len, t, nmel, nceps, dct_t, dct_ld,
                    lifter);
  a.mel_lo = static_cast<const int*>(mel_lo);
  a.mel_hi = static_cast<const int*>(mel_hi);
  a.bin_lo = static_cast<const int*>(bin_lo);
  a.bin_w = static_cast<const float*>(bin_w);
  a.feat = static_cast<float*>(feat);
  a.mel = static_cast<float*>(mel);
  err = prepare(mfcc_fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  mfcc_fwd_kernel<<<dim3(cdiv(t, TR), b), THREADS, FWD_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(map1, a);
  return (int)cudaGetLastError();
}

// Input gradient.  The forward's wav, noise, dither, dft, bin_lo, bin_w
// and lifter; dft_t (400, 512) bf16 the DFT's transpose; dct (nceps,
// dct_ld) zero past nmel, dct_ld a multiple of 8 above nmel; the forward's
// mel and the features' cotangent cot (b, t, nceps) f32; gm (b, t, gld)
// f32 scratch, gld the multiple of 4 above nmel; gwav (b, len) f32,
// 16-byte aligned -> the wave's gradient in gwav.  Two launches: the gM
// kernel (which zeroes gwav), then the main one.
extern "C" int sg_mfcc_bwd(const void* wav, const void* noise, float dither,
                           int b, int len, int t, int nmel, int nceps,
                           const void* dft, const void* dft_t,
                           const void* bin_lo, const void* bin_w,
                           const void* dct, int dct_ld, const void* lifter,
                           const void* mel, const void* cot, void* gm,
                           int gld, void* gwav, void* stream) {
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  int rc = check_shape(b, len, t, nmel, nceps, dct_ld, nmel + 1);
  if (rc != 0) return rc;
  if (gld % 4 != 0 || gld <= nmel || gld > GLD_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map1, map2;
  rc = make_map(&map1, dft, NC1 * N1, WIN, WIN, N1);
  if (rc != 0) return rc;
  rc = make_map(&map2, dft_t, WIN, NC1 * N1, NC1 * N1, N2);
  if (rc != 0) return rc;
  MfccArgs a = args(wav, noise, dither, len, t, nmel, nceps, dct, dct_ld,
                    lifter);
  a.bin_lo = static_cast<const int*>(bin_lo);
  a.bin_w = static_cast<const float*>(bin_w);
  a.mel = static_cast<float*>(const_cast<void*>(mel));
  a.cot = static_cast<const float*>(cot);
  a.gm = static_cast<float*>(gm);
  a.gld = gld;
  a.gwav = static_cast<float*>(gwav);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * t;
  const size_t gsmem =
      sizeof(float) * ((size_t)nceps * dct_ld + TR * (nceps + 1));
  err = prepare(mfcc_bwd_gm_kernel, gsmem);
  if (err != cudaSuccess) return (int)err;
  mfcc_bwd_gm_kernel<<<cdiv(rows, TR), GM_THREADS, gsmem, st>>>(
      a, rows, (size_t)b * len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = prepare(mfcc_bwd_kernel, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  mfcc_bwd_kernel<<<dim3(cdiv(t, TR), b), THREADS, BWD_SMEM, st>>>(
      map1, map2, a);
  return (int)cudaGetLastError();
}
