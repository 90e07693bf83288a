// IMA ADPCM encode + decode round-trip for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one: the JAX package runs the codec as
// a lax.scan over time (speakerguard_tpu/defenses/speech_compression.py
// _adpcm_nondiff), which XLA compiles to one device loop.  This kernel is the
// port's counterpart of that loop; eager PyTorch would pay ~20 small launches
// a sample (ops/adpcm.py adpcm_plain).
//
// Contract (ops/adpcm.py):
//   sg_adpcm         x16: (B, L) float32, samples already clipped to
//                    [-32768, 32767] -> out: (B, L) float32, the decoder's
//                    predictor after each sample.
//   sg_adpcm_scaled  the ADPCM defense's whole round trip on (B, L) float32
//                    audio in either domain, given the batch's min and max
//                    (two device scalars, torch.aminmax): the sniff (max > 2
//                    or min < -2 picks factor 1/32768 and restore 32768,
//                    else 1 and 1), * factor, * 32768 and the clamp on load;
//                    / 32768 and * restore on store: _adpcm_nondiff's float
//                    operations in their order, in one launch.
//   bits: 2..16; the coder has bits - 1 magnitude taps.
// The output equals the plain version bit for bit.  Every add that rounds is
// written __fadd_rn / __fsub_rn, which nvcc never contracts into a fused
// multiply-add whatever -fmad says; every product is exact, and the one
// __fmaf_rn that rounds (the reconstruction, code * (+-u) + (+-u/2)) has an
// exact product, so it rounds as the add of the JAX body does.
//
// The coder.  With N = bits - 1 taps on the step s and u = s / 2^(N-1) (the
// last tap), the serial coder's code is #{k in 1..2^N-1 : rem >= k*u} and its
// reconstruction code*u + u/2, the sign applied after.  While s <= rem < 2s
// each of its subtractions is exact (Sterbenz: the remainder stays below
// twice the next tap), so each tap compares the exact remainder; when
// rem >= 2s every tap is 1.  k*u and the partial sums of taken taps are exact
// while (2^N - 1) times the step's 15 significant bits fit in 24, that is for
// bits <= 10.  The closed form compares rem with all 2^N - 1 thresholds at
// once (each compare a 0 or 1) and sums them pairwise into the code: one
// compare and log2(2^N - 1) adds deep where the taps are N x (compare,
// select, subtract).  It runs for bits <= kClosedMaxBits, where its 2^N - 1
// compares still cost fewer issue slots than the taps they replace; the
// taps stay for the other bits.
//
// The step table.  The index moves by index_adjustment(min(code, 7)), one of
// {-1, 2, 4, 6, 8}, so each index has five candidate next indices
// clamp(idx + a, 0, 88).  A row of the table holds, for one index, the five
// candidates' steps (u where the closed form runs) and their rows' byte
// offsets, each as the first candidate's value and the differences from one
// candidate to the next: three 16-byte reads, issued as soon as the index is
// known, while the next sample's coder runs.  ge[k] = [min(code, 7) >= k]
// for k = 4..7 are four of the coder's 0/1 compares, set in order, so the
// first value plus the differences they select is the chosen candidate: a
// few multiply-adds on integers (times a power of two for u), all exact,
// with no table read and no select on the chain.  The index travels as
// its row's offset, an int: the float sum holds it plus 2^23, whose bits
// are the offset plus those of 2^23, so it is read back with an integer
// subtract and no conversion.  Each lane reads its own copy of the table
// (89 rows x 48 bytes x 32 lanes, 137 KB), so the 32 lanes' reads of 32
// different rows fall in distinct banks, where one shared copy put them in
// conflict with one another on the index's chain.
//
// Bound on an H100 SXM: each sample is read once and written once, 8 bytes;
// at B = 512, L = 48,000 that is 197 MB, 0.06 ms at 3.35 TB/s.  But sample t
// of a wave needs the predictor and step index that sample t - 1 left: a
// wave is a chain of L dependent steps, and the predictor's own chain (the
// difference, the coder's decision, the reconstruction, the add and the
// two-sided clamp: 6 dependent operations) bounds the kernel
// (chip_smoke.py adpcm_bound_ms): 24 cycles a sample.  At 4 bits the chain
// warp's loop is 43.5 instructions a sample (its SASS) and takes ~76
// cycles: the latencies along the predictor's chain (seven compares
// contending for the ALU pipe, three adds, the fused reconstruction, the
// add and two min/max) and along the index's (the select, the table's
// reads) set the pace, not the issue rate.
//
// Design: a block is 32 waves and two warps.  Warp 0 runs the recurrence,
// one lane a wave.  Warp 1 copies: it stages tiles of 32 waves x 64 samples
// through a ring of three shared-memory stages with coalesced cp.async (16
// bytes a copy where every row starts 16-byte aligned, else 4), applies the
// defense's load scaling in place, and hands the stage over through a named
// barrier; the chain reads its own row four samples at a time (one 16-byte
// read), writes each prediction over its sample, and hands the stage back;
// the copy warp then applies the store scaling, stores the tile coalesced
// and refills the stage with the tile three ahead.  The copy warp reads
// shared memory 16 copies at a time, so their latency is paid once a batch.
// Rows are padded to 68 floats: a quarter-warp's eight 16-byte reads of
// column t of eight rows then fall in eight distinct bank groups, where a
// row stride that is a multiple of 32 words would put the whole warp on one
// bank.  Occupancy: one chain warp a block, and B = 512 waves take 16 SMs.
// The time is the chain warp's, at one instruction a cycle at best: a
// second chain warp on the same scheduler would share its issue slots, and
// more SMs would not shorten a wave.  The copy warp runs on another
// scheduler of the same SM; the 163 KB of dynamic shared memory hold one
// block an SM.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int N_STEPS = 89;
constexpr int WAVES = 32;            // waves a block: one a lane of warp 0
constexpr int THREADS = 64;          // warp 0 the chain, warp 1 the copies
constexpr int TILE = 64;             // samples of a wave a stage
constexpr int STRIDE = TILE + 4;     // padded row, floats
constexpr int STAGES = 3;
constexpr int kClosedMaxBits = 4;    // the closed-form coder up to here
// The step table: a row of three float4 chunks an index, one copy a lane,
// chunk j of row i of lane L at byte i * ROW_BYTES + j * CHUNK_BYTES + 16 L.
constexpr int CHUNKS = 3;
constexpr int CHUNK_BYTES = WAVES * 16;
constexpr int ROW_BYTES = CHUNKS * CHUNK_BYTES;
constexpr int TILE_BYTES = STAGES * WAVES * STRIDE * 4;
constexpr int SMEM_BYTES = TILE_BYTES + N_STEPS * ROW_BYTES;   // 162,816
constexpr float BIAS = 8388608.f;    // 2^23: an int n < 2^23 as n + BIAS
constexpr int BIAS_BITS = 0x4B000000;   // __float_as_int(BIAS)
static_assert(TILE % 32 == 0 && TILE % 4 == 0, "tile of whole float4s");
static_assert((STRIDE / 4) % 8 == 1, "quarter-warp float4 reads spread");
static_assert(TILE_BYTES % 16 == 0 && SMEM_BYTES <= 232448, "shared memory");

__constant__ float c_steps[N_STEPS] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

// The IMA index adjustments by min(code, 7), as the specification tables
// them.  The kernel computes them (index_adjustment) and selects among the
// five candidates (candidate_slot, candidate_offset); these asserts hold
// both to the table, which nothing else reads.
constexpr int c_adj[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

__host__ __device__ constexpr int index_adjustment(int c) {
  return c < 4 ? -1 : 2 * (c - 3);
}
__host__ __device__ constexpr int candidate_slot(int c) {
  return c < 4 ? 0 : c - 3;
}
__host__ __device__ constexpr int candidate_offset(int slot) {
  return slot == 0 ? -1 : 2 * slot;
}

constexpr bool adjustments_match_the_table() {
  for (int c = 0; c < 8; ++c)
    if (index_adjustment(c) != c_adj[c] ||
        candidate_offset(candidate_slot(c)) != c_adj[c])
      return false;
  return true;
}
static_assert(adjustments_match_the_table(),
              "index_adjustment and the candidates disagree with c_adj");

__device__ __forceinline__ int clamp_index(int i) {
  return min(max(i, 0), N_STEPS - 1);
}

// ---- the copy warp's primitives --------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Named barriers between the two warps (id 0 is __syncthreads'): full[s]
// (the copy warp arrives, the chain waits) and done[s] (the reverse).
__device__ __forceinline__ int full_barrier(int s) { return 1 + s; }
__device__ __forceinline__ int done_barrier(int s) { return 1 + STAGES + s; }
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// ---- the recurrence --------------------------------------------------------

// a[0] = the sum of a[0..K), pairwise (levels W = 1, 2, 4, ...)
template <int W, int K>
__device__ __forceinline__ void pairwise_sum(float (&a)[K]) {
  if constexpr (W < K) {
#pragma unroll
    for (int i = 0; i + W < K; i += 2 * W) a[i] = __fadd_rn(a[i], a[i + W]);
    pairwise_sum<2 * W, K>(a);
  }
}

template <int BITS>
struct Coder {
  static constexpr int N = BITS - 1;               // magnitude taps
  static constexpr bool CLOSED = BITS <= kClosedMaxBits;
  static constexpr int K = (1 << N) - 1;           // the largest code
  static constexpr bool RISES = !CLOSED || K >= 4;   // can the index rise
  // the table's steps: u = step / 2^(N-1) for the closed form, else step
  static constexpr float SCALE = CLOSED ? 1.f / (1 << (N - 1)) : 1.f;

  // Row idx of the table: the five candidates' steps (u where CLOSED) and
  // their rows' byte offsets + BIAS, each as the first candidate's value
  // and the differences from one to the next, so that the sum of the
  // first and of the differences a code reaches is the selected one.
  static __device__ __forceinline__ void row_words(int idx, float (&w)[12]) {
    int prev_c = 0;
    float prev_u = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int c = clamp_index(idx + candidate_offset(j));
      const float u = __fmul_rn(c_steps[c], SCALE);
      w[j] = j == 0 ? u : __fsub_rn(u, prev_u);
      w[5 + j] = j == 0 ? (float)(c * ROW_BYTES) + BIAS
                        : (float)((c - prev_c) * ROW_BYTES);
      prev_c = c;
      prev_u = u;
    }
    w[10] = w[11] = 0.f;
  }

  const char* table;   // this lane's copy
  float pred = 0.f;
  float u;             // this sample's step (u where CLOSED)
  float4 row[CHUNKS];  // the current index's row

  __device__ explicit Coder(const char* lane_table) : table(lane_table) {
    u = __fmul_rn(c_steps[0], SCALE);
    load_row(0);
  }

  __device__ __forceinline__ void load_row(int offset) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j)
      row[j] = *reinterpret_cast<const float4*>(table + offset +
                                                j * CHUNK_BYTES);
  }

  // One sample: the JAX body's operations, returns the new predictor.
  __device__ __forceinline__ float operator()(float x) {
    const float diff = __fsub_rn(x, pred);
    const float su = diff < 0.f ? -u : u;   // the sign, applied to u
    float recon;
    // ge[k] = 1 where min(code, 7) >= k, else 0 (k = 4..7)
    float ge[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (CLOSED) {
      const float rem = fabsf(diff);
      float a[K];
#pragma unroll
      for (int k = 1; k <= K; ++k) {
        a[k - 1] = rem >= __fmul_rn(u, (float)k) ? 1.f : 0.f;
        if (k >= 4 && k < 8) ge[k] = a[k - 1];
      }
      pairwise_sum<1, K>(a);   // the code, a small exact integer
      // code * su is exact, so the fused add rounds as __fadd_rn does
      recon = __fmaf_rn(a[0], su, __fmul_rn(su, 0.5f));
    } else {
      float r = fabsf(diff), acc = 0.f, s = u;
      int code = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const bool bit = r >= s;
        code = 2 * code + (bit ? 1 : 0);
        r = bit ? __fsub_rn(r, s) : r;
        acc = __fadd_rn(acc, bit ? s : 0.f);
        s = __fmul_rn(s, 0.5f);
      }
      recon = __fadd_rn(acc, s);
      recon = diff < 0.f ? -recon : recon;
      const int c = min(code, 7);
#pragma unroll
      for (int k = 4; k < 8; ++k) ge[k] = c >= k ? 1.f : 0.f;
    }
    pred = fminf(fmaxf(__fadd_rn(pred, recon), -32768.f), 32767.f);
    // the next step and row: candidate_slot(min(code, 7)) is the number of
    // ge[4..7] set, and they are set in order, so the candidate is the first
    // word plus the differences they select; every term and partial sum is
    // an exact integer (times a power of two for u), so the products by 0
    // or 1 and the adds are exact
    float offset = row[1].y;
    if constexpr (RISES) {
      u = __fadd_rn(
          __fmaf_rn(ge[5], row[0].z, __fmaf_rn(ge[4], row[0].y, row[0].x)),
          __fmaf_rn(ge[7], row[1].x, __fmul_rn(ge[6], row[0].w)));
      offset = __fadd_rn(
          __fmaf_rn(ge[5], row[1].w, __fmaf_rn(ge[4], row[1].z, row[1].y)),
          __fmaf_rn(ge[7], row[2].y, __fmul_rn(ge[6], row[2].x)));
    } else {
      u = row[0].x;
    }
    load_row(__float_as_int(offset) - BIAS_BITS);
    return pred;
  }
};

template <int BITS>
__device__ __forceinline__ void run_chain(float (*tiles)[WAVES * STRIDE],
                                          const char* lane_table,
                                          int length, int lane) {
  Coder<BITS> coder(lane_table);
  const int ntiles = (length + TILE - 1) / TILE;
  for (int k = 0; k < ntiles; ++k) {
    const int s = k % STAGES;
    const int n = min(TILE, length - k * TILE);
    float* row = tiles[s] + lane * STRIDE;
    bar_sync(full_barrier(s));
    // columns past the wave's end (the last tile's tail) run on whatever
    // the stage holds and are never stored; eight samples an iteration
    // (5% faster than four on the card)
#pragma unroll 2
    for (int t = 0; t < n; t += 4) {
      float4 v = *reinterpret_cast<const float4*>(row + t);
      v.x = coder(v.x);
      v.y = coder(v.y);
      v.z = coder(v.z);
      v.w = coder(v.w);
      *reinterpret_cast<float4*>(row + t) = v;
    }
    bar_arrive(done_barrier(s));
  }
}

// ---- the copies ------------------------------------------------------------

template <typename Fn>
__device__ __forceinline__ float apply(float v, Fn f) { return f(v); }
template <typename Fn>
__device__ __forceinline__ float4 apply(float4 v, Fn f) {
  return make_float4(f(v.x), f(v.y), f(v.z), f(v.w));
}

// W floats a copy: 4 (16-byte copies) where every row of x and out starts
// 16-byte aligned, else 1.
template <bool SCALED, int W>
struct Copier {
  using V = typename std::conditional<W == 4, float4, float>::type;
  static constexpr int C = TILE / W;                // copies a row
  static constexpr int PER_LANE = WAVES * C / 32;   // copies a lane a tile
  static constexpr int BATCH = 16;                  // reads in flight
  const float* x;
  float* out;
  float (*tiles)[WAVES * STRIDE];
  int length, rows, lane;
  size_t base;        // offset of the block's first wave
  float factor = 1.f, restore = 1.f;

  // copy m of this lane: row (lane + 32 m) / C, column its rest times W
  __device__ __forceinline__ int row_of(int m) const {
    return (lane + 32 * m) / C;
  }
  __device__ __forceinline__ int col_of(int m) const {
    return (lane + 32 * m) % C * W;
  }

  // Issue tile k's copies into its stage (rows past the batch are left).
  __device__ __forceinline__ void load(int k) {
    const int t0 = k * TILE, n = min(TILE, length - t0);
    float* st = tiles[k % STAGES];
#pragma unroll 4
    for (int m = 0; m < PER_LANE; ++m) {
      const int r = row_of(m), c = col_of(m);
      if (r < rows && c < n)
        cp_async<4 * W>(st + r * STRIDE + c,
                        x + base + (size_t)r * length + t0 + c);
    }
  }

  // After tile k landed: the load scaling on this lane's own copies (each
  // lane sees its own cp.async writes once they are waited for; the
  // stage's other slots are scaled too and never stored), then hand the
  // stage to the chain.  Reads go BATCH at a time, so their latency is
  // paid once a batch.
  __device__ __forceinline__ void publish(int k) {
    if constexpr (SCALED) {
      float* st = tiles[k % STAGES];
      const float f = factor;
      for (int m0 = 0; m0 < PER_LANE; m0 += BATCH) {
        V v[BATCH];
#pragma unroll
        for (int m = 0; m < BATCH; ++m)
          v[m] = *reinterpret_cast<const V*>(
              st + row_of(m0 + m) * STRIDE + col_of(m0 + m));
#pragma unroll
        for (int m = 0; m < BATCH; ++m)
          *reinterpret_cast<V*>(st + row_of(m0 + m) * STRIDE +
                                col_of(m0 + m)) =
              apply(v[m], [f](float a) {
                return fminf(fmaxf(__fmul_rn(__fmul_rn(a, f), 32768.f),
                                   -32768.f),
                             32767.f);
              });
      }
    }
    __syncwarp();
    bar_arrive(full_barrier(k % STAGES));
  }

  // Wait for the chain to finish tile k, then store its predictions (x /
  // 32768 is x * 2^-15 exactly, so the product is the division).
  __device__ __forceinline__ void store(int k) {
    const int t0 = k * TILE, n = min(TILE, length - t0);
    const float* st = tiles[k % STAGES];
    const float g = restore;
    bar_sync(done_barrier(k % STAGES));
    for (int m0 = 0; m0 < PER_LANE; m0 += BATCH) {
      if (row_of(m0) >= rows) break;
      V v[BATCH];
#pragma unroll
      for (int m = 0; m < BATCH; ++m)
        v[m] = *reinterpret_cast<const V*>(st + row_of(m0 + m) * STRIDE +
                                           col_of(m0 + m));
#pragma unroll
      for (int m = 0; m < BATCH; ++m) {
        const int r = row_of(m0 + m), c = col_of(m0 + m);
        if (r >= rows || c >= n) continue;
        V w = v[m];
        if constexpr (SCALED)
          w = apply(w, [g](float a) {
            return __fmul_rn(__fmul_rn(a, 1.f / 32768.f), g);
          });
        *reinterpret_cast<V*>(out + base + (size_t)r * length + t0 + c) = w;
      }
    }
  }

  __device__ __forceinline__ void run() {
    const int ntiles = (length + TILE - 1) / TILE;
    // tile j is cp.async group j (a group is committed each round, empty
    // past the end), so wait<STAGES - 2> at round k means tile k landed;
    // round k refills the stage of tile k - 1, stored just before
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < ntiles) load(k);
      cp_async_commit();
    }
    for (int k = 0; k < ntiles; ++k) {
      cp_async_wait<STAGES - 2>();
      publish(k);
      if (k > 0) store(k - 1);
      if (k + STAGES - 1 < ntiles) load(k + STAGES - 1);
      cp_async_commit();
    }
    store(ntiles - 1);
  }
};

template <int BITS, bool SCALED, int W>
__global__ void __launch_bounds__(THREADS)
    adpcm_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ wav_min,
                 const float* __restrict__ wav_max, int batch, int length) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tiles = reinterpret_cast<float (*)[WAVES * STRIDE]>(smem);
  unsigned char* table = smem + TILE_BYTES;
  // the rows once, staged where the tiles go, then every lane's copy
  float4* rows = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < N_STEPS; i += THREADS) {
    float w[12];
    Coder<BITS>::row_words(i, w);
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j)
      rows[i * CHUNKS + j] =
          make_float4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N_STEPS * CHUNKS * WAVES; e += THREADS)
    reinterpret_cast<float4*>(table)[e] = rows[e / WAVES];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * WAVES;
  if (threadIdx.x < 32) {
    run_chain<BITS>(tiles, reinterpret_cast<const char*>(table) + lane * 16,
                    length, lane);
  } else {
    Copier<SCALED, W> copier{x, out, tiles, length, min(WAVES, batch - b0),
                             lane, (size_t)b0 * length};
    if constexpr (SCALED) {
      const bool big = *wav_max > 2.f || *wav_min < -2.f;
      copier.factor = big ? 1.f / 32768.f : 1.f;
      copier.restore = big ? 32768.f : 1.f;
    }
    copier.run();
  }
}

template <int BITS, bool SCALED, int W>
cudaError_t launch_kernel(const float* x, float* out, const float* wav_min,
                          const float* wav_max, int batch, int length,
                          cudaStream_t stream) {
  auto kernel = adpcm_kernel<BITS, SCALED, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kernel<<<(batch + WAVES - 1) / WAVES, THREADS, SMEM_BYTES, stream>>>(
      x, out, wav_min, wav_max, batch, length);
  return cudaGetLastError();
}

template <int BITS, bool SCALED>
cudaError_t launch_bits(const float* x, float* out, const float* wav_min,
                        const float* wav_max, int batch, int length,
                        cudaStream_t stream) {
  const bool aligned = length % 4 == 0 &&
                       reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0;
  return aligned ? launch_kernel<BITS, SCALED, 4>(x, out, wav_min, wav_max,
                                                  batch, length, stream)
                 : launch_kernel<BITS, SCALED, 1>(x, out, wav_min, wav_max,
                                                  batch, length, stream);
}

template <bool SCALED, int... B>
int launch(std::integer_sequence<int, B...>, const float* x, float* out,
           const float* wav_min, const float* wav_max, int batch, int length,
           int bits, void* stream) {
  if (batch < 0 || length < 0 || bits < 2 || bits > 16)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || length == 0) return 0;
  cudaError_t e = cudaSuccess;
  // the instance of this bits, B + 2
  ((bits == B + 2 ? (e = launch_bits<B + 2, SCALED>(
                         x, out, wav_min, wav_max, batch, length,
                         static_cast<cudaStream_t>(stream)))
                  : e),
   ...);
  return (int)e;
}

using AllBits = std::make_integer_sequence<int, 15>;   // bits 2..16

}  // namespace

// x16, out: (batch, length) float32 device pointers.  One launch on
// `stream`; returns cudaGetLastError() as an int (0 = the launch was
// accepted).
extern "C" int sg_adpcm(const float* x16, float* out, int batch, int length,
                        int bits, void* stream) {
  return launch<false>(AllBits{}, x16, out, nullptr, nullptr, batch, length,
                       bits, stream);
}

// wav, out: (batch, length) float32 device pointers; wav_min, wav_max: the
// batch's min and max, one float each on the device.  One launch on
// `stream`, as sg_adpcm.
extern "C" int sg_adpcm_scaled(const float* wav, float* out,
                               const float* wav_min, const float* wav_max,
                               int batch, int length, int bits,
                               void* stream) {
  return launch<true>(AllBits{}, wav, out, wav_min, wav_max, batch, length,
                      bits, stream);
}

// The length of the step table, so the host can check it against its own.
extern "C" int sg_adpcm_n_steps() { return N_STEPS; }
