// IMA ADPCM encode + decode round-trip for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one: the JAX package runs the codec as
// a lax.scan over time (speakerguard_tpu/defenses/speech_compression.py
// _adpcm_nondiff), which XLA compiles to one device loop.  This kernel is the
// port's counterpart of that loop; eager PyTorch would pay ~20 small launches
// a sample (ops/adpcm.py adpcm_plain).
//
// Contract (ops/adpcm.py adpcm):
//   x16: (B, L) float32, samples already clipped to [-32768, 32767].
//   out: (B, L) float32, the decoder's predictor after each sample.
//   bits: 2..16; the coder takes bits - 1 magnitude taps.
// The float32 operations are the JAX body's, in its order, so the output
// equals the plain version bit for bit.  Each product in a step is exact (a
// bit of 0 or 1 times the step, a code times 2, a step times 0.5), and each
// add is written __fadd_rn / __fsub_rn / __fmul_rn, which nvcc never
// contracts into a fused multiply-add whatever -fmad says.
//
// Bound on an H100 SXM: each sample is read once and written once, 8 bytes;
// at B = 512, L = 48,000 that is 197 MB, 0.06 ms at 3.35 TB/s.  But sample t
// of a wave needs the predictor and step index that sample t - 1 left, so a
// wave is a chain of L dependent steps, each a few dozen dependent
// operations and two table reads; the chain, not the bytes, bounds the
// kernel (chip_smoke.py adpcm_bound_ms states the latency model).
//
// Design: one thread per wave, a sequential loop over L; 32 threads a block,
// so B = 512 waves take 16 SMs.  The step table and the index adjustments sit
// in shared memory (each thread indexes them by its own state, which would
// serialise the constant cache's broadcast).  The samples of a thread are
// consecutive: a warp's load touches 32 rows, and L1 serves the next seven
// samples of each row from the same 32-byte sector.

#include <cuda_runtime.h>

namespace {

constexpr int N_STEPS = 89;
constexpr int THREADS = 32;

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
__constant__ float c_adj[8] = {-1, -1, -1, -1, 2, 4, 6, 8};

__global__ void __launch_bounds__(THREADS)
    adpcm_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int batch, int length, int bits) {
  __shared__ float steps[N_STEPS];
  __shared__ float adj[8];
  for (int i = threadIdx.x; i < N_STEPS; i += THREADS) steps[i] = c_steps[i];
  if (threadIdx.x < 8) adj[threadIdx.x] = c_adj[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= batch) return;
  const float* xb = x + (size_t)b * length;
  float* ob = out + (size_t)b * length;
  const float mag_max = (float)((1 << (bits - 1)) - 1);
  float pred = 0.f, idx = 0.f;
  for (int t = 0; t < length; ++t) {
    const float step = steps[(int)idx];
    const float diff = __fsub_rn(xb[t], pred);
    const bool sign = diff < 0.f;
    float rem = fabsf(diff), code = 0.f, recon = 0.f, s = step;
    for (int k = 0; k < bits - 1; ++k) {
      const bool bit = rem >= s;
      code = __fadd_rn(__fmul_rn(code, 2.f), bit ? 1.f : 0.f);
      rem = bit ? __fsub_rn(rem, s) : rem;
      recon = __fadd_rn(recon, bit ? s : 0.f);
      s = __fmul_rn(s, 0.5f);
    }
    code = fminf(code, mag_max);
    recon = __fadd_rn(recon, s);
    recon = sign ? -recon : recon;
    pred = fminf(fmaxf(__fadd_rn(pred, recon), -32768.f), 32767.f);
    idx = fminf(fmaxf(__fadd_rn(idx, adj[(int)fminf(code, 7.f)]), 0.f),
                (float)(N_STEPS - 1));
    ob[t] = pred;
  }
}

}  // namespace

// x16, out: (batch, length) float32 device pointers.  One launch on
// `stream`; returns cudaGetLastError() as an int (0 = the launch was
// accepted).
extern "C" int sg_adpcm(const float* x16, float* out, int batch, int length,
                        int bits, void* stream) {
  if (batch < 0 || length < 0 || bits < 2 || bits > 16)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || length == 0) return 0;
  adpcm_kernel<<<(batch + THREADS - 1) / THREADS, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(x16, out, batch, length,
                                                      bits);
  return (int)cudaGetLastError();
}

// The length of the step table, so the host can check it against its own.
extern "C" int sg_adpcm_n_steps() { return N_STEPS; }
