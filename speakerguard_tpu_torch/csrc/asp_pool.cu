// ECAPA-TDNN's attentive statistics over time (models/ecapa.py, the pooling
// after the attention logits) on Hopper, forward and backward, one launch
// each.  For each utterance b and channel c, with alpha = softmax over t of
// the logits L[b, :, c]:
//
//    mu = sum_t alpha m,   var = sum_t alpha (m - mu)^2,
//    sigma = sqrt(max(var, eps))
//
// Replaces no TPU kernel: the JAX package has no ECAPA-TDNN.  Added because
// in plain torch these few lines are about twenty float32 passes over
// (B, T, C) a direction (the softmax, the product and difference tensors,
// their gradients), the largest share of the attack step after the TDNN
// blocks.
//
// What bounds it: the bytes.  A few operations an element against the f32
// logits and the bf16 activations read (and, backward, their gradients
// written), far below the card's 295 operations a byte.  So each direction
// reads its inputs twice (a pass needs the previous pass's reduction over
// t) and writes only its outputs:
//
//  - A block holds 32 channels (one a lane: a warp's loads of a frame are
//    128 contiguous bytes of L and 64 of m) and 8 warps, each a stride of
//    frames; the warps' partial sums meet in shared memory.
//  - Forward, pass 1: an online softmax per thread (running max, sum of
//    exponentials, sum of exponentials times m), merged across the warps
//    into max M, sum S and mu; pass 2: sum of exp(L - M) (m - mu)^2.  The
//    centred form, as SpeechBrain's pooling computes it: exact for a
//    channel that is constant over time.  M, S and var are kept for the
//    backward.
//  - Backward, with dvar = gsigma / (2 sigma) where var >= eps (else 0) and
//    dalpha_t = gmu m_t + dvar (m_t - mu)^2: pass 1 sums A = sum_t alpha
//    dalpha; pass 2 writes dL_t = alpha_t (dalpha_t - A) (f32) and dm_t =
//    alpha_t (gmu + 2 dvar (m_t - mu)) (bf16).
//
// Every C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int LANES = 32;   // channels a block
constexpr int WARPS = 8;    // warps a block, each a stride of frames

__global__ void __launch_bounds__(LANES * WARPS)
asp_stats_fwd_kernel(const float* __restrict__ logits,
                     const bf16* __restrict__ m, int t, int c, float eps,
                     float* __restrict__ mu, float* __restrict__ sigma,
                     float* __restrict__ lmax, float* __restrict__ lsum,
                     float* __restrict__ var) {
  __shared__ float sh[3][WARPS][LANES];
  const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
  const int ch = blockIdx.x * LANES + lane, b = blockIdx.y;
  const bool on = ch < c;
  const size_t base = (size_t)b * t * c + ch;

  float mx = -INFINITY, s = 0.f, sm = 0.f;
  if (on)
    for (int i = w; i < t; i += WARPS) {
      const float l = logits[base + (size_t)i * c];
      const float v = __bfloat162float(m[base + (size_t)i * c]);
      if (l > mx) {
        const float r = expf(mx - l);   // 0 while mx is -inf
        s *= r;
        sm *= r;
        mx = l;
      }
      const float e = expf(l - mx);
      s += e;
      sm += e * v;
    }
  sh[0][w][lane] = mx;
  sh[1][w][lane] = s;
  sh[2][w][lane] = sm;
  __syncthreads();
  float big = -INFINITY;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) big = fmaxf(big, sh[0][k][lane]);
  float tot = 0.f, tot_m = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    // a warp that saw no frame holds (-inf, 0, 0)
    const float r = sh[1][k][lane] > 0.f ? expf(sh[0][k][lane] - big) : 0.f;
    tot += sh[1][k][lane] * r;
    tot_m += sh[2][k][lane] * r;
  }
  const float mean = tot_m / tot;
  __syncthreads();

  float sv = 0.f;
  if (on)
    for (int i = w; i < t; i += WARPS) {
      const float l = logits[base + (size_t)i * c];
      const float d = __bfloat162float(m[base + (size_t)i * c]) - mean;
      sv += expf(l - big) * d * d;
    }
  sh[0][w][lane] = sv;
  __syncthreads();
  if (w == 0 && on) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) acc += sh[0][k][lane];
    const float v = acc / tot;
    const int o = b * c + ch;
    mu[o] = mean;
    sigma[o] = sqrtf(fmaxf(v, eps));
    lmax[o] = big;
    lsum[o] = tot;
    var[o] = v;
  }
}

__global__ void __launch_bounds__(LANES * WARPS)
asp_stats_bwd_kernel(const float* __restrict__ logits,
                     const bf16* __restrict__ m, int t, int c, float eps,
                     const float* __restrict__ mu,
                     const float* __restrict__ sigma,
                     const float* __restrict__ lmax,
                     const float* __restrict__ lsum,
                     const float* __restrict__ var,
                     const float* __restrict__ gmu,
                     const float* __restrict__ gsigma,
                     float* __restrict__ dlogits, bf16* __restrict__ dm) {
  __shared__ float sh[WARPS][LANES];
  const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
  const int ch = blockIdx.x * LANES + lane, b = blockIdx.y;
  const bool on = ch < c;
  const size_t base = (size_t)b * t * c + ch;
  const int o = b * c + ch;
  float mean = 0.f, big = 0.f, inv = 0.f, gm = 0.f, dv = 0.f;
  if (on) {
    mean = mu[o];
    big = lmax[o];
    inv = 1.f / lsum[o];
    gm = gmu[o];
    dv = var[o] >= eps ? gsigma[o] / (2.f * sigma[o]) : 0.f;
  }

  float a = 0.f;
  if (on)
    for (int i = w; i < t; i += WARPS) {
      const float alpha = expf(logits[base + (size_t)i * c] - big) * inv;
      const float v = __bfloat162float(m[base + (size_t)i * c]);
      const float d = v - mean;
      a += alpha * (gm * v + dv * d * d);
    }
  sh[w][lane] = a;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) tot += sh[k][lane];

  if (on)
    for (int i = w; i < t; i += WARPS) {
      const size_t at = base + (size_t)i * c;
      const float alpha = expf(logits[at] - big) * inv;
      const float v = __bfloat162float(m[at]);
      const float d = v - mean;
      dlogits[at] = alpha * (gm * v + dv * d * d - tot);
      dm[at] = __float2bfloat16_rn(alpha * (gm + 2.f * dv * d));
    }
}

dim3 grid(int b, int c) { return dim3((c + LANES - 1) / LANES, b); }

}  // namespace

// Forward.  logits (b, t, c) f32 and m (b, t, c) bf16, both contiguous ->
// mu, sigma, and for the backward lmax, lsum, var: each (b, c) f32.
extern "C" int sg_asp_stats_fwd(const void* logits, const void* m, int b,
                                int t, int c, float eps, void* mu,
                                void* sigma, void* lmax, void* lsum,
                                void* var, void* stream) {
  if (b < 1 || t < 1 || c < 1) return (int)cudaErrorInvalidValue;
  asp_stats_fwd_kernel<<<grid(b, c), LANES * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const bf16*>(m), t, c,
      eps, static_cast<float*>(mu), static_cast<float*>(sigma),
      static_cast<float*>(lmax), static_cast<float*>(lsum),
      static_cast<float*>(var));
  return (int)cudaGetLastError();
}

// Backward.  The forward's inputs and outputs, and the cotangents gmu,
// gsigma (b, c) f32 -> dlogits (b, t, c) f32 and dm (b, t, c) bf16.
extern "C" int sg_asp_stats_bwd(const void* logits, const void* m, int b,
                                int t, int c, float eps, const void* mu,
                                const void* sigma, const void* lmax,
                                const void* lsum, const void* var,
                                const void* gmu, const void* gsigma,
                                void* dlogits, void* dm, void* stream) {
  if (b < 1 || t < 1 || c < 1) return (int)cudaErrorInvalidValue;
  asp_stats_bwd_kernel<<<grid(b, c), LANES * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const bf16*>(m), t, c,
      eps, static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const float*>(lmax), static_cast<const float*>(lsum),
      static_cast<const float*>(var), static_cast<const float*>(gmu),
      static_cast<const float*>(gsigma), static_cast<float*>(dlogits),
      static_cast<bf16*>(dm));
  return (int)cudaGetLastError();
}
