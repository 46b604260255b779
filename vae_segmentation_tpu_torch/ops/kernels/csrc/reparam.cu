// reparam_kl: the VAE's reparameterised latent and its KL term for Hopper
// (sm_90a), with the standard normal sample drawn inside the kernel.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/reparam.py::_run
//   (_tpu_kernel): one pass over the [B, D] latent statistics,
//     eps    = Box-Muller normal from the seed (below)
//     latent = mean + eps * std * scale
//     kl     = 0.5 * sum_{b, d} (std^2 + mean^2 - 2 log(std + 1e-5)) / B
//   (the batch MEAN of the per-sample KL, utils/evaluation.py:42-45), f32,
//   eps returned as the backward's residual.
//
// The TPU kernel seeded the TPU's own generator (pltpu.prng_seed) and drew
// two 32-bit words per element. Here the words come from a counter-based
// generator written in this file, Philox4x32-10 (Salmon et al., SC'11):
// element i of the flattened [B, D] block takes the counter (i, 0, 0, 0)
// under the key (seed, 0), and uses output words 0 and 1. The recipe after
// the bits is the TPU kernel's (reparam.py:40-47): the top 24 bits of each
// word to a uniform in [0, 1), u1 clamped at 1e-7, and the cosine branch,
//     eps = sqrt(-2 log u1) * cos(2 pi u2).
// The same seed gives the same eps on every launch; the stream is not the
// TPU's. ops/reparam.py::philox_normal_plain computes the same bits and the
// same recipe in plain PyTorch.
//
// What bounds it on the H100: nothing of the card. The tensors are tiny
// ([4, 128] in the VAE train step: 6 KB in, 6 KB out), so the launch itself
// is the cost. One block walks the elements with a grid-stride loop; each
// thread adds its KL terms in f64, a shuffle tree adds each warp's, and warp
// 0 adds the warp sums in a fixed order and rounds the batch mean to f32
// once: no atomics and no shared-memory tree of barriers, the same KL on
// every run for the same inputs.
//
// reparam_kl_vjp_kernel is the VJP the JAX package attaches to the kernel
// (reparam.py::_reparam_bwd, left to XLA there), one pass over [B, D]:
//     d_mean = g_latent + gk mean
//     d_std  = g_latent eps scale + gk (std - 1 / (std + 1e-5)),  gk = g_kl / B
// with one rounding per operation in the order of the plain version
// (ops/reparam.py::reparam_kl_vjp_plain), and ATen's own roundings there:
// g_kl / B is g_kl times the f32 reciprocal of B taken on the host, and
// 1 / x is the reciprocal of x. The seed and the scale get no gradient.
//
// launch_floor_kernel does nothing: timed as reparam_kl is, it is the
// least a launch of one block costs on this card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVjpThreads = 256;
constexpr float kKlEps = 1e-5f;

struct Words4 { uint32_t x, y, z, w; };

__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b, uint32_t& hi,
                                        uint32_t& lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// Philox4x32-10: ten rounds, the key bumped between rounds
__device__ Words4 philox4x32_10(Words4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(0xD2511F53u, c.x, hi0, lo0);
    mulhilo(0xCD9E8D57u, c.z, hi1, lo1);
    c = Words4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// the top 24 bits as a float in [0, 1), exactly (as reparam.py:40-43)
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads) reparam_kl_kernel(
    const float* __restrict__ mean, const float* __restrict__ std_,
    const int* __restrict__ seed, float scale, float* __restrict__ latent,
    float* __restrict__ kl, float* __restrict__ eps_out, int n, int batch) {
  __shared__ double warp_sums[kWarps];
  const uint32_t key = static_cast<uint32_t>(seed[0]);
  double part = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Words4 bits = philox4x32_10(Words4{static_cast<uint32_t>(i), 0u, 0u, 0u},
                                      key, 0u);
    const float u1 = fmaxf(uniform24(bits.x), 1e-7f);
    const float u2 = uniform24(bits.y);
    // one rounding per operation, as the plain version computes it
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float e = __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u2)));
    const float m = mean[i], s = std_[i];
    eps_out[i] = e;
    latent[i] = __fadd_rn(m, __fmul_rn(__fmul_rn(e, s), scale));
    part += static_cast<double>(
        __fsub_rn(__fadd_rn(__fmul_rn(s, s), __fmul_rn(m, m)),
                  __fmul_rn(2.0f, logf(__fadd_rn(s, kKlEps)))));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (warp == 0) {
    double total = lane < kWarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
    if (lane == 0) kl[0] = static_cast<float>(0.5 * total / batch);
  }
}

__global__ void __launch_bounds__(kVjpThreads) reparam_kl_vjp_kernel(
    const float* __restrict__ mean, const float* __restrict__ std_,
    const float* __restrict__ eps, const float* __restrict__ g_latent,
    const float* __restrict__ g_kl, float inv_batch, float scale,
    float* __restrict__ d_mean, float* __restrict__ d_std, int n) {
  const float gk = __fmul_rn(g_kl[0], inv_batch);
  for (int i = blockIdx.x * kVjpThreads + threadIdx.x; i < n; i += gridDim.x * kVjpThreads) {
    const float m = mean[i], s = std_[i], gl = g_latent[i];
    d_mean[i] = __fadd_rn(gl, __fmul_rn(gk, m));
    const float recip = __frcp_rn(__fadd_rn(s, kKlEps));
    d_std[i] = __fadd_rn(__fmul_rn(__fmul_rn(gl, eps[i]), scale),
                         __fmul_rn(gk, __fsub_rn(s, recip)));
  }
}

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mean, std, latent, eps: [B, D] f32; seed: one int32 on the device; kl: one
// f32. Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_reparam_kl(const void* mean, const void* std_, const void* seed,
                      float scale, void* latent, void* kl, void* eps, int B,
                      int D, void* stream) {
  if (B <= 0 || D <= 0 || static_cast<long long>(B) * D > (1LL << 30))
    return cudaErrorInvalidValue;
  reparam_kl_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean), static_cast<const float*>(std_),
      static_cast<const int*>(seed), scale, static_cast<float*>(latent),
      static_cast<float*>(kl), static_cast<float*>(eps), B * D, B);
  return cudaGetLastError();
}

// mean, std, eps, g_latent, d_mean, d_std: [B, D] f32; g_kl: one f32;
// inv_batch the f32 reciprocal of B. Returns cudaGetLastError() after the
// launch.
int vaeseg_reparam_kl_vjp(const void* mean, const void* std_, const void* eps,
                          const void* g_latent, const void* g_kl, float inv_batch,
                          float scale, void* d_mean, void* d_std, int B, int D,
                          void* stream) {
  if (B <= 0 || D <= 0 || static_cast<long long>(B) * D > (1LL << 30))
    return cudaErrorInvalidValue;
  const int n = B * D;
  const int blocks = (n + kVjpThreads - 1) / kVjpThreads < 1024
                         ? (n + kVjpThreads - 1) / kVjpThreads : 1024;
  reparam_kl_vjp_kernel<<<blocks, kVjpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean), static_cast<const float*>(std_),
      static_cast<const float*>(eps), static_cast<const float*>(g_latent),
      static_cast<const float*>(g_kl), inv_batch, scale, static_cast<float*>(d_mean),
      static_cast<float*>(d_std), n);
  return cudaGetLastError();
}

// One launch of the empty kernel (one block of one thread).
int vaeseg_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
