// The fused parameter-free InstanceNorm(+ReLU) for Hopper (sm_90a), on
// channels-last bf16 volumes [B, N, C] (N = D * H * W voxels): two kernels,
// two modes each.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/instance_norm.py
//   norm_reduce, mode 0 (norm_stats):  _per_lane_stats,
//     out[b, 0, c] = sum_v x,  out[b, 1, c] = sum_v x^2;
//   norm_reduce, mode 1 (norm_bwd_sums): _bwd's first pallas_call,
//     out[b, 0, c] = sum_v g_m,  out[b, 1, c] = sum_v g_m * xhat;
//   norm_elementwise, mode 0 (norm_apply): _apply_per_lane,
//     y = [relu](xhat);
//   norm_elementwise, mode 1 (norm_bwd_dx): _bwd's second pallas_call,
//     dx = s * ((g_m - m1) - xhat * m2);
//   with xhat = x * s[b, c] + t[b, c] rounded as every kernel of the port
//   rounds it (common.cuh), and g_m = g where xhat > 0 under the ReLU (every
//   g without it), so the backward's mask is the forward's.
// The TPU kernels viewed [B, N * C] as 128-lane rows and carried the
// per-lane sums across a sequential grid in VMEM; here blocks run in
// parallel and the data is read as it lies.
//
// What bounds them on the H100: the bytes (one read of x, and of g in the
// backward, and one write in the elementwise modes; a few operations per
// element). Both kernels walk the flat [N * C] slice of one batch entry with
// a stride that is a multiple of C, so every element a thread visits
// belongs to one channel: its (s, t, m1, m2) sit in registers and no element
// needs a division, while neighbouring threads read neighbouring addresses.
// The reduction keeps f32 partials per thread (chains of N * C / stride
// elements), adds a block's threads in shared memory, and combines the
// blocks with one f64 atomicAdd per (row, channel) and block: at 128^3 a
// channel sums 2.1M voxels, and sum g_m * xhat cancels far below its terms.
// The order of the atomics varies from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct NormArgs {
  const __nv_bfloat16* x;  // [B, N, C]
  const __nv_bfloat16* g;  // [B, N, C] cotangent (mode 1), or null
  const float* s;          // [B, C] scale (rstd), or null in mode 0 of reduce
  const float* t;          // [B, C] shift (-mean * rstd)
  const float* m;          // [B, 2, C] (m1, m2), elementwise mode 1
  double* sums;            // reduce: [B, 2, C], zeroed by the caller
  __nv_bfloat16* y;        // elementwise: [B, N, C]
  int64_t n;               // N * C elements per batch entry
  int C, relu;
};

__device__ __forceinline__ float masked(float g, float xhat, int relu) {
  return (!relu || xhat > 0.f) ? g : 0.f;
}

// grid (gx, B) with gx * kThreads a multiple of C.
template <int MODE>
__global__ void __launch_bounds__(kThreads) norm_reduce_kernel(const NormArgs a) {
  extern __shared__ float sred[];  // [2][C]
  const int tid = threadIdx.x, b = blockIdx.y;
  for (int i = tid; i < 2 * a.C; i += kThreads) sred[i] = 0.f;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t base = (int64_t)b * a.n;
  const int c = (int)(first % a.C);
  float s = 0.f, t = 0.f;
  if (MODE == 1) {
    s = a.s[b * a.C + c];
    t = a.t[b * a.C + c];
  }
  float acc0 = 0.f, acc1 = 0.f;
  for (int64_t e = first; e < a.n; e += stride) {
    const float xv = __bfloat162float(a.x[base + e]);
    if (MODE == 0) {
      acc0 += xv;
      acc1 = fmaf(xv, xv, acc1);
    } else {
      const float xhat = pre_activation(xv, s, t);
      const float gm = masked(__bfloat162float(a.g[base + e]), xhat, a.relu);
      acc0 += gm;
      acc1 = fmaf(gm, xhat, acc1);
    }
  }
  atomicAdd(&sred[c], acc0);
  atomicAdd(&sred[a.C + c], acc1);
  __syncthreads();
  for (int i = tid; i < 2 * a.C; i += kThreads)
    atomicAdd(&a.sums[(int64_t)b * 2 * a.C + i], static_cast<double>(sred[i]));
}

// grid (gx, B) with gx * kThreads a multiple of C.
template <int MODE>
__global__ void __launch_bounds__(kThreads) norm_elementwise_kernel(const NormArgs a) {
  const int b = blockIdx.y;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t base = (int64_t)b * a.n;
  const int c = (int)(first % a.C);
  const float s = a.s[b * a.C + c], t = a.t[b * a.C + c];
  float m1 = 0.f, m2 = 0.f;
  if (MODE == 1) {
    m1 = a.m[(int64_t)b * 2 * a.C + c];
    m2 = a.m[(int64_t)b * 2 * a.C + a.C + c];
  }
  for (int64_t e = first; e < a.n; e += stride) {
    const float xhat = pre_activation(__bfloat162float(a.x[base + e]), s, t);
    float v;
    if (MODE == 0) {
      v = a.relu ? fmaxf(xhat, 0.f) : xhat;
    } else {
      // the plain version's order and roundings: s * ((g_m - m1) - xhat * m2)
      const float gm = masked(__bfloat162float(a.g[base + e]), xhat, a.relu);
      v = __fmul_rn(s, __fsub_rn(__fsub_rn(gm, m1), __fmul_rn(xhat, m2)));
    }
    a.y[base + e] = __float2bfloat16(v);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks per batch entry: enough for eight elements a thread, at most ~16
// blocks per SM over the batch, rounded up so that the stride gx * kThreads
// is a multiple of C.
long long grid_x(long long n, int C, int B) {
  long long gx = (n + (long long)kThreads * 8 - 1) / ((long long)kThreads * 8);
  const long long cap = (16LL * sm_count() + B - 1) / B;
  if (gx > cap) gx = cap;
  int g = C, r = kThreads;  // q = C / gcd(C, kThreads)
  while (r != 0) {
    const int tmp = g % r;
    g = r;
    r = tmp;
  }
  const long long q = C / g;
  return (gx + q - 1) / q * q;
}

bool bad_shape(int B, long long nvox, int C) {
  return B <= 0 || B > 65535 || nvox <= 0 || C <= 0;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (and g with the backward's sums): [B, nvox, C] bf16; s, t: [B, C] f32,
// both null for the forward's statistics (mode 0), both given for the
// backward's (mode 1, g given too); sums: [B, 2, C] f64, zeroed.
// Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_norm_reduce(const void* x, const void* g, const void* s, const void* t,
                       void* sums, int relu, int B, long long nvox, int C,
                       void* stream) {
  if (bad_shape(B, nvox, C)) return cudaErrorInvalidValue;
  const bool bwd = g != nullptr;
  if (bwd != (s != nullptr) || bwd != (t != nullptr)) return cudaErrorInvalidValue;
  NormArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.m = nullptr;
  a.sums = static_cast<double*>(sums);
  a.y = nullptr;
  a.n = nvox * C;
  a.C = C;
  a.relu = relu;
  const size_t smem = sizeof(float) * 2 * C;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x(a.n, C, B), B, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd)
    norm_reduce_kernel<1><<<grid, kThreads, smem, st>>>(a);
  else
    norm_reduce_kernel<0><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// x: [B, nvox, C] bf16; s, t: [B, C] f32; with g ([B, nvox, C] bf16) and m
// ([B, 2, C] f32) the backward's dx (mode 1), else the forward's apply
// (mode 0); y: [B, nvox, C] bf16.
// Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_norm_elementwise(const void* x, const void* g, const void* s,
                            const void* t, const void* m, void* y, int relu,
                            int B, long long nvox, int C, void* stream) {
  if (bad_shape(B, nvox, C) || s == nullptr || t == nullptr)
    return cudaErrorInvalidValue;
  const bool bwd = g != nullptr;
  if (bwd != (m != nullptr)) return cudaErrorInvalidValue;
  NormArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.m = static_cast<const float*>(m);
  a.sums = nullptr;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.n = nvox * C;
  a.C = C;
  a.relu = relu;
  const dim3 grid((unsigned)grid_x(a.n, C, B), B, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd)
    norm_elementwise_kernel<1><<<grid, kThreads, 0, st>>>(a);
  else
    norm_elementwise_kernel<0><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
