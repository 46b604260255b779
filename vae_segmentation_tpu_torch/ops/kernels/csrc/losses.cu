// softmax_vjp and dice_sums for Hopper (sm_90a): the two single-pass
// kernels of the adaptation loss, on channels-last bf16 volumes [.., C]
// with the class axis last.
//
// softmax_vjp replaces (TPU, Pallas) vae_segmentation_tpu/ops/pallas/
//   softmaxvjp.py::softmax_group_vjp: the cotangent of K1's softmax
//   epilogue,  out[v, c] = (g[v, c] - sum_k g[v, k] y[v, k]) * y[v, c],
//   f32 math, bf16 in and out. The TPU kernel summed each class group of the
//   folded lane axis with a 0/1 matrix product; in the logical layout a
//   voxel's classes are C consecutive values, one thread reads them, and no
//   product is needed.
// dice_sums replaces ops/pallas/dicesums.py::_run: for K <= 3 targets,
//   out[b, 0, c]      = sum_v p[b, v, c]
//   out[b, 1 + 2k, c] = sum_v t_k[b, v, c]
//   out[b, 2 + 2k, c] = sum_v p[b, v, c] * t_k[b, v, c]
//   in f32, every volume read once. The TPU kernel carried its [8, L] block
//   across a sequential grid; here each thread keeps 1 + 2K sums of one
//   class (its stride is a multiple of C), a block adds them in shared
//   memory and then with one atomicAdd per (row, class) to the output, so
//   the order of the f32 sums varies from run to run.
//
// What bounds them on the H100: the bytes (3 and 1 + K volumes of traffic,
// one or two operations per element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTargets = 3;
constexpr int kRows = 1 + 2 * kMaxTargets;

__global__ void softmax_vjp_c2_kernel(const __nv_bfloat162* g, const __nv_bfloat162* y,
                                      __nv_bfloat162* out, int64_t nvox) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvox; v += stride) {
    const float2 gv = __bfloat1622float2(g[v]);
    const float2 yv = __bfloat1622float2(y[v]);
    const float dot = gv.x * yv.x + gv.y * yv.y;
    out[v] = __floats2bfloat162_rn((gv.x - dot) * yv.x, (gv.y - dot) * yv.y);
  }
}

__global__ void softmax_vjp_kernel(const __nv_bfloat16* g, const __nv_bfloat16* y,
                                   __nv_bfloat16* out, int64_t nvox, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvox; v += stride) {
    const __nv_bfloat16* gp = g + v * C;
    const __nv_bfloat16* yp = y + v * C;
    float dot = 0.f;
    for (int c = 0; c < C; ++c) dot += __bfloat162float(gp[c]) * __bfloat162float(yp[c]);
    for (int c = 0; c < C; ++c)
      out[v * C + c] =
          __float2bfloat16((__bfloat162float(gp[c]) - dot) * __bfloat162float(yp[c]));
  }
}

struct DiceArgs {
  const __nv_bfloat16* p;
  const __nv_bfloat16* t[kMaxTargets];
  float* out;      // [B, 1 + 2K, C], zeroed by the caller
  int64_t n;       // elements per batch entry: voxels * C
  int C, K;
};

// grid (gx, B) with gx * kThreads a multiple of C: a thread's elements all
// belong to one class.
__global__ void dice_sums_kernel(const DiceArgs a) {
  extern __shared__ float sred[];  // [1 + 2K][C]
  const int rows = 1 + 2 * a.K;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  for (int i = tid; i < rows * a.C; i += kThreads) sred[i] = 0.f;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t base = (int64_t)b * a.n;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int64_t e = first; e < a.n; e += stride) {
    const float pv = __bfloat162float(a.p[base + e]);
    acc[0] += pv;
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k) {
      if (k < a.K) {
        const float tv = __bfloat162float(a.t[k][base + e]);
        acc[1 + 2 * k] += tv;
        acc[2 + 2 * k] = fmaf(pv, tv, acc[2 + 2 * k]);
      }
    }
  }
  const int cls = (int)(first % a.C);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < rows) atomicAdd(&sred[r * a.C + cls], acc[r]);
  __syncthreads();
  for (int i = tid; i < rows * a.C; i += kThreads)
    atomicAdd(&a.out[(int64_t)b * rows * a.C + i], sred[i]);
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

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g, y, out: [nvox, C] bf16. Returns cudaGetLastError() after the launch.
int vaeseg_softmax_vjp(const void* g, const void* y, void* out, long long nvox,
                       int C, void* stream) {
  if (nvox <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long nblk = (nvox + kThreads - 1) / kThreads;
  const long long cap = 32LL * sm_count();
  if (nblk > cap) nblk = cap;
  if (C == 2) {
    softmax_vjp_c2_kernel<<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat162*>(g), static_cast<const __nv_bfloat162*>(y),
        static_cast<__nv_bfloat162*>(out), nvox);
  } else {
    softmax_vjp_kernel<<<(unsigned)nblk, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(out), nvox, C);
  }
  return cudaGetLastError();
}

// p and the K <= 3 targets: [B, nvox, C] bf16; out [B, 1 + 2K, C] f32, zeroed.
int vaeseg_dice_sums(const void* p, const void* t0, const void* t1, const void* t2,
                     void* out, int B, long long nvox, int C, int K, void* stream) {
  if (B <= 0 || B > 65535 || nvox <= 0 || C <= 0 || K < 1 || K > kMaxTargets)
    return cudaErrorInvalidValue;
  const void* ts[kMaxTargets] = {t0, t1, t2};
  DiceArgs a;
  a.p = static_cast<const __nv_bfloat16*>(p);
  for (int k = 0; k < kMaxTargets; ++k) {
    if (k < K && ts[k] == nullptr) return cudaErrorInvalidValue;
    a.t[k] = static_cast<const __nv_bfloat16*>(ts[k]);
  }
  a.out = static_cast<float*>(out);
  a.n = nvox * C;
  a.C = C; a.K = K;
  const size_t smem = sizeof(float) * (1 + 2 * K) * C;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  // a few blocks per SM across the batch, rounded up to a multiple of C so
  // that gx * kThreads is one
  long long gx = (a.n + (long long)kThreads * 8 - 1) / ((long long)kThreads * 8);
  const long long cap = (16LL * sm_count() + B - 1) / B;
  if (gx > cap) gx = cap;
  gx = (gx + C - 1) / C * C;
  dice_sums_kernel<<<dim3((unsigned)gx, B, 1), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
