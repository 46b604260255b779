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
//   product is needed. For C == 2 (every call of the nets) a thread reads
//   4 voxels of g and of y a 16-byte load and stores them in one, several
//   in flight, with the plain version's roundings (same bits).
// dice_sums replaces ops/pallas/dicesums.py::_run: for K <= 3 targets,
//   out[b, 0, c]      = sum_v p[b, v, c]
//   out[b, 1 + 2k, c] = sum_v t_k[b, v, c]
//   out[b, 2 + 2k, c] = sum_v p[b, v, c] * t_k[b, v, c]
//   in f32, every volume read once. The TPU kernel carried its [8, L] block
//   across a sequential grid; here each thread keeps 1 + 2K sums of one
//   class (its stride is a multiple of C), a block adds its threads of one
//   class in a fixed order in shared memory and writes its [1 + 2K, C]
//   partial once, and common.cuh::parts_reduce adds the blocks' partials in
//   f64 in a fixed order: no atomics, the same bits on every run.
//
// What bounds them on the H100: the bytes (3 and 1 + K volumes of traffic,
// one or two operations per element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTargets = 3;
constexpr int kRows = 1 + 2 * kMaxTargets;

constexpr int kUnroll = 4;   // items a thread loads before it stores one

// One voxel of two classes, the plain version's roundings: the dot as two
// products and one sum, then (g - dot) * y, each rounded once (no
// contraction into a fused multiply-add).
__device__ __forceinline__ __nv_bfloat162 vjp2(__nv_bfloat162 gv, __nv_bfloat162 yv) {
  const float2 g = __bfloat1622float2(gv), y = __bfloat1622float2(yv);
  const float dot = __fadd_rn(__fmul_rn(g.x, y.x), __fmul_rn(g.y, y.y));
  return __floats2bfloat162_rn(__fmul_rn(__fsub_rn(g.x, dot), y.x),
                               __fmul_rn(__fsub_rn(g.y, dot), y.y));
}

// Four voxels of two classes, 16 bytes.
union Item {
  uint4 q;
  __nv_bfloat162 h[4];
};

// C == 2, g, y, out [nvox, 2] bf16, grid from ops/losses.py::
// softmax_vjp_plan. Thread i = blockIdx.x * kThreads + tid visits items
// i + k stride (stride = gridDim.x * kThreads), an item being 4 voxels: one
// 16-byte load of g and of y, one 16-byte store; kUnroll items are loaded
// before the first is stored. The voxels from 4 * items on (the tail of
// nvox % 4, or every voxel where a tensor is not 16-byte aligned and items
// is 0) take the element path in the same launch: voxel 4 items + i + k
// stride, one bf16 a load.
__global__ void __launch_bounds__(kThreads) softmax_vjp_c2_kernel(
    const __nv_bfloat16* g, const __nv_bfloat16* y, __nv_bfloat16* out,
    int64_t nvox, int64_t items) {
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uint4* gq = reinterpret_cast<const uint4*>(g);
  const uint4* yq = reinterpret_cast<const uint4*>(y);
  uint4* oq = reinterpret_cast<uint4*>(out);
  auto apply = [](const Item& gv, const Item& yv) {
    Item o;
#pragma unroll
    for (int h = 0; h < 4; ++h) o.h[h] = vjp2(gv.h[h], yv.h[h]);
    return o.q;
  };
  Item gr[kUnroll], yr[kUnroll];
  int64_t e = first;
  for (; e + (kUnroll - 1) * stride < items; e += kUnroll * stride) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      gr[k].q = __ldcs(gq + e + k * stride);
      yr[k].q = __ldcs(yq + e + k * stride);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) oq[e + k * stride] = apply(gr[k], yr[k]);
  }
  for (; e < items; e += stride) {
    gr[0].q = __ldcs(gq + e);
    yr[0].q = __ldcs(yq + e);
    oq[e] = apply(gr[0], yr[0]);
  }
  for (int64_t v = 4 * items + first; v < nvox; v += stride) {
    const __nv_bfloat162 r = vjp2(__halves2bfloat162(g[2 * v], g[2 * v + 1]),
                                  __halves2bfloat162(y[2 * v], y[2 * v + 1]));
    out[2 * v] = __low2bfloat16(r);
    out[2 * v + 1] = __high2bfloat16(r);
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
  float* part;     // [B, gridDim.x, 1 + 2K, C] block partials
  int64_t n;       // elements per batch entry: voxels * C
  int C, K;
};

// grid (gx, B) with gx * kThreads a multiple of C: a thread's elements all
// belong to one class.
__global__ void __launch_bounds__(kThreads) dice_sums_kernel(const DiceArgs a) {
  __shared__ float sacc[kRows][kThreads];
  const int rows = 1 + 2 * a.K;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
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
#pragma unroll
  for (int r = 0; r < kRows; ++r) sacc[r][tid] = acc[r];
  __syncthreads();
  // the threads of class c are tid = (c - first class) mod C + k C
  const int c0 = (int)((int64_t)blockIdx.x * kThreads % a.C);
  for (int i = tid; i < rows * a.C; i += kThreads) {
    const int r = i / a.C, c = i % a.C;
    float sum = 0.f;
    for (int k = (c - c0 + a.C) % a.C; k < kThreads; k += a.C) sum += sacc[r][k];
    a.part[((int64_t)b * gridDim.x + blockIdx.x) * rows * a.C + i] = sum;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// Blocks a batch entry of vaeseg_dice_sums launches: a few per SM across
// the batch, rounded up to a multiple of C so that gx * kThreads is one.
long long dice_grid_x(int B, long long nvox, int C) {
  const long long n = nvox * C;
  long long gx = (n + (long long)kThreads * 8 - 1) / ((long long)kThreads * 8);
  const long long cap = (16LL * sm_count() + B - 1) / B;
  if (gx > cap) gx = cap;
  return (gx + C - 1) / C * C;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g, y, out: [nvox, C] bf16; items and blocks from ops/losses.py::
// softmax_vjp_plan: items the 4-voxel items of the vector path (C == 2 and
// g, y, out 16-byte aligned; at most nvox / 4), else 0; blocks the grid.
// Returns cudaGetLastError() after the launch.
int vaeseg_softmax_vjp(const void* g, const void* y, void* out, long long nvox,
                       int C, long long items, long long blocks, void* stream) {
  if (nvox <= 0 || C <= 0 || blocks <= 0 || blocks > 0x7fffffff || items < 0 ||
      items > nvox / 4)
    return cudaErrorInvalidValue;
  if (items > 0 && (C != 2 || !aligned16(g) || !aligned16(y) || !aligned16(out)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (C == 2)
    softmax_vjp_c2_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(gb, yb, ob, nvox, items);
  else
    softmax_vjp_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(gb, yb, ob, nvox, C);
  return cudaGetLastError();
}

// The workspace vaeseg_dice_sums needs: [B, vaeseg_dice_parts, 1 + 2K, C]
// f32.
long long vaeseg_dice_parts(int B, long long nvox, int C) {
  if (B <= 0 || nvox <= 0 || C <= 0) return 0;
  return dice_grid_x(B, nvox, C);
}

// p and the K <= 3 targets: [B, nvox, C] bf16; part the workspace above,
// of parts = vaeseg_dice_parts(B, nvox, C) blocks; out [B, 1 + 2K, C] f32,
// written whole. Returns the first launch error.
int vaeseg_dice_sums(const void* p, const void* t0, const void* t1, const void* t2,
                     void* part, long long parts, void* out, int B,
                     long long nvox, int C, int K, void* stream) {
  if (B <= 0 || B > 65535 || nvox <= 0 || C <= 0 || K < 1 || K > kMaxTargets)
    return cudaErrorInvalidValue;
  const void* ts[kMaxTargets] = {t0, t1, t2};
  DiceArgs a;
  a.p = static_cast<const __nv_bfloat16*>(p);
  for (int k = 0; k < kMaxTargets; ++k) {
    if (k < K && ts[k] == nullptr) return cudaErrorInvalidValue;
    a.t[k] = static_cast<const __nv_bfloat16*>(ts[k]);
  }
  a.part = static_cast<float*>(part);
  a.n = nvox * C;
  a.C = C; a.K = K;
  const long long gx = dice_grid_x(B, nvox, C);
  if (gx != parts || gx > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dice_sums_kernel<<<dim3((unsigned)gx, B, 1), kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return parts_reduce<float>(a.part, static_cast<float*>(out), B, (int)gx,
                             (1 + 2 * K) * C, st);
}

}  // extern "C"
