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
// element), and at the deep stages (32^3 and below, a few MB or less) the
// launches. The elementwise kernel walks the flat [N * C] slice of one
// batch entry with a stride that is a multiple of C, so every element a
// thread visits belongs to one channel: its (s, t, m1, m2) sit in registers
// and no element needs a division, while neighbouring threads read
// neighbouring addresses.
// The reduction (norm_reduce_kernel, norm_reduce_cluster_kernel) reads an
// item at a time: where C % 8 == 0 (every norm of the nets: C 8-256) 8
// channels of one voxel in one 16-byte load (of x, and of g), else one
// element. A thread's items lie a stride apart that is a multiple of the
// C / 8 channel groups (of C), so its channel group is fixed: its (s, t)
// and its 8 lanes' f32 sums sit in registers. It loads kUnroll items at
// once before it adds them, so enough loads are in flight to keep HBM busy
// with a grid that fills the SMs. A block adds its threads' sums in a fixed
// order: the lanes of a channel group by warp shuffles (a butterfly, whose
// lanes end with the same bits), the warps in order (or, for channel group
// counts that are not a power of two up to 32, each channel's threads in
// order in shared memory). Two plans (ops/instance_norm.py::
// norm_reduce_plan):
// - two passes, for the large calls: `parts` blocks a batch entry each
//   write their [2, C] f32 partial once, and a second pass
//   (common.cuh::parts_reduce) adds them in f64 in a fixed order;
// - one launch, for the small calls, whose two dependent launches cost more
//   than their bytes: a thread-block cluster of kCluster blocks a batch
//   entry (portable size); the blocks leave their [2, C] partials in shared
//   memory, and after cluster.sync() rank 0 adds them through distributed
//   shared memory in rank order, in f64, and writes the f64 sums whole.
// At 128^3 a channel sums 2.1M voxels, and sum g_m * xhat cancels far below
// its terms: every partial past a thread's is added in f64 or in a fixed
// f32 tree of at most 256 terms. No atomics: the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct NormArgs {
  const __nv_bfloat16* x;  // [B, N, C]
  const __nv_bfloat16* g;  // [B, N, C] cotangent (mode 1), or null
  const float* s;          // [B, C] scale (rstd), or null in mode 0 of reduce
  const float* t;          // [B, C] shift (-mean * rstd)
  const float* m;          // [B, 2, C] (m1, m2), elementwise mode 1
  float* part;             // reduce, two passes: [B, parts, 2, C] partials
  double* out;             // reduce, one launch: [B, 2, C] sums
  __nv_bfloat16* y;        // elementwise: [B, N, C]
  int64_t n;               // N * C elements per batch entry
  int C, relu;
};

__device__ __forceinline__ float masked(float g, float xhat, int relu) {
  return (!relu || xhat > 0.f) ? g : 0.f;
}

// ---- the reduction

constexpr int kCluster = 8;         // blocks a batch entry, one-launch plan
constexpr int kClusterMaxC = 1024;  // channels the one-launch plan takes
constexpr int kUnroll = 4;          // items a thread loads before it adds them

// The f32 sums of this thread's items first + k stride of batch entry b:
// an item is 8 channels of one voxel (VEC) or one element, L = 8 or 1 lanes;
// stride is a multiple of the item groups G = C / L, so every item holds
// the channels of group first % G. kUnroll items are loaded before they
// are added. MODE 0: (sum x, sum x^2); MODE 1: (sum g_m, sum g_m * xhat).
template <int MODE, bool VEC>
__device__ __forceinline__ void thread_sums(const NormArgs& a, int b,
                                            int64_t first, int64_t stride,
                                            float acc0[], float acc1[]) {
  constexpr int L = VEC ? 8 : 1;
  const int64_t items = VEC ? a.n >> 3 : a.n;
  const int G = VEC ? a.C >> 3 : a.C;
  const int c0 = (int)(first % G) * L;
  float s[L], t[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    acc0[j] = acc1[j] = 0.f;
    s[j] = MODE == 1 ? a.s[b * a.C + c0 + j] : 0.f;
    t[j] = MODE == 1 ? a.t[b * a.C + c0 + j] : 0.f;
  }
  const __nv_bfloat16* xb = a.x + (int64_t)b * a.n;
  const __nv_bfloat16* gb = MODE == 1 ? a.g + (int64_t)b * a.n : nullptr;
  auto add = [&](const __nv_bfloat16* xv, const __nv_bfloat16* gv) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float x = __bfloat162float(xv[j]);
      if (MODE == 0) {
        acc0[j] += x;
        acc1[j] = fmaf(x, x, acc1[j]);
      } else {
        const float xhat = pre_activation(x, s[j], t[j]);
        const float gm = masked(__bfloat162float(gv[j]), xhat, a.relu);
        acc0[j] += gm;
        acc1[j] = fmaf(gm, xhat, acc1[j]);
      }
    }
  };
  int64_t e = first;
  if (VEC) {
    const uint4* xq = reinterpret_cast<const uint4*>(xb);
    const uint4* gq = reinterpret_cast<const uint4*>(gb);
    uint4 xr[kUnroll], gr[kUnroll];
    for (; e + (kUnroll - 1) * stride < items; e += kUnroll * stride) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        xr[k] = __ldcs(xq + e + k * stride);
        if (MODE == 1) gr[k] = __ldcs(gq + e + k * stride);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        add(reinterpret_cast<const __nv_bfloat16*>(&xr[k]),
            reinterpret_cast<const __nv_bfloat16*>(&gr[k]));
    }
    for (; e < items; e += stride) {
      xr[0] = __ldcs(xq + e);
      if (MODE == 1) gr[0] = __ldcs(gq + e);
      add(reinterpret_cast<const __nv_bfloat16*>(&xr[0]),
          reinterpret_cast<const __nv_bfloat16*>(&gr[0]));
    }
  } else {
    for (; e < items; e += stride) add(xb + e, MODE == 1 ? gb + e : nullptr);
  }
}

// The [2, C] f32 sums of a block (block blk of nblk of batch entry b) into
// out[0 .. 2C), in a fixed order. red: kThreads * 16 floats of shared
// scratch.
template <int MODE, bool VEC>
__device__ __forceinline__ void block_sums(const NormArgs& a, int b, int blk,
                                           int nblk, float* red, float* out) {
  constexpr int L = VEC ? 8 : 1, WARPS = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = VEC ? a.C >> 3 : a.C;
  float acc0[L], acc1[L];
  thread_sums<MODE, VEC>(a, b, (int64_t)blk * kThreads + tid,
                         (int64_t)nblk * kThreads, acc0, acc1);
  // the group of the block's thread 0; thread tid holds group (g0 + tid) % G
  const int g0 = (int)((int64_t)blk * kThreads % G);
  if (g0 == 0 && G <= 32 && (G & (G - 1)) == 0) {
    // lane l holds group l % G: a butterfly over the lanes of each group
    // (commutative adds: its lanes end with the same bits), then the warps
    // in order; red[(warp 2 + r) C + c], C = G L <= 256
    for (int o = 16; o >= G; o >>= 1)
#pragma unroll
      for (int j = 0; j < L; ++j) {
        acc0[j] += __shfl_xor_sync(0xffffffffu, acc0[j], o);
        acc1[j] += __shfl_xor_sync(0xffffffffu, acc1[j], o);
      }
    if (lane < G) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        red[(warp * 2 + 0) * a.C + lane * L + j] = acc0[j];
        red[(warp * 2 + 1) * a.C + lane * L + j] = acc1[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * a.C; i += kThreads) {
      const int r = i / a.C, c = i - r * a.C;
      float sum = 0.f;
      for (int w = 0; w < WARPS; ++w) sum += red[(w * 2 + r) * a.C + c];
      out[i] = sum;
    }
  } else {
    // each channel's threads in order: red[(r L + j) kThreads + tid]
#pragma unroll
    for (int j = 0; j < L; ++j) {
      red[(0 * L + j) * kThreads + tid] = acc0[j];
      red[(1 * L + j) * kThreads + tid] = acc1[j];
    }
    __syncthreads();
    for (int i = tid; i < 2 * a.C; i += kThreads) {
      const int r = i / a.C, c = i - r * a.C, grp = c / L, j = c - grp * L;
      float sum = 0.f;
      for (int k = (grp - g0 + G) % G; k < kThreads; k += G)
        sum += red[(r * L + j) * kThreads + k];
      out[i] = sum;
    }
  }
}

// The two-pass plan's first pass: grid (parts, B), parts * kThreads a
// multiple of the item groups; block (blk, b) writes its [2, C] partial to
// part[b, blk] once.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) norm_reduce_kernel(const NormArgs a) {
  __shared__ float red[kThreads * 16];
  const int b = blockIdx.y;
  block_sums<MODE, VEC>(
      a, b, blockIdx.x, gridDim.x, red,
      a.part + ((int64_t)b * gridDim.x + blockIdx.x) * 2 * a.C);
}

// The one-launch plan: grid (kCluster, B), one cluster a batch entry, C a
// multiple of 8. Each block leaves its [2, C] f32 sums in its shared
// memory; rank 0 adds the ranks' in rank order in f64 and writes out[b]
// whole.
template <int MODE>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    norm_reduce_cluster_kernel(const NormArgs a) {
  __shared__ float red[kThreads * 16];
  __shared__ float sums[2 * kClusterMaxC];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  block_sums<MODE, true>(a, b, (int)cluster.block_rank(), kCluster, red,
                         sums);
  cluster.sync();   // every rank's sums are in its shared memory
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < 2 * a.C; i += kThreads) {
      double total = 0.0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        total += cluster.map_shared_rank(sums, r)[i];
      a.out[(int64_t)b * 2 * a.C + i] = total;
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its shared memory
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

// The elementwise kernel's blocks per batch entry: enough for eight elements
// a thread, at most ~16 blocks per SM over the batch, rounded up so that
// the stride gx * kThreads is a multiple of C.
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
// backward's (mode 1, g given too); sums: [B, 2, C] f64, written whole.
// parts (ops/instance_norm.py::norm_reduce_plan): 0 for the one-launch plan
// (C a multiple of 8 up to kClusterMaxC, C / 8 a power of two, x and g
// 16-byte aligned; part unused), else the blocks a batch entry of the
// two-pass plan, parts * kThreads a multiple of the item groups (C / 8
// where C % 8 == 0 and x and g are 16-byte aligned, else C), with part its
// [B, parts, 2, C] f32 workspace. Returns the first launch error (0 on
// success).
int vaeseg_norm_reduce(const void* x, const void* g, const void* s, const void* t,
                       void* part, long long parts, void* sums, int relu, int B,
                       long long nvox, int C, void* stream) {
  if (bad_shape(B, nvox, C) || sums == nullptr) return cudaErrorInvalidValue;
  const bool bwd = g != nullptr;
  if (bwd != (s != nullptr) || bwd != (t != nullptr)) return cudaErrorInvalidValue;
  NormArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.m = nullptr;
  a.part = static_cast<float*>(part);
  a.out = static_cast<double*>(sums);
  a.y = nullptr;
  a.n = nvox * C;
  a.C = C;
  a.relu = relu;
  const bool vec = (C & 7) == 0 && aligned16(x) && (!bwd || aligned16(g));
  const int groups = vec ? C >> 3 : C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts == 0) {
    if (!vec || C > kClusterMaxC || (groups & (groups - 1)) != 0)
      return cudaErrorInvalidValue;
    const dim3 grid(kCluster, B, 1);
    if (bwd)
      norm_reduce_cluster_kernel<1><<<grid, kThreads, 0, st>>>(a);
    else
      norm_reduce_cluster_kernel<0><<<grid, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (parts < 0 || parts > 0x7fffffff || part == nullptr ||
      parts * kThreads % groups != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)parts, B, 1);
  if (bwd) {
    if (vec) norm_reduce_kernel<1, true><<<grid, kThreads, 0, st>>>(a);
    else norm_reduce_kernel<1, false><<<grid, kThreads, 0, st>>>(a);
  } else {
    if (vec) norm_reduce_kernel<0, true><<<grid, kThreads, 0, st>>>(a);
    else norm_reduce_kernel<0, false><<<grid, kThreads, 0, st>>>(a);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return parts_reduce<double>(a.part, a.out, B, (int)parts, 2 * C, st);
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
  a.part = nullptr;
  a.out = nullptr;
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
