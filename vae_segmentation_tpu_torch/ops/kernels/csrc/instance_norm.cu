// The fused parameter-free InstanceNorm(+ReLU) for Hopper (sm_90a), on
// channels-last bf16 volumes [B, N, C] (N = D * H * W voxels): two kernels,
// two modes each.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/instance_norm.py
//   norm_reduce, mode 0 (norm_stats):  _per_lane_stats,
//     out[b, 0, c] = sum_v x,  out[b, 1, c] = sum_v x^2;
//   norm_reduce, mode 1 (norm_bwd_sums): _bwd's first pallas_call,
//     out[b, 0, c] = sum_v g_m,  out[b, 1, c] = sum_v g_m * xhat;
//   norm_elementwise, mode 0 (norm_apply): _apply_per_lane with the fold
//     around it (_fold_lane_stats), y = [relu](xhat) and (s, t) from the f64
//     sums of mode 0 above;
//   norm_elementwise, mode 1 (norm_bwd_dx): _bwd's second pallas_call,
//     dx = s * ((g_m - m1) - xhat * m2), (m1, m2) the f64 sums of mode 1
//     above over the voxel count;
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
// launches: a norm's forward is the reduction's one or two kernels and the
// elementwise pass, which folds the statistics itself (no cast, no eager
// fold), and its backward likewise.
// Both kernels read an item at a time: where C % 8 == 0 (every norm of the
// nets: C 8-256) and the volumes are 16-byte aligned, 8 channels of one
// voxel in one 16-byte load (of x, and of g; the elementwise pass stores
// its item in one 16-byte store), else one element. A thread's items lie a
// stride apart that is a multiple of the C / 8 channel groups (of C), so
// its channel group is fixed: its (s, t), its (m1, m2) and the reduction's
// 8 lanes' f32 sums sit in registers, and no item needs a division. It
// loads kUnroll items at once before it uses them, so enough loads are in
// flight to keep HBM busy with a grid that fills the SMs. The reduction's
// block adds its threads' sums in a fixed
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
// The elementwise pass's grid comes from ops/instance_norm.py::
// norm_apply_plan. It rounds the f64 sums to f32 and folds them with one
// rounding per operation, as ops/instance_norm.py::affine_from_stats does
// on the card, so kernel and plain version give the same bits.

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
  const float* s;          // [B, C] scale (rstd), mode 1; null in mode 0
  const float* t;          // [B, C] shift (-mean * rstd)
  const double* sums;      // elementwise: [B, 2, C] f64 sums of mode 0 / 1
  float* s_out;            // elementwise mode 0: [B, C] the folded (s, t)
  float* t_out;
  float* part;             // reduce, two passes: [B, parts, 2, C] partials
  double* out;             // reduce, one launch: [B, 2, C] sums
  __nv_bfloat16* y;        // elementwise: [B, N, C]
  int64_t n;               // N * C elements per batch entry
  float inv_n;             // elementwise: 1 / N rounded to f32
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

// ---- the elementwise pass

constexpr float kEps = 1e-5f;   // ops/instance_norm.py::EPS

// One item of the vector path: 8 channels of a voxel, 16 bytes.
union Item {
  uint4 q;
  __nv_bfloat162 h[4];
};

// A sum of batch entry b's [2, C] f64 block as ops/instance_norm.py takes
// it on the card: rounded to f32 (the cast), times the f32 reciprocal of
// the voxel count (ATen divides by a CPU scalar so).
__device__ __forceinline__ float mean_of(const NormArgs& a, int b, int i) {
  return __fmul_rn(__double2float_rn(a.sums[(int64_t)b * 2 * a.C + i]),
                   a.inv_n);
}

// InstanceNorm's (scale, shift) of channel c of batch entry b, one rounding
// per torch operation of affine_from_stats: mean, E[x^2] - mean^2, clamp
// at 0 (NaN kept), + eps, rsqrtf (ATen's rsqrt for f32), -mean * rstd.
__device__ __forceinline__ void fold_affine(const NormArgs& a, int b, int c,
                                            float& s, float& t) {
  const float mean = mean_of(a, b, c);
  float var = __fsub_rn(mean_of(a, b, a.C + c), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;
  const float rstd = rsqrtf(__fadd_rn(var, kEps));
  s = rstd;
  t = __fmul_rn(-mean, rstd);
}

// One element: MODE 0 [relu](xhat); MODE 1 the plain version's order and
// roundings, s * ((g_m - m1) - xhat * m2).
template <int MODE>
__device__ __forceinline__ float elementwise(float x, float g, float s,
                                             float t, float m1, float m2,
                                             int relu) {
  const float xhat = pre_activation(x, s, t);
  if (MODE == 0) return (relu && xhat < 0.f) ? 0.f : xhat;
  const float gm = masked(g, xhat, relu);
  return __fmul_rn(s, __fsub_rn(__fsub_rn(gm, m1), __fmul_rn(xhat, m2)));
}

// Grid (blocks, B) from norm_apply_plan, blocks * kThreads a multiple of
// the item groups G = C / L. Thread i = blockIdx.x * kThreads + tid of
// batch entry b = blockIdx.y visits items i + k stride (stride = blocks *
// kThreads), an item being L = 8 channels of one voxel (VEC) or one
// element, so its channel group i % G is fixed: its L (s, t) pairs (MODE 0:
// folded here from the f64 sums; MODE 1: read, with (m1, m2) from the f64
// sums) sit in registers. kUnroll items are loaded before the first is
// stored. In MODE 0 the blocks with blockIdx.x == 0 also write (s, t) [B, C]
// (the backward's residuals), from the same fold, once their items are
// stored.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) norm_elementwise_kernel(const NormArgs a) {
  constexpr int L = VEC ? 8 : 1;
  const int b = blockIdx.y;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t items = VEC ? a.n >> 3 : a.n;
  const int G = VEC ? a.C >> 3 : a.C;
  const int c0 = (int)(first % G) * L;
  float s[L], t[L], m1[L], m2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (MODE == 0) {
      fold_affine(a, b, c0 + j, s[j], t[j]);
      m1[j] = m2[j] = 0.f;
    } else {
      s[j] = a.s[b * a.C + c0 + j];
      t[j] = a.t[b * a.C + c0 + j];
      m1[j] = mean_of(a, b, c0 + j);
      m2[j] = mean_of(a, b, a.C + c0 + j);
    }
  }
  const __nv_bfloat16* xb = a.x + (int64_t)b * a.n;
  const __nv_bfloat16* gb = MODE == 1 ? a.g + (int64_t)b * a.n : nullptr;
  __nv_bfloat16* yb = a.y + (int64_t)b * a.n;
  if (VEC) {
    const uint4* xq = reinterpret_cast<const uint4*>(xb);
    const uint4* gq = reinterpret_cast<const uint4*>(gb);
    uint4* yq = reinterpret_cast<uint4*>(yb);
    auto apply = [&](const Item& xv, const Item& gv) {
      Item out;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 x2 = __bfloat1622float2(xv.h[h]);
        const float2 g2 = MODE == 1 ? __bfloat1622float2(gv.h[h])
                                    : make_float2(0.f, 0.f);
        out.h[h] = __floats2bfloat162_rn(
            elementwise<MODE>(x2.x, g2.x, s[2 * h], t[2 * h], m1[2 * h],
                              m2[2 * h], a.relu),
            elementwise<MODE>(x2.y, g2.y, s[2 * h + 1], t[2 * h + 1],
                              m1[2 * h + 1], m2[2 * h + 1], a.relu));
      }
      return out.q;
    };
    Item xr[kUnroll], gr[kUnroll];
    int64_t e = first;
    for (; e + (kUnroll - 1) * stride < items; e += kUnroll * stride) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        xr[k].q = __ldcs(xq + e + k * stride);
        gr[k].q = MODE == 1 ? __ldcs(gq + e + k * stride) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) yq[e + k * stride] = apply(xr[k], gr[k]);
    }
    for (; e < items; e += stride) {
      xr[0].q = __ldcs(xq + e);
      gr[0].q = MODE == 1 ? __ldcs(gq + e) : make_uint4(0, 0, 0, 0);
      yq[e] = apply(xr[0], gr[0]);
    }
  } else {
    for (int64_t e = first; e < items; e += stride) {
      const float g = MODE == 1 ? __bfloat162float(gb[e]) : 0.f;
      yb[e] = __float2bfloat16(elementwise<MODE>(
          __bfloat162float(xb[e]), g, s[0], t[0], m1[0], m2[0], a.relu));
    }
  }
  // last: stores to (s, t) before the loop would keep the compiler from
  // issuing x's loads ahead of them (the pointers may alias)
  if (MODE == 0 && blockIdx.x == 0) {
    for (int c = threadIdx.x; c < a.C; c += kThreads)
      fold_affine(a, b, c, a.s_out[b * a.C + c], a.t_out[b * a.C + c]);
  }
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
  a.sums = nullptr;
  a.s_out = a.t_out = nullptr;
  a.part = static_cast<float*>(part);
  a.out = static_cast<double*>(sums);
  a.y = nullptr;
  a.n = nvox * C;
  a.inv_n = 0.f;
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

// x: [B, nvox, C] bf16; sums: [B, 2, C] f64, the reduction's output (mode
// 0's for the forward, mode 1's for the backward); y: [B, nvox, C] bf16.
// Without g, the forward's apply (mode 0): s, t [B, C] f32 are written,
// the fold of sums. With g ([B, nvox, C] bf16), the backward's dx (mode 1):
// s, t are read. blocks (ops/instance_norm.py::norm_apply_plan): a batch
// entry's, blocks * kThreads a multiple of the item groups (C / 8 with
// vec: C % 8 == 0 and x, g, y 16-byte aligned; else C).
// Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_norm_elementwise(const void* x, const void* g, void* s, void* t,
                            const void* sums, void* y, int relu, int B,
                            long long nvox, int C, long long blocks, int vec,
                            void* stream) {
  if (bad_shape(B, nvox, C) || s == nullptr || t == nullptr ||
      sums == nullptr || y == nullptr)
    return cudaErrorInvalidValue;
  const bool bwd = g != nullptr;
  if (vec && ((C & 7) != 0 || !aligned16(x) || !aligned16(y) ||
              (bwd && !aligned16(g))))
    return cudaErrorInvalidValue;
  const int groups = vec ? C >> 3 : C;
  if (blocks <= 0 || blocks > 0x7fffffff || blocks * kThreads % groups != 0)
    return cudaErrorInvalidValue;
  NormArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.s = bwd ? static_cast<const float*>(s) : nullptr;
  a.t = bwd ? static_cast<const float*>(t) : nullptr;
  a.sums = static_cast<const double*>(sums);
  a.s_out = bwd ? nullptr : static_cast<float*>(s);
  a.t_out = bwd ? nullptr : static_cast<float*>(t);
  a.part = nullptr;
  a.out = nullptr;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.n = nvox * C;
  // as ATen divides an f32 tensor by the voxel count (a CPU scalar): the
  // f32 reciprocal of the count as f32, rounded on the host
  a.inv_n = 1.0f / static_cast<float>(nvox);
  a.C = C;
  a.relu = relu;
  const dim3 grid((unsigned)blocks, B, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bwd) {
    if (vec) norm_elementwise_kernel<1, true><<<grid, kThreads, 0, st>>>(a);
    else norm_elementwise_kernel<1, false><<<grid, kThreads, 0, st>>>(a);
  } else {
    if (vec) norm_elementwise_kernel<0, true><<<grid, kThreads, 0, st>>>(a);
    else norm_elementwise_kernel<0, false><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
