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
//   across a sequential grid; here, for C dividing 8 (C == 2 in every call
//   of the nets), a thread reads 16-byte items of the 1 + K volumes (4
//   voxels of two classes), several in flight, and keeps the 1 + 2K sums of
//   each class in registers (a lane's class is fixed by its place in the
//   item); a block adds its threads' sums in a fixed order (a shuffle tree
//   in each warp, then the warps in order) and writes its [1 + 2K, C]
//   partial once, and common.cuh::parts_reduce adds the blocks' partials
//   in f64 in a fixed order: no atomics, the same bits on every run.
// dice_vjp is the VJP the JAX package attaches to dicesums.py::_run
//   (dicesums.py::_bwd, left to XLA there as one elementwise pass): dp and
//   the d t_k that are needed, from the cotangent rows g [B, 1 + 2K, C],
//   in one pass over the same items, with the plain version's roundings
//   (same bits).
//
// What bounds them on the H100: the bytes (3 volumes of traffic for
// softmax_vjp, 1 + K for dice_sums, up to 2 + 2K for dice_vjp; one or two
// operations an element).

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

// ---- dice_sums and its VJP. A batch entry's n = nvox * C elements are
// `items` 16-byte items (8 bf16: 8 / C voxels of C classes, C dividing 8;
// lane j of an item has class j % C) and then the elements from 8 items on
// (the tail, or all n where items is 0), one bf16 at a time. Grid (blocks,
// B) from ops/losses.py::dice_sums_plan: thread i = blockIdx.x * kThreads +
// threadIdx.x of batch entry blockIdx.y takes items i + k stride and then
// elements 8 items + i + k stride (stride = blocks * kThreads).

struct DiceArgs {
  const __nv_bfloat16* p;
  const __nv_bfloat16* t[kMaxTargets];
  float* part;     // [B, gridDim.x, 1 + 2K, C] block partials
  int64_t nvox;    // voxels a batch entry
  int64_t items;   // 16-byte items a batch entry (vector path), else 0
  int C, K;
};

// The 1 + 2K sums of a thread's elements of the element path, all of one
// class (the caller's stride and start keep it fixed).
__device__ __forceinline__ void dice_elements(const DiceArgs& a, int64_t base,
                                              int64_t from, int64_t stride,
                                              float (&el)[kRows]) {
  const int64_t n = a.nvox * a.C;
  for (int64_t e = from; e < n; e += stride) {
    const float pv = __bfloat162float(a.p[base + e]);
    el[0] += pv;
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k) {
      if (k < a.K) {
        const float tv = __bfloat162float(a.t[k][base + e]);
        el[1 + 2 * k] += tv;
        el[2 + 2 * k] = fmaf(pv, tv, el[2 + 2 * k]);
      }
    }
  }
}

// C dividing 8: 16-byte items, kUnroll items of each of the 1 + K volumes
// in flight a thread, the sums of each class in f32 registers; the element
// path's sums join the thread's class (tid % C: stride and 8 items are
// multiples of C). A block adds its threads' sums by a shuffle tree in each
// warp and then the warps in order, and writes its [1 + 2K, C] partial once.
template <int C>
__global__ void __launch_bounds__(kThreads) dice_sums_vec_kernel(const DiceArgs a) {
  const int b = blockIdx.y, rows = 1 + 2 * a.K;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t base = (int64_t)b * a.nvox * C;
  float acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  const uint4* pq = reinterpret_cast<const uint4*>(a.p + base);
  const uint4* tq[kMaxTargets];
#pragma unroll
  for (int k = 0; k < kMaxTargets; ++k)
    tq[k] = reinterpret_cast<const uint4*>(k < a.K ? a.t[k] + base : a.p + base);
  auto add = [&](const Item& pv, const Item& tv, int k) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 p2 = __bfloat1622float2(pv.h[h]), t2 = __bfloat1622float2(tv.h[h]);
      const int c0 = (2 * h) % C, c1 = (2 * h + 1) % C;
      acc[1 + 2 * k][c0] += t2.x;
      acc[1 + 2 * k][c1] += t2.y;
      acc[2 + 2 * k][c0] = fmaf(p2.x, t2.x, acc[2 + 2 * k][c0]);
      acc[2 + 2 * k][c1] = fmaf(p2.y, t2.y, acc[2 + 2 * k][c1]);
    }
  };
  auto add_pred = [&](const Item& pv) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 p2 = __bfloat1622float2(pv.h[h]);
      acc[0][(2 * h) % C] += p2.x;
      acc[0][(2 * h + 1) % C] += p2.y;
    }
  };
  Item pr[kUnroll], tr[kMaxTargets][kUnroll];
  int64_t e = first;
  for (; e + (kUnroll - 1) * stride < a.items; e += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pr[u].q = __ldcs(pq + e + u * stride);
#pragma unroll
      for (int k = 0; k < kMaxTargets; ++k)
        if (k < a.K) tr[k][u].q = __ldcs(tq[k] + e + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_pred(pr[u]);
#pragma unroll
      for (int k = 0; k < kMaxTargets; ++k)
        if (k < a.K) add(pr[u], tr[k][u], k);
    }
  }
  for (; e < a.items; e += stride) {
    pr[0].q = __ldcs(pq + e);
    add_pred(pr[0]);
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k) {
      if (k < a.K) {
        tr[k][0].q = __ldcs(tq[k] + e);
        add(pr[0], tr[k][0], k);
      }
    }
  }
  float el[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) el[r] = 0.f;
  dice_elements(a, base, 8 * a.items + first, stride, el);
  const int cls = threadIdx.x % C;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c == cls) acc[r][c] += el[r];

  __shared__ float wsum[kRows * C][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) wsum[r * C + c][warp] = v;
      }
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < rows * C) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += wsum[threadIdx.x][w];
    a.part[((int64_t)b * gridDim.x + blockIdx.x) * rows * C + threadIdx.x] = s;
  }
}

// Any C, element path only: gridDim.x * kThreads a multiple of C, so a
// thread's elements all have class first % C; a block adds its threads of
// one class in a fixed order in shared memory.
__global__ void __launch_bounds__(kThreads) dice_sums_kernel(const DiceArgs a) {
  __shared__ float sacc[kRows][kThreads];
  const int rows = 1 + 2 * a.K;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int64_t first = (int64_t)blockIdx.x * kThreads + tid;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  dice_elements(a, (int64_t)b * a.nvox * a.C, first, (int64_t)gridDim.x * kThreads, acc);
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

// The VJP of dice_sums (dicesums.py::_bwd), for the outputs whose pointer
// is set:
//   dp     = ((g0 + g2 t0) + g4 t1) + g6 t2        (rows of the K targets)
//   d t_k  = g(1 + 2k) + g(2 + 2k) p
// g[b, row, c] broadcast over the voxels, f32 math with one rounding per
// operation in the plain version's order, stored in bf16 (nearest even).
struct DiceVjpArgs {
  const __nv_bfloat16* p;
  const __nv_bfloat16* t[kMaxTargets];
  const float* g;                   // [B, 1 + 2K, C] f32
  __nv_bfloat16* dp;                // [B, nvox, C] or null
  __nv_bfloat16* dt[kMaxTargets];   // [B, nvox, C] or null, each
  int64_t nvox, items;
  int C, K;
};

__device__ __forceinline__ float dice_dp(float g0, const float* gi, const float* tv, int K) {
  float d = g0;
#pragma unroll
  for (int k = 0; k < kMaxTargets; ++k)
    if (k < K) d = __fadd_rn(d, __fmul_rn(gi[k], tv[k]));
  return d;
}

// The element path: elements from..n of batch entry b in steps of stride,
// the class of each from its index.
__device__ __forceinline__ void dice_vjp_elements(const DiceVjpArgs& a, int b,
                                                  int64_t from, int64_t stride) {
  const int rows = 1 + 2 * a.K;
  const int64_t n = a.nvox * a.C, base = (int64_t)b * n;
  const float* g = a.g + (int64_t)b * rows * a.C;
  for (int64_t e = from; e < n; e += stride) {
    const int c = (int)(e % a.C);
    const float pv = __bfloat162float(a.p[base + e]);
    if (a.dp != nullptr) {
      float tv[kMaxTargets], gi[kMaxTargets];
#pragma unroll
      for (int k = 0; k < kMaxTargets; ++k) {
        tv[k] = k < a.K ? __bfloat162float(a.t[k][base + e]) : 0.f;
        gi[k] = k < a.K ? g[(2 + 2 * k) * a.C + c] : 0.f;
      }
      a.dp[base + e] = __float2bfloat16_rn(dice_dp(g[c], gi, tv, a.K));
    }
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k)
      if (k < a.K && a.dt[k] != nullptr)
        a.dt[k][base + e] = __float2bfloat16_rn(
            __fadd_rn(g[(1 + 2 * k) * a.C + c], __fmul_rn(g[(2 + 2 * k) * a.C + c], pv)));
  }
}

// C dividing 8: the forward's items and plan; a thread loads kUnroll items
// of pred and of each target it needs before it stores one, one 16-byte
// store an item and output; g in registers.
template <int C>
__global__ void __launch_bounds__(kThreads) dice_vjp_vec_kernel(const DiceVjpArgs a) {
  const int b = blockIdx.y, rows = 1 + 2 * a.K;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t base = (int64_t)b * a.nvox * C;
  float gv[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) gv[r][c] = r < rows ? a.g[((int64_t)b * rows + r) * C + c] : 0.f;
  const bool need_dp = a.dp != nullptr;
  bool need_dt[kMaxTargets];
  bool any_dt = false;
#pragma unroll
  for (int k = 0; k < kMaxTargets; ++k) {
    need_dt[k] = k < a.K && a.dt[k] != nullptr;
    any_dt = any_dt || need_dt[k];
  }
  const uint4* pq = reinterpret_cast<const uint4*>(a.p + base);
  const uint4* tq[kMaxTargets];
  uint4* dtq[kMaxTargets];
#pragma unroll
  for (int k = 0; k < kMaxTargets; ++k) {
    tq[k] = reinterpret_cast<const uint4*>(k < a.K ? a.t[k] + base : a.p + base);
    dtq[k] = need_dt[k] ? reinterpret_cast<uint4*>(a.dt[k] + base) : nullptr;
  }
  uint4* dpq = need_dp ? reinterpret_cast<uint4*>(a.dp + base) : nullptr;

  auto load = [&](int64_t i, Item& pv, Item (&tv)[kMaxTargets]) {
    if (any_dt) pv.q = __ldcs(pq + i);
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k)
      if (need_dp && k < a.K) tv[k].q = __ldcs(tq[k] + i);
  };
  auto store = [&](int64_t i, const Item& pv, const Item (&tv)[kMaxTargets]) {
    if (need_dp) {
      Item o;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float2 t2[kMaxTargets];
#pragma unroll
        for (int k = 0; k < kMaxTargets; ++k)
          t2[k] = k < a.K ? __bfloat1622float2(tv[k].h[h]) : make_float2(0.f, 0.f);
        const int c0 = (2 * h) % C, c1 = (2 * h + 1) % C;
        float d0 = gv[0][c0], d1 = gv[0][c1];
#pragma unroll
        for (int k = 0; k < kMaxTargets; ++k) {
          if (k < a.K) {
            d0 = __fadd_rn(d0, __fmul_rn(gv[2 + 2 * k][c0], t2[k].x));
            d1 = __fadd_rn(d1, __fmul_rn(gv[2 + 2 * k][c1], t2[k].y));
          }
        }
        o.h[h] = __floats2bfloat162_rn(d0, d1);
      }
      dpq[i] = o.q;
    }
#pragma unroll
    for (int k = 0; k < kMaxTargets; ++k) {
      if (need_dt[k]) {
        Item o;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 p2 = __bfloat1622float2(pv.h[h]);
          const int c0 = (2 * h) % C, c1 = (2 * h + 1) % C;
          o.h[h] = __floats2bfloat162_rn(
              __fadd_rn(gv[1 + 2 * k][c0], __fmul_rn(gv[2 + 2 * k][c0], p2.x)),
              __fadd_rn(gv[1 + 2 * k][c1], __fmul_rn(gv[2 + 2 * k][c1], p2.y)));
        }
        dtq[k][i] = o.q;
      }
    }
  };
  Item pr[kUnroll], tr[kUnroll][kMaxTargets];
  int64_t e = first;
  for (; e + (kUnroll - 1) * stride < a.items; e += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load(e + u * stride, pr[u], tr[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) store(e + u * stride, pr[u], tr[u]);
  }
  for (; e < a.items; e += stride) {
    load(e, pr[0], tr[0]);
    store(e, pr[0], tr[0]);
  }
  dice_vjp_elements(a, b, 8 * a.items + first, stride);
}

// Any C, element path only.
__global__ void __launch_bounds__(kThreads) dice_vjp_kernel(const DiceVjpArgs a) {
  dice_vjp_elements(a, blockIdx.y, (int64_t)blockIdx.x * kThreads + threadIdx.x,
                    (int64_t)gridDim.x * kThreads);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The checks both dice launches share: the plan's items and grid, and the
// vector path's alignment (every volume, and so every batch entry's base,
// 16-byte aligned).
bool dice_plan_ok(int B, long long nvox, int C, int K, long long items, long long blocks,
                  const void* const* vols, int nvols) {
  if (B <= 0 || B > 65535 || nvox <= 0 || C <= 0 || K < 1 || K > kMaxTargets ||
      blocks <= 0 || blocks > 0x7fffffff || items < 0 || items > nvox * C / 8)
    return false;
  if (items == 0) return true;
  if (8 % C != 0 || (B > 1 && (nvox * C) % 8 != 0)) return false;
  for (int i = 0; i < nvols; ++i)
    if (vols[i] != nullptr && !aligned16(vols[i])) return false;
  return true;
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

// p and the K <= 3 targets: [B, nvox, C] bf16; part: [B, blocks, 1 + 2K, C]
// f32; out [B, 1 + 2K, C] f32, written whole; items and blocks from
// ops/losses.py::dice_sums_plan (items > 0 only for C dividing 8 and every
// volume 16-byte aligned, as every batch entry then is; for another C,
// blocks * 256 a multiple of C). Returns the first launch error.
int vaeseg_dice_sums(const void* p, const void* t0, const void* t1, const void* t2,
                     void* part, void* out, int B, long long nvox, int C, int K,
                     long long items, long long blocks, void* stream) {
  const void* vols[1 + kMaxTargets] = {p, t0, t1, t2};
  if (!dice_plan_ok(B, nvox, C, K, items, blocks, vols, 1 + K))
    return cudaErrorInvalidValue;
  DiceArgs a;
  a.p = static_cast<const __nv_bfloat16*>(p);
  for (int k = 0; k < kMaxTargets; ++k) {
    if (k < K && vols[1 + k] == nullptr) return cudaErrorInvalidValue;
    a.t[k] = static_cast<const __nv_bfloat16*>(vols[1 + k]);
  }
  a.part = static_cast<float*>(part);
  a.nvox = nvox;
  a.items = items;
  a.C = C;
  a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)B, 1);
  switch (C) {
    case 1: dice_sums_vec_kernel<1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: dice_sums_vec_kernel<2><<<grid, kThreads, 0, st>>>(a); break;
    case 4: dice_sums_vec_kernel<4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: dice_sums_vec_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
    default:
      if ((blocks * kThreads) % C != 0) return cudaErrorInvalidValue;
      dice_sums_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return parts_reduce<float>(a.part, static_cast<float*>(out), B, (int)blocks,
                             (1 + 2 * K) * C, st);
}

// The VJP of dice_sums: p and the targets as above, g [B, 1 + 2K, C] f32;
// dp and dt0..dt2 [B, nvox, C] bf16, each written whole where it is not
// null (dp needs the K targets, a d t_k needs p); items and blocks from
// dice_sums_plan with every volume, read or written, in its alignment.
int vaeseg_dice_vjp(const void* p, const void* t0, const void* t1, const void* t2,
                    const void* g, void* dp, void* dt0, void* dt1, void* dt2, int B,
                    long long nvox, int C, int K, long long items, long long blocks,
                    void* stream) {
  const void* vols[2 + 2 * kMaxTargets] = {p, t0, t1, t2, dp, dt0, dt1, dt2};
  if (!dice_plan_ok(B, nvox, C, K, items, blocks, vols, 2 + 2 * kMaxTargets) ||
      g == nullptr || p == nullptr)
    return cudaErrorInvalidValue;
  void* dts[kMaxTargets] = {dt0, dt1, dt2};
  DiceVjpArgs a;
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.g = static_cast<const float*>(g);
  a.dp = static_cast<__nv_bfloat16*>(dp);
  for (int k = 0; k < kMaxTargets; ++k) {
    if (k < K && dp != nullptr && vols[1 + k] == nullptr) return cudaErrorInvalidValue;
    if (k >= K && dts[k] != nullptr) return cudaErrorInvalidValue;
    a.t[k] = static_cast<const __nv_bfloat16*>(vols[1 + k]);
    a.dt[k] = static_cast<__nv_bfloat16*>(dts[k]);
  }
  a.nvox = nvox;
  a.items = items;
  a.C = C;
  a.K = K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks, (unsigned)B, 1);
  switch (C) {
    case 1: dice_vjp_vec_kernel<1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: dice_vjp_vec_kernel<2><<<grid, kThreads, 0, st>>>(a); break;
    case 4: dice_vjp_vec_kernel<4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: dice_vjp_vec_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
    default: dice_vjp_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
