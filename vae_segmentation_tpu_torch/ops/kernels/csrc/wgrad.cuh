// The weight gradient of the port's convs on the tensor cores, shared by
// conv3_dk.cu (K1: the 3^3 SAME conv, 27 taps) and bridge_bwd.cu (K2 and
// K3: the 2^3 stride-2 bridges, 8 taps).
//
// Every one of them is a small GEMM with a huge reduction dimension: the
// voxels of the batch. Two operands, both channels-last bf16:
//   T, the "tapped" tensor, read at a tap's offset from each voxel:
//     K1: x (the halo of the tile, through the norm+ReLU prologue),
//     K2: x on the fine grid (fine voxel 2i + a of coarse voxel i, with the
//         prologue), K3: gy on the fine grid (no prologue);
//   D, the "dense" tensor, read at the voxel itself:
//     K1: gy, K2: gy on the coarse grid, K3: x on the coarse grid;
// and dk[tap, (T channel), (D channel)] = sum_voxels T[v @ tap] * D[v]
// (K3 stores the transpose: dk[a, c, o] with c the D and o the T channel).
// M = (tap, T channel), N = D channel, K = voxels: stacking the taps into M
// fills the m16n8k16 tiles also at 8 channels (M = 216 for K1 at Cin 8).
//
// Design (what bounds these on an H100 is the bytes at the 128^3 / 64^3
// stages and the operations at the deep ones):
// - mma.sync.m16n8k16 bf16 x bf16 -> f32. Both operands are transposes of
//   their channels-last tiles (rows = voxels), so they come in through
//   ldmatrix.trans; each lane hands ldmatrix the address of one voxel row,
//   so the im2col of the 27 (or 8) taps is an address offset, never a copy.
// - A block owns one T-channel chunk (8 or 16 wide) and one D-channel chunk
//   (8, 16 or 32) and walks a contiguous range of voxel tiles (split-K).
//   A tile's rows are staged once into a two-slot ring in shared memory by
//   cp.async (16 bytes a lane; zero-fill outside the volume), so the next
//   tile's copy overlaps this tile's MMAs. Channel counts that are not a
//   multiple of 8 are staged by plain loads and zero-padded, not refused.
// - Tile geometry (each staged row's position, each voxel's halo row) is
//   worked out once per block into tables; no loop divides per element.
// - The prologue's f32 xn = relu(x * s + t) (rounded as common.cuh) is
//   split xn = hi + lo, hi = bf16(xn), lo = bf16(xn - hi), and each product
//   is issued as two MMAs: about 2^-17 relative error a term, where one
//   bf16 rounding (2^-9) would miss the gates on the sums that cancel
//   under an InstanceNorm. Without the prologue both operands are bf16 and
//   one MMA is exact.
// - The tensor cores' f32 accumulation truncates rather than rounds, so a
//   long chain of MMAs drifts toward zero (2.2e-4 of dk's largest element
//   on the image's entry conv at 128^3, measured on an H100): each tile's
//   MMAs (8 k-steps at most) start from zero, and the tile's sum joins the
//   block's f32 total by a rounded add.
// - No atomics: each block writes its f32 partial [taps, chunk, chunk]
//   once into a workspace [splits, taps, Cin, Cout] (db: f64 [splits,
//   Cout], summed in f64 by the blocks of the first chunk), and
//   dk_reduce_kernel adds the splits in a fixed order in f64. The result is
//   the same bit for bit on every run.
// The split plan (tile, chunks, splits) is computed by the Python wrapper
// (ops/conv3.py::wgrad_plan) and passed in; weight_grad() checks it and
// lays out the shared memory it needs (dk_layout), refusing a plan that
// does not fit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace wgrad {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kMerged names dk_reduce_kernel after the merged conv backward
// (conv3_bwd.cu), which adds its own blocks' dk partials with it
enum Mode { kConv3 = 0, kDown = 1, kUp = 2, kMerged = 3 };

// the plan's fields, in order (ops/conv3.py::wgrad_plan)
enum PlanField {
  kPlanMode, kPlanTd, kPlanTh, kPlanTw, kPlanTilesD, kPlanTilesH,
  kPlanTilesW, kPlanCi, kPlanCo, kPlanTChunks, kPlanDChunks, kPlanSplits,
  kPlanMtw
};

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ok false zero-fills without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- end of the PTX wrappers

// a staged row's position relative to its tile's origin, 10 bits a
// coordinate; -1 for a row that is never in the volume
__host__ __device__ inline int pack(int d, int h, int w) {
  return (d << 20) | (h << 10) | w;
}

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// shared-memory row stride of a chunk of `cw` channels, in bf16: 16-byte
// rows, an odd number of 16-byte units apart (ldmatrix without bank
// conflicts)
__host__ __device__ inline int row_stride(int cw) {
  return (cw / 8) % 2 == 1 ? cw : cw + 8;
}

// byte offsets of the dk kernel's shared memory
struct Layout {
  int t_raw, d_raw, hi, lo, tpos, dpos, arow, db, bytes;
};

__host__ __device__ inline Layout dk_layout(int trows, int tstr, int kpad,
                                            int dstr, bool split) {
  Layout l;
  l.t_raw = 0;                                 // [2][trows][tstr] bf16
  l.d_raw = l.t_raw + 2 * trows * tstr * 2;    // [2][kpad][dstr]
  l.hi = l.d_raw + 2 * kpad * dstr * 2;        // [trows][tstr] (prologue)
  l.lo = l.hi + (split ? trows * tstr * 2 : 0);
  l.tpos = l.lo + (split ? trows * tstr * 2 : 0);  // [trows] int
  l.dpos = l.tpos + trows * 4;                 // [kpad] int
  l.arow = l.dpos + kpad * 4;                  // [kpad] int
  l.db = round_up(l.arow + kpad * 4, 8);        // [kThreads] double
  l.bytes = l.db + kThreads * 8;
  return l;
}

struct Args {
  const __nv_bfloat16* t;   // tapped operand [B, tD, tH, tW, tC]
  const __nv_bfloat16* d;   // dense operand [B, dD, dH, dW, dC]
  const float* s;           // [B, tC] prologue scale on T, or null
  const float* sh;          // [B, tC] prologue shift
  float* ws;                // [splits, taps, Cin, Cout] f32 partials
  double* wsdb;             // [splits, Cout] f64 partials of db
  int B, tD, tH, tW, tC, dD, dH, dW, dC;
  int dlo, dhi;             // K1's valid T-plane range under the prologue
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int ci, t_chunks, d_chunks, splits;
  int nvox, kpad, trows, tstr, dstr;
};

// Stage `rows` rows of `cw` channels (from channel c0) of a channels-last
// tensor into shared memory, row r from the tensor's voxel origin +
// unpack(pos[r]) of batch b; rows outside the volume and channels past C
// are zero. cp.async where C is a multiple of 8, else plain loads.
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* dst, int str, const int* pos, int rows,
    const __nv_bfloat16* src, int b, int D, int H, int W, int C, int c0,
    int cw, int od, int oh, int ow) {
  const int lg = cw == 8 ? 0 : cw == 16 ? 1 : 2;
  const bool vec = (C & 7) == 0;
  for (int i = threadIdx.x; i < (rows << lg); i += kThreads) {
    const int row = i >> lg, g = i & ((1 << lg) - 1);
    const int pp = pos[row];
    const int gd = od + (pp >> 20), gh = oh + ((pp >> 10) & 1023),
              gw = ow + (pp & 1023);
    const int c = c0 + 8 * g;
    const bool ok = pp >= 0 && gd >= 0 && gd < D && gh >= 0 && gh < H &&
                    gw >= 0 && gw < W && c < C;
    const int64_t off =
        ok ? ((((int64_t)b * D + gd) * H + gh) * W + gw) * C + c : 0;
    __nv_bfloat16* out = dst + row * str + 8 * g;
    if (vec) {
      cp_async16(out, src + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && c + j < C) ? src[off + j] : __float2bfloat16(0.f);
    }
  }
}

// A tile's batch and voxel origin on the dense grid.
struct Tile {
  int b, d0, h0, w0;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int64_t tile) {
  Tile t;
  int64_t r = tile;
  t.w0 = (int)(r % a.tiles_w) * a.tw; r /= a.tiles_w;
  t.h0 = (int)(r % a.tiles_h) * a.th; r /= a.tiles_h;
  t.d0 = (int)(r % a.tiles_d) * a.td;
  t.b = (int)(r / a.tiles_d);
  return t;
}

// the tapped tensor's origin for a tile: the halo's corner (K1) or the
// fine grid's 2 x coarse origin (bridges)
__device__ __forceinline__ void t_origin(bool conv, const Tile& t, int& od,
                                         int& oh, int& ow) {
  if (conv) {
    od = t.d0 - 1; oh = t.h0 - 1; ow = t.w0 - 1;
  } else {
    od = 2 * t.d0; oh = 2 * t.h0; ow = 2 * t.w0;
  }
}

// dk partials of one (split, T chunk, D chunk) block. MODE: kConv3, kDown
// or kUp; MTW: m16 tiles a warp (of ceil(taps * ci / 16)); CO: the D chunk;
// SPLIT: the prologue's hi/lo split of T.
template <int MODE, int MTW, int CO, bool SPLIT>
__global__ void __launch_bounds__(kThreads) dk_kernel(const Args a) {
  constexpr bool conv = MODE == kConv3, up = MODE == kUp;
  constexpr int taps = conv ? 27 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = dk_layout(a.trows, a.tstr, a.kpad, a.dstr, SPLIT);
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + L.t_raw);
  __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(smem + L.d_raw);
  __nv_bfloat16* shi = reinterpret_cast<__nv_bfloat16*>(smem + L.hi);
  __nv_bfloat16* slo = reinterpret_cast<__nv_bfloat16*>(smem + L.lo);
  int* tpos = reinterpret_cast<int*>(smem + L.tpos);
  int* dpos = reinterpret_cast<int*>(smem + L.dpos);
  int* arow = reinterpret_cast<int*>(smem + L.arow);
  double* sdb = reinterpret_cast<double*>(smem + L.db);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tcb = blockIdx.y / a.d_chunks, dcb = blockIdx.y % a.d_chunks;
  const int tc0 = tcb * a.ci, dc0 = dcb * CO;
  const int cib_n = a.ci >> 3;              // 8-channel blocks of the T chunk
  const int mblocks = taps * cib_n;         // m8 blocks: (tap, block)
  const int mtiles = (mblocks + 1) >> 1;
  const int hh = a.th + 2, hw = a.tw + 2;   // K1's halo
  const int tsz = a.trows * a.tstr, dsz = a.kpad * a.dstr;

  // ---- geometry, once per block
  for (int r = tid; r < a.trows; r += kThreads) {
    int p;
    if (conv) {
      p = pack(r / (hh * hw), (r / hw) % hh, r % hw);
    } else {
      const int tap = r / a.kpad, k = r % a.kpad;
      p = -1;
      if (k < a.nvox) {
        const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
        p = pack(2 * kd + (tap >> 2), 2 * kh + ((tap >> 1) & 1),
                 2 * kw + (tap & 1));
      }
    }
    tpos[r] = p;
  }
  for (int k = tid; k < a.kpad; k += kThreads) {
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    const bool live = k < a.nvox;
    dpos[k] = live ? pack(kd, kh, kw) : -1;
    // the T row of voxel k at tap 0; padded voxels read row 0 (finite, and
    // their D row is zero)
    arow[k] = conv ? (live ? (kd * hh + kh) * hw + kw : 0) : k;
  }
  // this lane's element offset into T for each of its warp's m16 tiles:
  // lanes 0-7 and 16-23 address the tile's first m8 block, 8-15 and 24-31
  // its second; a padding block reads tap 0 and is never written out
  int aoff[MTW];
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    int blk = 2 * (warp + kWarps * j) + ((lane >> 3) & 1);
    if (blk >= mblocks) blk = 0;
    const int tap = blk / cib_n, cib = blk % cib_n;
    const int toff = conv ? ((tap / 9) * hh + (tap / 3) % 3) * hw + tap % 3
                          : tap * a.kpad;
    aoff[j] = toff * a.tstr + cib * 8;
  }
  const int a_k = (lane & 7) + ((lane >> 4) << 3);        // A: voxel in k16
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);  // B: voxel in k16
  const int b_n = (lane >> 4) << 3;                        // B: n in n16
  __syncthreads();

  // db: sum of gy over the voxels, by the blocks of the other operand's
  // first chunk; thread (part, channel) over every parts-th staged row
  const bool sums_bias = up ? dcb == 0 : tcb == 0;
  const int gcw = up ? a.ci : CO;
  const int bias_c = tid & (gcw - 1), bias_part = tid / gcw;
  const int parts = kThreads / gcw;
  double bsum = 0.0;

  // the tensor cores' f32 accumulation truncates: its bias grows with the
  // length of a chain of MMAs. So each tile's MMAs start from zero and the
  // tile's sum joins the block's total by a rounded add.
  float total[MTW][CO / 8][4];
#pragma unroll
  for (int j = 0; j < MTW; ++j)
#pragma unroll
    for (int n = 0; n < CO / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[j][n][e] = 0.f;

  const int64_t ntiles = (int64_t)a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  const int64_t first = ntiles * blockIdx.x / a.splits;
  const int64_t last = ntiles * (blockIdx.x + 1) / a.splits;

  auto stage = [&](int64_t tile, int slot) {
    const Tile t = tile_at(a, tile);
    int od, oh, ow;
    t_origin(conv, t, od, oh, ow);
    stage_rows(st + slot * tsz, a.tstr, tpos, a.trows, a.t, t.b, a.tD, a.tH,
               a.tW, a.tC, tc0, a.ci, od, oh, ow);
    stage_rows(sd + slot * dsz, a.dstr, dpos, a.kpad, a.d, t.b, a.dD, a.dH,
               a.dW, a.dC, dc0, CO, t.d0, t.h0, t.w0);
  };

  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int64_t tile = first; tile < last; ++tile) {
    const int slot = (int)((tile - first) & 1);
    if (tile + 1 < last) stage(tile + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* ta = st + slot * tsz;
    const __nv_bfloat16* db_rows = up ? ta : sd + slot * dsz;
    if (SPLIT) {
      // xn = relu(x * s + t) in f32, zero outside the volume (SAME pads
      // the normalized tensor) and on planes outside [dlo, dhi] (K1's
      // dlim: a D-slab's missing-neighbour halo), split into bf16 hi + lo
      const Tile t = tile_at(a, tile);
      int od, oh, ow;
      t_origin(conv, t, od, oh, ow);
      const int c = tid & (a.ci - 1);
      const bool cin = tc0 + c < a.tC;
      const float sv = cin ? a.s[t.b * a.tC + tc0 + c] : 0.f;
      const float tv = cin ? a.sh[t.b * a.tC + tc0 + c] : 0.f;
      const int lgc = a.ci == 8 ? 3 : 4;
      for (int i = tid; i < (a.trows << lgc); i += kThreads) {
        const int row = i >> lgc;
        const int pp = tpos[row];
        const int gd = od + (pp >> 20), gh = oh + ((pp >> 10) & 1023),
                  gw = ow + (pp & 1023);
        float v = 0.f;
        if (cin && pp >= 0 && gd >= a.dlo && gd <= a.dhi && gd < a.tD &&
            gh >= 0 && gh < a.tH && gw >= 0 && gw < a.tW)
          v = fmaxf(pre_activation(__bfloat162float(ta[row * a.tstr + c]),
                                   sv, tv), 0.f);
        const __nv_bfloat16 h = __float2bfloat16(v);
        shi[row * a.tstr + c] = h;
        slo[row * a.tstr + c] = __float2bfloat16(v - __bfloat162float(h));
      }
      __syncthreads();
      ta = shi;
    }
    const __nv_bfloat16* tb = sd + slot * dsz;
    float acc[MTW][CO / 8][4];
#pragma unroll
    for (int j = 0; j < MTW; ++j)
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
    for (int ks = 0; ks < a.kpad; ks += 16) {
      uint32_t bf[CO / 8][2];
      const __nv_bfloat16* brow = tb + (ks + b_k) * a.dstr + b_n;
#pragma unroll
      for (int n = 0; n < CO / 16; ++n) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, brow + 16 * n);
        bf[2 * n][0] = r[0]; bf[2 * n][1] = r[1];
        bf[2 * n + 1][0] = r[2]; bf[2 * n + 1][1] = r[3];
      }
      if (CO == 8) ldmatrix_x2_trans(bf[0], tb + (ks + b_k) * a.dstr);
      const int ar = arow[ks + a_k] * a.tstr;
#pragma unroll
      for (int j = 0; j < MTW; ++j) {
        if (warp + kWarps * j >= mtiles) break;   // warp-uniform
        uint32_t af[4];
        ldmatrix_x4_trans(af, ta + ar + aoff[j]);
#pragma unroll
        for (int n = 0; n < CO / 8; ++n) mma_bf16(acc[j][n], af, bf[n]);
        if (SPLIT) {
          ldmatrix_x4_trans(af, slo + ar + aoff[j]);
#pragma unroll
          for (int n = 0; n < CO / 8; ++n) mma_bf16(acc[j][n], af, bf[n]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MTW; ++j)
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          total[j][n][e] = __fadd_rn(total[j][n][e], acc[j][n][e]);
    if (sums_bias) {
      const int grows = up ? a.trows : a.kpad;
      const int gstr = up ? a.tstr : a.dstr;
      for (int r = bias_part; r < grows; r += parts)
        bsum += (double)__bfloat162float(db_rows[r * gstr + bias_c]);
    }
    __syncthreads();
  }

  // ---- this block's partial, written once
  const int Cin = up ? a.dC : a.tC, Cout = up ? a.tC : a.dC;
  float* out = a.ws + (int64_t)blockIdx.x * taps * Cin * Cout;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int mt = warp + kWarps * j;
    if (mt >= mtiles) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int blk = 2 * mt + half;
      if (blk >= mblocks) continue;
      const int tap = blk / cib_n;
      const int tch = tc0 + (blk % cib_n) * 8 + g;
      if (tch >= a.tC) continue;
#pragma unroll
      for (int n = 0; n < CO / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dch = dc0 + n * 8 + 2 * q + e;
          if (dch >= a.dC) continue;
          const int64_t idx = up ? ((int64_t)tap * a.dC + dch) * a.tC + tch
                                 : ((int64_t)tap * a.tC + tch) * a.dC + dch;
          out[idx] = total[j][n][2 * half + e];
        }
      }
    }
  }
  if (sums_bias) {
    sdb[tid] = bsum;
    __syncthreads();
    const int gc0 = up ? tc0 : dc0;
    if (tid < gcw && gc0 + tid < Cout) {
      double s = 0.0;
      for (int p = 0; p < parts; ++p) s += sdb[p * gcw + tid];
      a.wsdb[(int64_t)blockIdx.x * Cout + gc0 + tid] = s;
    }
  }
}

// dk[e] = sum over splits of ws[split, e], db likewise, each in f64 in
// split order, then rounded to f32 once. A block takes 32 outputs; warp w
// sums the splits w, w + 8, ..., and warp 0 adds the eight in order. (MODE
// only names the kernel after its caller.)
template <int MODE>
__global__ void __launch_bounds__(kThreads) dk_reduce_kernel(
    const float* ws, const double* wsdb, float* dk, float* db, int64_t n_dk,
    int n_db, int splits) {
  __shared__ double part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  double s = 0.0;
  if (e < n_dk) {
    for (int p = warp; p < splits; p += kWarps) s += ws[p * n_dk + e];
  } else if (e < n_dk + n_db) {
    for (int p = warp; p < splits; p += kWarps)
      s += wsdb[p * n_db + (e - n_dk)];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += part[w][lane];
    if (e < n_dk)
      dk[e] = (float)sum;
    else if (e < n_dk + n_db)
      db[e - n_dk] = (float)sum;
  }
}

template <int MODE, int MTW, int CO, bool SPLIT>
cudaError_t launch_dk(const Args& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        dk_kernel<MODE, MTW, CO, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((unsigned)a.splits, (unsigned)(a.t_chunks * a.d_chunks), 1);
  dim3 block(kThreads, 1, 1);
  dk_kernel<MODE, MTW, CO, SPLIT><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE, int MTW, bool SPLIT>
cudaError_t dispatch_co(const Args& a, int co, int smem, cudaStream_t st) {
  switch (co) {
    case 8: return launch_dk<MODE, MTW, 8, SPLIT>(a, smem, st);
    case 16: return launch_dk<MODE, MTW, 16, SPLIT>(a, smem, st);
    case 32: return launch_dk<MODE, MTW, 32, SPLIT>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// K1 stacks 27 taps into M (14 or 27 m16 tiles: 2 or 4 a warp), the
// bridges 8 (at most 8 m16 tiles: 1 a warp); K3 has no prologue
template <int MODE>
cudaError_t dispatch(const Args& a, int mtw, int co, bool split, int smem,
                     cudaStream_t st) {
  if constexpr (MODE == kConv3) {
    if (mtw == 2)
      return split ? dispatch_co<MODE, 2, true>(a, co, smem, st)
                   : dispatch_co<MODE, 2, false>(a, co, smem, st);
    if (mtw == 4)
      return split ? dispatch_co<MODE, 4, true>(a, co, smem, st)
                   : dispatch_co<MODE, 4, false>(a, co, smem, st);
    return cudaErrorInvalidValue;
  } else if constexpr (MODE == kDown) {
    if (mtw != 1) return cudaErrorInvalidValue;
    return split ? dispatch_co<MODE, 1, true>(a, co, smem, st)
                 : dispatch_co<MODE, 1, false>(a, co, smem, st);
  } else {
    if (mtw != 1 || split) return cudaErrorInvalidValue;
    return dispatch_co<MODE, 1, false>(a, co, smem, st);
  }
}

// The weight and bias gradient: T [B, tD, tH, tW, tC] and D [B, dD, dH,
// dW, dC] as above, (s, sh) the prologue on T or null, [dlo, dhi] the
// planes of T the prologue keeps (K1's dlim; the bridges keep every plane);
// ws / wsdb the workspace of `plan`; dk [taps, Cin, Cout] and db [Cout] f32
// are written whole (no zeroing needed). Returns the first launch error, or
// cudaErrorInvalidValue for a plan this file does not compute.
template <int MODE>
cudaError_t weight_grad(const __nv_bfloat16* t, const __nv_bfloat16* d,
                               const float* s, const float* sh, float* ws,
                               double* wsdb, float* dk, float* db, int B,
                               int tD, int tH, int tW, int tC, int dD, int dH,
                               int dW, int dC, const int* plan,
                               cudaStream_t stream, int dlo = 0,
                               int dhi = 0x7fffffff) {
  Args a;
  a.t = t; a.d = d; a.s = s; a.sh = sh; a.ws = ws; a.wsdb = wsdb;
  a.B = B; a.tD = tD; a.tH = tH; a.tW = tW; a.tC = tC;
  a.dD = dD; a.dH = dH; a.dW = dW; a.dC = dC;
  a.dlo = dlo; a.dhi = dhi;
  const int taps = MODE == kConv3 ? 27 : 8;
  a.td = plan[kPlanTd]; a.th = plan[kPlanTh]; a.tw = plan[kPlanTw];
  a.tiles_d = plan[kPlanTilesD]; a.tiles_h = plan[kPlanTilesH];
  a.tiles_w = plan[kPlanTilesW];
  a.ci = plan[kPlanCi];
  const int co = plan[kPlanCo];
  a.t_chunks = plan[kPlanTChunks]; a.d_chunks = plan[kPlanDChunks];
  a.splits = plan[kPlanSplits];
  const int mtw = plan[kPlanMtw];
  a.nvox = a.td * a.th * a.tw;
  a.kpad = round_up(a.nvox, 16);
  a.trows = MODE == kConv3 ? (a.td + 2) * (a.th + 2) * (a.tw + 2)
                           : 8 * a.kpad;
  a.tstr = row_stride(a.ci);
  a.dstr = row_stride(co);
  const bool split = s != nullptr;
  const Layout L = dk_layout(a.trows, a.tstr, a.kpad, a.dstr, split);
  const int mtiles = (taps * (a.ci / 8) + 1) / 2;
  if (plan[kPlanMode] != MODE || B <= 0 || a.td <= 0 || a.th <= 0 ||
      dlo < 0 || dlo > dhi ||
      a.tw <= 0 || tC <= 0 || dC <= 0 ||
      (a.ci != 8 && a.ci != 16) || a.t_chunks * a.ci < tC ||
      a.d_chunks * co < dC || (a.t_chunks - 1) * a.ci >= tC ||
      (a.d_chunks - 1) * co >= dC || a.tiles_d * a.td < dD ||
      a.tiles_h * a.th < dH || a.tiles_w * a.tw < dW ||
      mtw * kWarps < mtiles ||
      L.bytes > 227 * 1024 ||
      a.t_chunks * a.d_chunks > 65535 || a.splits <= 0 ||
      (int64_t)a.splits > (int64_t)B * a.tiles_d * a.tiles_h * a.tiles_w ||
      2 * a.td + 1 > 1023 || a.th + 2 > 1023 ||
      2 * a.th + 1 > 1023 || 2 * a.tw + 1 > 1023)
    return cudaErrorInvalidValue;
  cudaError_t err = dispatch<MODE>(a, mtw, co, split, L.bytes, stream);
  if (err != cudaSuccess) return err;
  const int Cin = MODE == kUp ? dC : tC, Cout = MODE == kUp ? tC : dC;
  const int64_t n_dk = (int64_t)taps * Cin * Cout;
  const int64_t blocks = (n_dk + Cout + 31) / 32;
  dim3 grid((unsigned)blocks, 1, 1), block(kThreads, 1, 1);
  dk_reduce_kernel<MODE><<<grid, block, 0, stream>>>(ws, wsdb, dk, db, n_dk,
                                                   Cout, a.splits);
  return cudaGetLastError();
}

}  // namespace wgrad
