// The backwards of K2 (down_k2s2) and K3 (up_k2s2) for Hopper (sm_90a):
// channels-last bf16 activations and cotangents, f32 accumulation, f32
// weight, bias and affine gradients.
//
// down_k2s2_bwd replaces (TPU, Pallas) vae_segmentation_tpu/ops/pallas/
//   upbridge.py::_run_down_bwd and ::_run_down_bwd_pre. With fine voxel
//   f = 2i + a of coarse voxel i (a in 2^3):
//     g[b, f, c]  = sum_o gy[b, i, o] * wk[a, c, o]
//     dx          = g, or with the prologue gm * s[b, c], gm = g where
//                   x * s + t > 0 else 0, dst[b, 0, c] = sum_f gm * x (ds),
//                   dst[b, 1, c] = sum_f gm (dt)
//     dk[a, c, o] = sum_{b, i} xn[b, 2i + a, c] * gy[b, i, o]
//     db[o]       = sum_{b, i} gy[b, i, o]
//   xn = relu(x * s + t) or x, rounded as in the forward (common.cuh).
// up_k2s2_bwd replaces upbridge.py::_run_bwd:
//     dx[b, i, c] = sum_{a, o} gy[b, 2i + a, o] * wk[a, c, o]
//     dk[a, c, o] = sum_{b, i} x[b, i, c] * gy[b, 2i + a, o]
//     db[o]       = sum_{b, f} gy[b, f, o]
//
// What bounds them on the H100: the bytes (8 Cin Cout MACs per coarse
// voxel against 9 voxels of traffic each for dx and dk). The TPU kernels
// ran dx, dk and db in one pass over a sequential grid and carried dk in
// VMEM. Here each part is its own kernel, and a caller that needs only one
// part (a frozen weight, an input without gradient) launches only that:
// - dk and db of both bridges: the split-K tensor-core kernel of
//   wgrad.cuh, M = (tap, fine channel), N = coarse channel, K = coarse
//   voxels (each coarse voxel's 8 fine rows, one per tap), the prologue's
//   xn as bf16 hi + lo, partials summed in a fixed order in f64 (no
//   atomics; the same bits on every run).
// - up's dx: a GEMM on the tensor cores, M = coarse voxels, N = Cin,
//   K = 8 Cout (up_dx_kernel): a block stages a brick of 64 coarse voxels'
//   8 fine rows and the matching [8, nc, 16] weight slice, 16 channels of
//   gy at a time, by cp.async into a two-slot ring, and runs mma.sync
//   (ldmatrix without transpose: the fine rows are channels-last already).
// - down's dx: the mirror of K3's forward (bridge.cu), a GEMM per tap on
//   the tensor cores, M = coarse voxels, K = Cout, N = (tap, Cin): a block
//   takes one chunk of nc input channels (its [8, nc, Cout] weight slice
//   staged once) of one batch entry and walks tpb bricks of coarse voxels,
//   their gy rows staged by cp.async into a two-slot ring. Warp w computes
//   tap w (mma.sync, ldmatrix without transpose on both operands: gy's rows
//   and the weight's rows are K-contiguous); its f32 sums, rounded to bf16
//   once (f32 under the prologue), go into the brick's fine voxels 2i + w
//   in shared memory, and the block writes each fine row with 16-byte
//   stores. The bricks tile ceil(fine / 2) coarse voxels, so an odd fine
//   extent's last plane, which no coarse voxel feeds, is in a brick whose
//   staged gy rows there are zero: it is written as 0. Under the prologue
//   the store reads x's fine rows with 16-byte loads alongside, masks g
//   where x * s + t > 0 (common.cuh's rounding: the forward's mask), writes
//   dx = gm * s and sums ds = gm * x and dt = gm in f32 a thread (its
//   channel group is fixed), then by warp shuffles and the warps in a fixed
//   order: each block's [2, nc] partial is written once and the blocks'
//   partials added in f64 in a fixed order (common.cuh::parts_reduce): no
//   atomics.
// The plans (K3's dx: ops/bridges.py::up_dx_plan; K2's: down_dx_plan) are
// computed by the wrapper and passed in; each C function checks its plan
// and lays out the shared memory it needs, refusing a plan that does not
// fit.

#include "wgrad.cuh"

namespace {

using wgrad::kThreads;
using wgrad::kWarps;

// the up dx plan's fields, in order (ops/bridges.py::up_dx_plan)
enum DxField {
  kDxTd, kDxTh, kDxTw, kDxTilesD, kDxTilesH, kDxTilesW, kDxNc
};

constexpr int kDxStr = 24;  // row stride of a 16-channel chunk (bf16)

struct DxArgs {
  const __nv_bfloat16* gy;  // [B, 2Dc, 2Hc, 2Wc, Cout]
  const __nv_bfloat16* w;   // [8, Cin, Cout]
  __nv_bfloat16* dx;        // [B, Dc, Hc, Wc, Cin]
  int B, Dc, Hc, Wc, Cin, Cout;
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int nvox, kpad, nc;
};

inline int dx_smem(int kpad, int nc) {
  return 2 * (8 * kpad + 8 * nc) * kDxStr * 2 + (8 * kpad + kpad) * 4;
}

// dx of K3 on the tensor cores: block (tile, channel chunk) computes
// dx[tile's kpad coarse voxels, nc channels] = sum over (a, o) of
// gy[2i + a, o] * wk[a, c, o]. Warp (mw, nw): m16 tile mw of the voxels,
// half nw of the channels (NT n8 tiles).
template <int NT>
__global__ void __launch_bounds__(kThreads) up_dx_kernel(const DxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 16 * NT;
  const int grows = 8 * a.kpad, wrows = 8 * NC;
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = sg + 2 * grows * kDxStr;
  int* tpos = reinterpret_cast<int*>(sw + 2 * wrows * kDxStr);
  int* dpos = tpos + grows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp & 3, nw = warp >> 2;
  const int c0 = blockIdx.y * NC;

  for (int r = tid; r < grows; r += kThreads) {
    const int tap = r / a.kpad, k = r % a.kpad;
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    tpos[r] = k < a.nvox ? wgrad::pack(2 * kd + (tap >> 2),
                                       2 * kh + ((tap >> 1) & 1),
                                       2 * kw + (tap & 1))
                         : -1;
  }
  for (int k = tid; k < a.kpad; k += kThreads) {
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    dpos[k] = k < a.nvox ? wgrad::pack(kd, kh, kw) : -1;
  }
  int64_t r = blockIdx.x;
  const int w0 = (int)(r % a.tiles_w) * a.tw; r /= a.tiles_w;
  const int h0 = (int)(r % a.tiles_h) * a.th; r /= a.tiles_h;
  const int d0 = (int)(r % a.tiles_d) * a.td;
  const int b = (int)(r / a.tiles_d);
  const bool wvec = (a.Cout & 7) == 0;
  __syncthreads();

  auto stage = [&](int kc, int slot) {
    wgrad::stage_rows(sg + slot * grows * kDxStr, kDxStr, tpos, grows, a.gy,
                      b, 2 * a.Dc, 2 * a.Hc, 2 * a.Wc, a.Cout, 16 * kc, 16,
                      2 * d0, 2 * h0, 2 * w0);
    __nv_bfloat16* dst = sw + slot * wrows * kDxStr;
    for (int i = tid; i < 2 * wrows; i += kThreads) {
      const int row = i >> 1, g = i & 1;
      const int tap = row / NC, c = c0 + row % NC, o = 16 * kc + 8 * g;
      const bool ok = c < a.Cin && o < a.Cout;
      const int64_t off = ok ? ((int64_t)tap * a.Cin + c) * a.Cout + o : 0;
      __nv_bfloat16* out = dst + row * kDxStr + 8 * g;
      if (wvec) {
        wgrad::cp_async16(out, a.w + off, ok);
      } else {
        for (int j = 0; j < 8; ++j)
          out[j] = (ok && o + j < a.Cout) ? a.w[off + j]
                                          : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool live = mw * 16 < a.kpad;   // warp-uniform
  const int am = mw * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int ak = (lane >> 4) << 3;
  const int bn = nw * NT * 8 + (lane & 7) + ((lane >> 4) << 3);
  const int bk = ((lane >> 3) & 1) << 3;
  const int nk = (a.Cout + 15) / 16;

  stage(0, 0);
  wgrad::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int slot = kc & 1;
    if (kc + 1 < nk) stage(kc + 1, slot ^ 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* g_ = sg + slot * grows * kDxStr;
    const __nv_bfloat16* w_ = sw + slot * wrows * kDxStr;
    if (live) {
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) {
        uint32_t af[4], bf[NT][2];
        wgrad::ldmatrix_x4(af, g_ + (tap * a.kpad + am) * kDxStr + ak);
        if (NT == 1) {
          wgrad::ldmatrix_x2(bf[0], w_ + (tap * NC + bn) * kDxStr + bk);
        } else {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t q[4];
            wgrad::ldmatrix_x4(q, w_ + (tap * NC + bn + 16 * p) * kDxStr + bk);
            bf[2 * p][0] = q[0]; bf[2 * p][1] = q[1];
            bf[2 * p + 1][0] = q[2]; bf[2 * p + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[n], af, bf[n]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = mw * 16 + g + 8 * half;
    const int pp = k < a.nvox ? dpos[k] : -1;
    if (pp < 0) continue;
    const int od = d0 + (pp >> 20), oh = h0 + ((pp >> 10) & 1023),
              ow = w0 + (pp & 1023);
    if (od >= a.Dc || oh >= a.Hc || ow >= a.Wc) continue;
    __nv_bfloat16* out =
        a.dx + ((((int64_t)b * a.Dc + od) * a.Hc + oh) * a.Wc + ow) * a.Cin;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + nw * NT * 8 + n * 8 + 2 * q + e;
        if (c < a.Cin) out[c] = __float2bfloat16(acc[n][2 * half + e]);
      }
    }
  }
}

// ---- K2's dx on the tensor cores

// the down dx plan's fields, in order (ops/bridges.py::DOWN_DX_FIELDS)
enum DownDxField {
  kDdTd, kDdTh, kDdTw, kDdTilesD, kDdTilesH, kDdTilesW, kDdNc, kDdMt,
  kDdTpb, kDdBlocks
};

// k16 steps a chain of MMAs, at most (bridge.cu's kFold)
constexpr int kFold = 8;
// fine-brick items (a fine voxel's 8 channels) a thread stores a brick, at
// most: 8 nvox nc / 8 <= 8 m16n8 tiles a warp x 128 = 4 kThreads
constexpr int kDdItems = 4;

struct DownDxArgs {
  const __nv_bfloat16* x;   // [B, Df, Hf, Wf, Cin] the forward's input
  const __nv_bfloat16* gy;  // [B, Dc, Hc, Wc, Cout]
  const __nv_bfloat16* w;   // [8, Cin, Cout], a = (ad * 2 + ah) * 2 + aw
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  __nv_bfloat16* dx;        // like x
  float* dpart;             // [B, blocks, 2, Cin] f32 partials of dst
  int B, Dc, Hc, Wc, Df, Hf, Wf, Cin, Cout;
  int td, th, tw, tiles_d, tiles_h, tiles_w, nc, mt, tpb, blocks;
  int nvox, mpad, kpad, gstr, slots;
  bool gvec, wvec, xvec;    // 16-byte rows of gy, w, and x / dx
};

// byte offsets of the down dx kernel's shared memory: the ring of staged gy
// rows [slots][mpad][gstr] bf16; the weight rows [8 nc][gstr] bf16 (row
// tap * nc + c holds wk[tap, c0 + c, :]); the brick's tables (each coarse
// row's position, its fine voxel 2i, each fine voxel's position); the fine
// brick, [8 nvox] rows of nc channels, bf16 at row_stride(nc), or f32 at
// nc + 4 under the prologue (its mask and sums take the f32 sum); the
// warps' (ds, dt) [kWarps][2][16] f32
struct DdLayout {
  int g, w, pos, out, red, bytes;
};

__host__ __device__ inline DdLayout dd_layout(int slots, int mpad, int gstr,
                                              int nc, int nvox, bool pre) {
  DdLayout l;
  l.g = 0;
  l.w = slots * mpad * gstr * 2;
  l.pos = l.w + 8 * nc * gstr * 2;
  l.out = l.pos + (2 * mpad + 8 * nvox) * 4;
  l.red = l.out + 8 * nvox * (pre ? (nc + 4) * 4 : wgrad::row_stride(nc) * 2);
  l.bytes = l.red + kWarps * 2 * 16 * 4;
  return l;
}

// dx of K2: block (bricks blockIdx.x + k gridDim.x of batch entry
// blockIdx.z, channel chunk blockIdx.y); warp w computes tap w: MT m16
// tiles (the brick's coarse voxels) by NT n8 tiles (nc = 8 NT input
// channels), K = Cout in k16 steps (chains of at most kFold, FOLD). PRE:
// the prologue's backward, its (ds, dt) partial of the block written once.
template <int MT, int NT, bool PRE, bool FOLD>
__global__ void __launch_bounds__(kThreads) down_dx_kernel(const DownDxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 8 * NT, G = NT;   // G: channel groups of 8 in a chunk
  const DdLayout L = dd_layout(a.slots, a.mpad, a.gstr, NC, a.nvox, PRE);
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem + L.g);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int* pos = reinterpret_cast<int*>(smem + L.pos);   // [mpad]
  int* mfine = pos + a.mpad;                         // [mpad], -1 past nvox
  int* fpos = mfine + a.mpad;                        // [8 nvox]
  __nv_bfloat16* ysb = reinterpret_cast<__nv_bfloat16*>(smem + L.out);
  float* ysf = reinterpret_cast<float*>(smem + L.out);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int b = blockIdx.z, c0 = blockIdx.y * NC;
  const int fh = 2 * a.th, fw = 2 * a.tw;
  const int ystr = PRE ? NC + 4 : wgrad::row_stride(NC);
  const int tapoff = ((tap >> 2) * fh + ((tap >> 1) & 1)) * fw + (tap & 1);
  const int hw = a.tiles_h * a.tiles_w;
  const int nb = min(a.tpb, (a.tiles_d * hw - 1 - (int)blockIdx.x) /
                                (int)gridDim.x + 1);
  const int units = a.kpad >> 3;     // 16-byte units of a staged row

  // the brick's geometry, once
  for (int m = tid; m < a.mpad; m += kThreads) {
    const int kd = m / (a.th * a.tw), kh = (m / a.tw) % a.th, kw = m % a.tw;
    pos[m] = m < a.nvox ? wgrad::pack(kd, kh, kw) : -1;
    mfine[m] = m < a.nvox ? (2 * kd * fh + 2 * kh) * fw + 2 * kw : -1;
  }
  for (int v = tid; v < 8 * a.nvox; v += kThreads)
    fpos[v] = wgrad::pack(v / (fh * fw), (v / fw) % fh, v % fw);
  // the chunk's weight rows, once (zero past Cin and Cout)
  for (int i = tid; i < 8 * NC * units; i += kThreads) {
    const int row = i / units, u = i - row * units;
    const int c = c0 + row % NC, o = 8 * u;
    const bool ok = c < a.Cin && o < a.Cout;
    const int64_t off = ok ? ((int64_t)(row / NC) * a.Cin + c) * a.Cout + o : 0;
    __nv_bfloat16* out = sw + row * a.gstr + 8 * u;
    if (a.wvec) {
      wgrad::cp_async16(out, a.w + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && o + j < a.Cout) ? a.w[off + j] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();   // the tables, before the first staging reads them

  auto origin = [&](int k, int& d0, int& h0, int& w0) {
    int tile = (int)blockIdx.x + k * (int)gridDim.x;
    const int kd = tile / hw;
    tile -= kd * hw;
    const int kh = tile / a.tiles_w;
    d0 = kd * a.td;
    h0 = kh * a.th;
    w0 = (tile - kh * a.tiles_w) * a.tw;
  };
  // brick k's gy rows into slot k % slots: zero past nvox, outside the
  // coarse grid (the odd fine extent's last plane) and past Cout
  auto stage = [&](int k) {
    int d0, h0, w0;
    origin(k, d0, h0, w0);
    __nv_bfloat16* dst = sg + (k % a.slots) * a.mpad * a.gstr;
    for (int i = tid; i < a.mpad * units; i += kThreads) {
      const int r = i / units, u = i - r * units;
      const int pp = pos[r];
      const int gd = d0 + (pp >> 20), gh = h0 + ((pp >> 10) & 1023),
                gw = w0 + (pp & 1023);
      const int o = 8 * u;
      const bool ok = pp >= 0 && gd < a.Dc && gh < a.Hc && gw < a.Wc &&
                      o < a.Cout;
      const int64_t off =
          ok ? ((((int64_t)b * a.Dc + gd) * a.Hc + gh) * a.Wc + gw) * a.Cout +
                   o
             : 0;
      __nv_bfloat16* out = dst + r * a.gstr + 8 * u;
      if (a.gvec) {
        wgrad::cp_async16(out, a.gy + off, ok);
      } else {
        for (int j = 0; j < 8; ++j)
          out[j] = (ok && o + j < a.Cout) ? a.gy[off + j]
                                          : __float2bfloat16(0.f);
      }
    }
  };

  // this thread's channel group (its store items are tid + k kThreads, and
  // kThreads is a multiple of G), its 8 channels' (s, t) and (ds, dt) sums
  const int cu = c0 + 8 * (tid % G);
  float sv[8], tv[8], ds[8], dt[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sv[e] = tv[e] = ds[e] = dt[e] = 0.f;
    if (PRE && cu + e < a.Cin) {
      sv[e] = a.s[b * a.Cin + cu + e];
      tv[e] = a.t[b * a.Cin + cu + e];
    }
  }

  const int a_row = lane & 15, a_kh = (lane >> 4) << 3;
  const int bn = (lane & 7) + ((lane >> 4) << 3), bk = ((lane >> 3) & 1) << 3;
  const int g = lane >> 2, q = lane & 3;
  const int nks = a.kpad >> 4;
  stage(0);
  wgrad::cp_async_commit();   // with the weight rows
  for (int k = 0; k < nb; ++k) {
    if (k + 1 < nb) stage(k + 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();   // this brick's rows have landed
    __syncthreads();
    const __nv_bfloat16* gs = sg + (k % a.slots) * a.mpad * a.gstr;
    float acc[MT][NT][4];
    float tot[FOLD ? MT : 1][FOLD ? NT : 1][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][n][e] = 0.f;
          if (FOLD) tot[FOLD ? j : 0][FOLD ? n : 0][e] = 0.f;
        }
    auto fold = [&]() {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& t = tot[FOLD ? j : 0][FOLD ? n : 0][e];
            t = __fadd_rn(t, acc[j][n][e]);
            acc[j][n][e] = 0.f;
          }
    };
    int chain = 0;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t bf[NT][2];
      const __nv_bfloat16* wrow = sw + (tap * NC + bn) * a.gstr + 16 * ks + bk;
      if (NT == 1) {
        wgrad::ldmatrix_x2(bf[0], wrow);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r4[4];
          wgrad::ldmatrix_x4(r4, wrow + 16 * p * a.gstr);
          bf[2 * p][0] = r4[0]; bf[2 * p][1] = r4[1];
          bf[2 * p + 1][0] = r4[2]; bf[2 * p + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (16 * j >= a.mpad) break;   // warp-uniform
        uint32_t af[4];
        wgrad::ldmatrix_x4(af, gs + (16 * j + a_row) * a.gstr + 16 * ks + a_kh);
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
      }
      if (FOLD && ++chain == kFold) {
        chain = 0;
        fold();
      }
    }
    if (FOLD) {
      fold();
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][n][e] = tot[FOLD ? j : 0][FOLD ? n : 0][e];
    }
    // the C fragments (lane (g, q): rows g and g + 8 of each m16 tile,
    // columns 2q and 2q + 1 of each n8 tile) into the fine brick at 2i + tap
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * j + g + 8 * h;
        if (m >= a.mpad) break;
        const int f = mfine[m];
        if (f < 0) continue;
        const int row = (f + tapoff) * ystr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (PRE) {
            *reinterpret_cast<float2*>(ysf + row + 8 * n + 2 * q) =
                make_float2(acc[j][n][2 * h], acc[j][n][2 * h + 1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(ysb + row + 8 * n + 2 * q) =
                __floats2bfloat162_rn(acc[j][n][2 * h], acc[j][n][2 * h + 1]);
          }
        }
      }
    __syncthreads();

    // the fine brick out: item i = (fine voxel i / G, channel group i % G),
    // neighbouring threads on neighbouring channel groups, then voxels
    // along w; under the prologue x's rows are loaded first, all at once
    int d0, h0, w0;
    origin(k, d0, h0, w0);
    const int items = 8 * a.nvox * G;
    int64_t off[kDdItems];
    bool in[kDdItems];
    uint4 xr[kDdItems];
#pragma unroll
    for (int it = 0; it < kDdItems; ++it) {
      const int i = tid + it * kThreads;
      in[it] = false;
      off[it] = 0;
      if (i < items) {
        const int pp = fpos[i / G];
        const int vd = 2 * d0 + (pp >> 20), vh = 2 * h0 + ((pp >> 10) & 1023),
                  vw = 2 * w0 + (pp & 1023);
        in[it] = vd < a.Df && vh < a.Hf && vw < a.Wf && cu < a.Cin;
        off[it] = ((((int64_t)b * a.Df + vd) * a.Hf + vh) * a.Wf + vw) * a.Cin +
                  cu;
      }
      if (PRE && in[it] && a.xvec)
        xr[it] = *reinterpret_cast<const uint4*>(a.x + off[it]);
    }
#pragma unroll
    for (int it = 0; it < kDdItems; ++it) {
      if (!in[it]) continue;
      const int v = (tid + it * kThreads) / G, col = cu - c0;
      __nv_bfloat16* out = a.dx + off[it];
      if (!PRE) {
        const __nv_bfloat16* src = ysb + v * ystr + col;
        if (a.xvec) {
          *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && cu + e < a.Cin; ++e) out[e] = src[e];
        }
        continue;
      }
      const float4* src = reinterpret_cast<const float4*>(ysf + v * ystr + col);
      const float4 g0 = src[0], g1 = src[1];
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      __align__(16) __nv_bfloat16 xb[8];
      if (a.xvec) {
        *reinterpret_cast<uint4*>(xb) = xr[it];
      } else {
        for (int e = 0; e < 8; ++e)
          xb[e] = cu + e < a.Cin ? a.x[off[it] + e] : __float2bfloat16(0.f);
      }
      __align__(16) __nv_bfloat16 ob[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xv = __bfloat162float(xb[e]);
        const float gm = pre_activation(xv, sv[e], tv[e]) > 0.f ? gv[e] : 0.f;
        ob[e] = __float2bfloat16(gm * sv[e]);
        ds[e] = fmaf(gm, xv, ds[e]);
        dt[e] += gm;
      }
      if (a.xvec) {
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(ob);
      } else {
        for (int e = 0; e < 8 && cu + e < a.Cin; ++e) out[e] = ob[e];
      }
    }
    __syncthreads();   // this brick's slot and the fine brick are free again
  }
  if constexpr (PRE) {
    // (ds, dt): the lanes of one channel group by shuffles (lane l holds
    // group l % G), then the warps in order; the block's partial written once
#pragma unroll
    for (int e = 0; e < 8; ++e)
      for (int o = 16; o >= G; o >>= 1) {
        ds[e] += __shfl_xor_sync(0xffffffffu, ds[e], o);
        dt[e] += __shfl_xor_sync(0xffffffffu, dt[e], o);
      }
    if (lane < G) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[(tap * 2 + 0) * 16 + 8 * lane + e] = ds[e];
        red[(tap * 2 + 1) * 16 + 8 * lane + e] = dt[e];
      }
    }
    __syncthreads();
    if (tid < 2 * NC) {
      const int r = tid / NC, c = tid % NC;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[(w * 2 + r) * 16 + c];
      if (c0 + c < a.Cin)
        a.dpart[(((int64_t)b * a.blocks + blockIdx.x) * 2 + r) * a.Cin + c0 + c] =
            sum;
    }
  }
}

template <int MT, int NT, bool PRE, bool FOLD>
cudaError_t launch_down_dx(const DownDxArgs& a, int smem, cudaStream_t st) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        down_dx_kernel<MT, NT, PRE, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((unsigned)a.blocks, (unsigned)((a.Cin + 8 * NT - 1) / (8 * NT)),
                  (unsigned)a.B);
  down_dx_kernel<MT, NT, PRE, FOLD><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int NT, bool PRE, bool FOLD>
cudaError_t dispatch_down_dx_mt(const DownDxArgs& a, int smem,
                                cudaStream_t st) {
  switch (a.mt) {
    case 1: return launch_down_dx<1, NT, PRE, FOLD>(a, smem, st);
    case 2: return launch_down_dx<2, NT, PRE, FOLD>(a, smem, st);
    case 4: return launch_down_dx<4, NT, PRE, FOLD>(a, smem, st);
    case 8:
      if constexpr (NT == 1) return launch_down_dx<8, 1, PRE, FOLD>(a, smem, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <bool PRE, bool FOLD>
cudaError_t dispatch_down_dx_nt(const DownDxArgs& a, int smem,
                                cudaStream_t st) {
  return a.nc == 8 ? dispatch_down_dx_mt<1, PRE, FOLD>(a, smem, st)
                   : dispatch_down_dx_mt<2, PRE, FOLD>(a, smem, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K2's dx (and, with s and t, dpart's partials) under `plan`, the fields of
// ops/bridges.py::down_dx_plan on the fine grid (Df, Hf, Wf).
cudaError_t down_dx(DownDxArgs a, const int* plan, cudaStream_t st) {
  if (plan == nullptr) return cudaErrorInvalidValue;
  a.td = plan[kDdTd]; a.th = plan[kDdTh]; a.tw = plan[kDdTw];
  a.tiles_d = plan[kDdTilesD]; a.tiles_h = plan[kDdTilesH];
  a.tiles_w = plan[kDdTilesW];
  a.nc = plan[kDdNc]; a.mt = plan[kDdMt]; a.tpb = plan[kDdTpb];
  a.blocks = plan[kDdBlocks];
  const bool pre = a.s != nullptr;
  // the bricks tile the coarse voxels that cover the fine grid
  const int cd = (a.Df + 1) / 2, ch = (a.Hf + 1) / 2, cw = (a.Wf + 1) / 2;
  const int64_t per_b = (int64_t)a.tiles_d * a.tiles_h * a.tiles_w;
  const bool shape_ok =
      a.td > 0 && a.th > 0 && a.tw > 0 && a.tiles_d > 0 && a.tiles_h > 0 &&
      a.tiles_w > 0 && 2 * a.td <= 1023 && 2 * a.th <= 1023 &&
      2 * a.tw <= 1023 && a.tiles_d * a.td >= cd &&
      (a.tiles_d - 1) * a.td < cd && a.tiles_h * a.th >= ch &&
      (a.tiles_h - 1) * a.th < ch && a.tiles_w * a.tw >= cw &&
      (a.tiles_w - 1) * a.tw < cw && (a.nc == 8 || a.nc == 16) && a.tpb > 0 &&
      per_b < 0x7fffffff && a.blocks == (per_b + a.tpb - 1) / a.tpb;
  if (!shape_ok) return cudaErrorInvalidValue;
  a.nvox = a.td * a.th * a.tw;
  a.mpad = wgrad::round_up(a.nvox, 16);
  a.kpad = wgrad::round_up(a.Cout, 16);
  a.gstr = wgrad::row_stride(a.kpad);
  a.slots = a.tpb > 1 ? 2 : 1;
  a.gvec = (a.Cout & 7) == 0 && aligned16(a.gy);
  a.wvec = (a.Cout & 7) == 0 && aligned16(a.w);
  a.xvec = (a.Cin & 7) == 0 && aligned16(a.dx) && (!pre || aligned16(a.x));
  const DdLayout L = dd_layout(a.slots, a.mpad, a.gstr, a.nc, a.nvox, pre);
  if (a.mt * 16 < a.mpad || a.mt * a.nc / 8 > 8 ||
      (a.mt != 1 && a.mt != 2 && a.mt != 4 && a.mt != 8) ||
      8 * a.nvox * (a.nc / 8) > kDdItems * kThreads || a.B > 65535 ||
      (a.Cin + a.nc - 1) / a.nc > 65535 || L.bytes > 227 * 1024 ||
      (pre && (a.t == nullptr || a.dpart == nullptr)))
    return cudaErrorInvalidValue;
  const bool fold = a.kpad / 16 > kFold;
  if (pre)
    return fold ? dispatch_down_dx_nt<true, true>(a, L.bytes, st)
                : dispatch_down_dx_nt<true, false>(a, L.bytes, st);
  return fold ? dispatch_down_dx_nt<false, true>(a, L.bytes, st)
              : dispatch_down_dx_nt<false, false>(a, L.bytes, st);
}

template <int NT>
cudaError_t launch_up_dx(const DxArgs& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        up_dx_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int64_t tiles = (int64_t)a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  const int chunks = (a.Cin + a.nc - 1) / a.nc;
  if (tiles > 0x7fffffff || chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)chunks, 1);
  dim3 block(kThreads, 1, 1);
  up_dx_kernel<NT><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t up_dx(const __nv_bfloat16* gy, const __nv_bfloat16* w,
                  __nv_bfloat16* dx, int B, int D, int H, int W, int Cin,
                  int Cout, const int* plan, cudaStream_t st) {
  DxArgs a;
  a.gy = gy; a.w = w; a.dx = dx;
  a.B = B; a.Dc = D; a.Hc = H; a.Wc = W; a.Cin = Cin; a.Cout = Cout;
  a.td = plan[kDxTd]; a.th = plan[kDxTh]; a.tw = plan[kDxTw];
  a.tiles_d = plan[kDxTilesD]; a.tiles_h = plan[kDxTilesH];
  a.tiles_w = plan[kDxTilesW]; a.nc = plan[kDxNc];
  a.nvox = a.td * a.th * a.tw;
  a.kpad = wgrad::round_up(a.nvox, 16);
  const int smem = dx_smem(a.kpad, a.nc);
  if (a.td <= 0 || a.th <= 0 || a.tw <= 0 || a.kpad > 64 ||
      a.tiles_d * a.td < D || a.tiles_h * a.th < H || a.tiles_w * a.tw < W ||
      smem > 227 * 1024 || 2 * a.td + 1 > 1023 || 2 * a.th + 1 > 1023 ||
      2 * a.tw + 1 > 1023)
    return cudaErrorInvalidValue;
  switch (a.nc) {
    case 16: return launch_up_dx<1>(a, smem, st);
    case 32: return launch_up_dx<2>(a, smem, st);
    case 64: return launch_up_dx<4>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of K3 (up != 0) or K2. x [B, D, H, W, Cin] is the forward's
// input and gy its output's cotangent ([B, 2D, 2H, 2W, Cout] for K3,
// [B, D/2, H/2, W/2, Cout] for K2). dx (like x) and dk [8, Cin, Cout] with
// db [Cout] may each be null; dk and db are written whole from the
// workspace ws [splits, 8, Cin, Cout] f32 and wsdb [splits, Cout] f64 of
// dk_plan (ops/conv3.py::wgrad_plan, mode 2 for K3, 1 for K2); dx follows
// dx_plan (ops/bridges.py::up_dx_plan for K3, ::down_dx_plan for K2). dst
// [B, 2, Cin] f32 is written whole and goes with s and t (K2's prologue)
// and needs dx, and with its workspace dpart [B, blocks, 2, Cin] f32, blocks
// the dx plan's. Returns the first launch error (0 on success).
int vaeseg_bridge_bwd(int up, const void* x, const void* gy, const void* w,
                      const void* s, const void* t, void* dx, void* dk,
                      void* db, void* dst, void* dpart, void* ws, void* wsdb,
                      int B, int D,
                      int H, int W, int Cin, int Cout, const void* dk_plan,
                      const void* dx_plan, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if (!up && (D < 2 || H < 2 || W < 2)) return cudaErrorInvalidValue;
  if ((dk == nullptr) != (db == nullptr)) return cudaErrorInvalidValue;
  if (up && s != nullptr) return cudaErrorInvalidValue;
  if (dx != nullptr && !up && ((s != nullptr) != (dst != nullptr) ||
                                (dst != nullptr) != (dpart != nullptr)))
    return cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    cudaError_t rc;
    if (up) {
      rc = up_dx(gb, static_cast<const __nv_bfloat16*>(w),
                 static_cast<__nv_bfloat16*>(dx), B, D, H, W, Cin, Cout,
                 static_cast<const int*>(dx_plan), st);
    } else {
      DownDxArgs a;
      a.x = xb; a.gy = gb;
      a.w = static_cast<const __nv_bfloat16*>(w);
      a.s = static_cast<const float*>(s);
      a.t = static_cast<const float*>(t);
      a.dx = static_cast<__nv_bfloat16*>(dx);
      a.dpart = static_cast<float*>(dpart);
      a.B = B; a.Cin = Cin; a.Cout = Cout;
      a.Dc = D / 2; a.Hc = H / 2; a.Wc = W / 2;
      a.Df = D; a.Hf = H; a.Wf = W;
      const int* p = static_cast<const int*>(dx_plan);
      rc = down_dx(a, p, st);
      if (rc == cudaSuccess && s != nullptr)
        rc = parts_reduce<float>(a.dpart, static_cast<float*>(dst), B,
                                 p[kDdBlocks], 2 * Cin, st);
    }
    if (rc != cudaSuccess) return rc;
  }
  if (dk == nullptr) return cudaSuccess;
  const int* p = static_cast<const int*>(dk_plan);
  float* wsf = static_cast<float*>(ws);
  double* wsd = static_cast<double*>(wsdb);
  float* dkf = static_cast<float*>(dk);
  float* dbf = static_cast<float*>(db);
  if (up)   // T = gy on the fine grid, D = x on the coarse grid
    return wgrad::weight_grad<wgrad::kUp>(gb, xb, nullptr, nullptr, wsf, wsd, dkf, dbf,
                              B, 2 * D, 2 * H, 2 * W, Cout, D, H, W, Cin, p,
                              st);
  // T = x on the fine grid through the prologue, D = gy on the coarse grid
  return wgrad::weight_grad<wgrad::kDown>(xb, gb, static_cast<const float*>(s),
                            static_cast<const float*>(t), wsf, wsd, dkf, dbf,
                            B, D, H, W, Cin, D / 2, H / 2, W / 2, Cout, p, st);
}

}  // extern "C"
