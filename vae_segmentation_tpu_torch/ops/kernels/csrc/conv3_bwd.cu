// conv3_bwd: the merged backward of K1 (the channels-last 3^3 SAME stride-1
// conv) for Hopper (sm_90a): dx (with the prologue's backward and its
// (ds, dt)), dk and db from one main launch that stages each brick of x and
// gy once for both products, where the default backward runs K1 as the dx
// conv and then conv3_dk.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/stencil3.py
//   _run_bwd_grouped (the merged grouped-tap backward, _bwd_kernel_grouped,
//   taken under VAESEG_MERGED_BWD=1), with and without the prologue. The port
//   computes in the logical representation, so the grouped taps are 27
//   dense taps here and the W-pack is not ported.
//
//   dx[b, v, c]  = sum_{tap, o} gy[b, v + tap - 1, o] * wk[26 - tap, c, o]
//                  (K1 on the flipped, transposed weight), and with the
//                  prologue relu(x * s + t) its backward, as K1's `post`
//                  epilogue: gm = dx where x * s + t > 0 else 0, dx = gm * s,
//                  ds[b, c] = sum gm * x, dt[b, c] = sum gm;
//   dk[tap, c, o] = sum_{b, v} xn[b, v + tap - 1, c] * gy[b, v, o],
//   db[o]         = sum_{b, v} gy[b, v, o],
//   xn = relu(x * s + t) with the prologue, else x; out-of-volume taps are 0,
//   and x * s + t is rounded as in every kernel of the port (common.cuh).
//   [dlo, dhi] is the valid D-plane range (stencil3.py's dlim, default
//   [0, D - 1]), as in K1: under the prologue dk's xn is 0 on planes
//   outside it and (ds, dt) leave those planes out.
//
// What bounds it on the H100: the two products' 54 Cin Cout MACs a voxel,
// so the bytes at the 128^3 / 64^3 stages (C = 2..16) and the tensor-core
// operations at the deep ones. The design, two implicit GEMMs on mma.sync
// (m16n8k16, bf16 x bf16 -> f32) fed from the same staged halos:
// - A block owns one input-channel chunk (CI = 8 or 16), one output-channel
//   chunk (CO = 8 or 16) and a fixed contiguous range of bricks: split s of
//   S takes bricks [s n / S, (s + 1) n / S). A brick's x halo (CI channels)
//   and gy halo (CO channels) come in by cp.async through a two-slot ring,
//   so the next brick's copy overlaps this brick's MMAs; the flipped weight
//   slice [CI rows][(tap, o)] is staged once a block. Brick geometry (each
//   halo row's position, each voxel's halo row) sits in shared tables.
// - dk as wgrad.cuh's tile: M = (tap, c), N = o, K = the brick's voxels;
//   A by ldmatrix.trans at each tap's row offset into the x halo, B by
//   ldmatrix.trans from the gy halo's centre rows. Under the prologue the
//   f32 xn is split hi + lo (two MMAs, ~2^-17 a term).
// - dx as K1's implicit GEMM: M = the brick's voxels, N = the CI channels,
//   K = (tap, o) in k16 steps; A by ldmatrix at the tap's row offset into
//   the gy halo, B by ldmatrix from the weight slice. gy and the weight are
//   both bf16, so one MMA a product is exact.
// - The tensor cores' f32 accumulation truncates, so each chain of at most
//   kFold k16 steps starts from zero and joins an f32 total by a rounded add
//   (both products).
// - No atomics, and every sum in a fixed order. The block's dk partial and
//   (for the first CI chunk) its f64 db partial are written once into a
//   workspace, and wgrad::dk_reduce_kernel adds the splits in f64 in order.
//   With one CO chunk dx is whole in the block: the `post` epilogue runs on
//   the accumulator fragments and each brick's (ds, dt) partial is written
//   once. With several, each CO chunk's f32 dx partial goes to a workspace
//   and bwd_dx_reduce_kernel adds the chunks in f64 in order, then applies
//   the epilogue. parts_reduce (common.cuh) adds the (ds, dt) partials in
//   f64 in order. Every output is the same bits on every run.
// The plan (brick, chunks, warp grid, splits) is computed by the Python
// wrapper (ops/conv3.py::conv3_bwd_plan) and passed in; vaeseg_conv3_bwd
// checks it and lays out the shared memory it needs (bwd_layout), refusing a
// plan that does not fit.

#include "wgrad.cuh"

namespace {

using wgrad::kThreads;
using wgrad::kWarps;

constexpr int kFold = 8;   // k16 steps a chain of MMAs, at most

// the plan's fields, in order (ops/conv3.py::CONV3_BWD_FIELDS)
enum PlanField {
  kPlanTd, kPlanTh, kPlanTw, kPlanTilesD, kPlanTilesH, kPlanTilesW,
  kPlanCi, kPlanCo, kPlanWm, kPlanWn, kPlanMt, kPlanNt, kPlanSplits,
  kPlanRvox, kPlanParts
};

struct Args {
  const __nv_bfloat16* x;   // [B, D, H, W, Cin], the forward's input
  const __nv_bfloat16* gy;  // [B, D, H, W, Cout]
  const __nv_bfloat16* w;   // [27, Cin, Cout], the forward's kernel layout
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  __nv_bfloat16* dx;        // [B, D, H, W, Cin]
  float* wsx;               // [co_chunks, B D H W, Cin] f32 (co_chunks > 1)
  float* wsk;               // [splits, 27, Cin, Cout] f32
  double* wsdb;             // [splits, Cout] f64
  float* part;              // [B, parts, 2, Cin] f32 (prologue)
  int64_t nvol;             // D H W
  int B, D, H, W, Cin, Cout;
  int dlo, dhi;             // the valid D-plane range (prologue)
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int ci, co, wm, wn, mt, nt, splits, rvox, parts;
  int nvox, kpad, mtiles, ci_chunks, co_chunks, nks, hrows, xstr, gstr, wstr;
  bool wvec;                // 16-byte rows of the weight: cp.async
};

// byte offsets of the main kernel's shared memory
struct Layout {
  int x, lo, g, w, toff, hpos, arow, brow, red, db, bytes;
};

__host__ __device__ inline Layout bwd_layout(int hrows, int xstr, int gstr,
                                             int ci, int wstr, int kpad,
                                             int wm, bool split) {
  Layout l;
  l.x = 0;                                      // [2][hrows][xstr] bf16
  l.lo = l.x + 2 * hrows * xstr * 2;            // [hrows][xstr] (prologue)
  l.g = l.lo + (split ? hrows * xstr * 2 : 0);  // [2][hrows + 1][gstr]
  l.w = l.g + 2 * (hrows + 1) * gstr * 2;       // [ci][wstr]
  l.toff = l.w + ci * wstr * 2;                 // [32] int
  l.hpos = l.toff + 32 * 4;                     // [hrows] int
  l.arow = l.hpos + hrows * 4;                  // [kpad] int
  l.brow = l.arow + kpad * 4;                   // [kpad] int
  l.red = l.brow + kpad * 4;                    // [wm][2][ci] f32
  l.db = wgrad::round_up(l.red + wm * 2 * ci * 4, 8);  // [kThreads] f64
  l.bytes = l.db + kThreads * 8;
  return l;
}

// Stage the block's weight slice: row c of the input-channel chunk c0,
// column k = tap * co + o the forward's weight at the flipped tap 26 - tap,
// channel c0 + c, output o0 + o; zero past Cin, Cout and the 27 taps (an
// 8-channel chunk pads its 14th k16 step with a zero tap 27).
__device__ __forceinline__ void stage_weights(const Args& a,
                                              __nv_bfloat16* sw, int c0,
                                              int o0) {
  const int units = a.nks * 2;    // 8-channel units of K a row
  for (int i = threadIdx.x; i < a.ci * units; i += kThreads) {
    const int c = i / units, k = 8 * (i % units);
    const int tap = k / a.co, o = o0 + k % a.co, cc = c0 + c;
    const bool ok = tap < 27 && cc < a.Cin && o < a.Cout;
    const int64_t off = ok ? ((int64_t)(26 - tap) * a.Cin + cc) * a.Cout + o
                           : 0;
    __nv_bfloat16* out = sw + c * a.wstr + k;
    if (a.wvec) {
      wgrad::cp_async16(out, a.w + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && o + j < a.Cout) ? a.w[off + j] : __float2bfloat16(0.f);
    }
  }
}

// One block: split blockIdx.x of the bricks, chunk pair blockIdx.y =
// (input-channel chunk, output-channel chunk). CI / CO: the chunks; MT x NT
// m16 x n8 tiles of dx a warp; SPLIT: the prologue's hi + lo split of xn.
template <int CI, int CO, int MT, int NT, bool SPLIT>
__global__ void __launch_bounds__(kThreads) conv3_bwd_kernel(const Args a) {
  constexpr int MTW = CI == 8 ? 2 : 4;   // dk's m16 tiles a warp
  constexpr int NK = CO / 8;             // dk's n8 tiles
  constexpr int cib_n = CI / 8;          // 8-channel blocks of the CI chunk
  constexpr int mblocks = 27 * cib_n;    // dk's m8 blocks: (tap, block)
  constexpr int mtiles_k = (mblocks + 1) / 2;
  constexpr int lgco = CO == 8 ? 3 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = bwd_layout(a.hrows, a.xstr, a.gstr, CI, a.wstr, a.kpad,
                              a.wm, SPLIT);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  __nv_bfloat16* slo = reinterpret_cast<__nv_bfloat16*>(smem + L.lo);
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem + L.g);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  int* hpos = reinterpret_cast<int*>(smem + L.hpos);
  int* arow = reinterpret_cast<int*>(smem + L.arow);
  int* brow = reinterpret_cast<int*>(smem + L.brow);
  float* red = reinterpret_cast<float*>(smem + L.red);
  double* sdb = reinterpret_cast<double*>(smem + L.db);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cib = blockIdx.y / a.co_chunks, cob = blockIdx.y % a.co_chunks;
  const int c0 = cib * CI, o0 = cob * CO;
  const int hh = a.th + 2, hw = a.tw + 2;
  const int xsz = a.hrows * a.xstr, gsz = (a.hrows + 1) * a.gstr;
  const int centre = (hh + 1) * hw + 1;    // tap 13's halo row offset

  // ---- geometry, once per block: each tap's halo row offset (the padding
  // tap 27 reads row 0), each halo row's position, each voxel's halo row at
  // tap 0 (arow; padding voxels read row 0) and at the centre (brow; padding
  // voxels read the zero row past the halo)
  if (tid < 28) {
    const int tap = tid < 27 ? tid : 0;
    toff[tid] = ((tap / 9) * hh + (tap / 3) % 3) * hw + tap % 3;
  }
  for (int r = tid; r < a.hrows; r += kThreads)
    hpos[r] = wgrad::pack(r / (hh * hw), (r / hw) % hh, r % hw);
  for (int k = tid; k < a.kpad; k += kThreads) {
    const bool live = k < a.nvox;
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    arow[k] = live ? (kd * hh + kh) * hw + kw : 0;
    brow[k] = live ? (kd * hh + kh) * hw + kw + centre : a.hrows;
  }
  for (int i = tid; i < 2 * a.gstr; i += kThreads)
    sg[(i / a.gstr) * gsz + a.hrows * a.gstr + i % a.gstr] =
        __float2bfloat16(0.f);
  stage_weights(a, sw, c0, o0);
  __syncthreads();

  // dx: the warp grid wm x wn over the brick's m16 tiles and the chunk's n8
  // tiles; this lane's voxel row for each of its m16 tiles (A: lanes 0-15
  // rows 0-15, k 0-7; lanes 16-31 the same rows, k 8-15); B from the weight
  // rows: lanes 0-7 / 8-15 rows n 0-7 at k 0 / 8, lanes 16-31 rows n 8-15
  const int wmi = warp % a.wm, wni = warp / a.wm;
  const int nb = wni * NT * 8;
  int arow_x[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = (wmi + a.wm * j) * 16 + (lane & 15);
    arow_x[j] = m < a.nvox ? ((m / (a.th * a.tw)) * hh + (m / a.tw) % a.th) *
                                     hw + m % a.tw
                           : 0;
  }
  const int a_kh = (lane >> 4) << 3;
  const int wb_n = (lane & 7) + ((lane >> 4) << 3);
  const int wb_k = ((lane >> 3) & 1) << 3;
  // dk (wgrad.cuh's lane mapping): this lane's element offset into the x
  // halo for each of its warp's m16 tiles (lanes 0-7 and 16-23 the tile's
  // first m8 block, 8-15 and 24-31 its second; a padding block reads tap 0
  // and is never written out); the voxel of its A and B rows in a k16 step
  int aoff[MTW];
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    int blk = 2 * (warp + kWarps * j) + ((lane >> 3) & 1);
    if (blk >= mblocks) blk = 0;
    const int tap = blk / cib_n;
    aoff[j] = (((tap / 9) * hh + (tap / 3) % 3) * hw + tap % 3) * a.xstr +
              (blk % cib_n) * 8;
  }
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = (lane >> 4) << 3;

  // db: gy's sum at the centre, by the blocks of the first CI chunk; thread
  // (part, channel) over every parts-th voxel, in f64
  const bool sums_bias = cib == 0;
  const int bias_c = tid & (CO - 1), bias_part = tid / CO;
  constexpr int bias_parts = kThreads / CO;
  double bsum = 0.0;

  float dtot[MTW][NK][4];
#pragma unroll
  for (int j = 0; j < MTW; ++j)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dtot[j][n][e] = 0.f;

  const int per_b = a.tiles_d * a.tiles_h * a.tiles_w;
  const int64_t ntiles = (int64_t)a.B * per_b;
  const int64_t first = ntiles * blockIdx.x / a.splits;
  const int64_t last = ntiles * (blockIdx.x + 1) / a.splits;

  auto origin = [&](int64_t tile, int& b, int& d0, int& h0, int& w0) {
    const int r = (int)(tile % per_b);
    b = (int)(tile / per_b);
    d0 = r / (a.tiles_h * a.tiles_w) * a.td;
    h0 = (r / a.tiles_w) % a.tiles_h * a.th;
    w0 = r % a.tiles_w * a.tw;
  };
  auto stage = [&](int64_t tile, int slot) {
    int b, d0, h0, w0;
    origin(tile, b, d0, h0, w0);
    wgrad::stage_rows(sx + slot * xsz, a.xstr, hpos, a.hrows, a.x, b, a.D,
                      a.H, a.W, a.Cin, c0, CI, d0 - 1, h0 - 1, w0 - 1);
    wgrad::stage_rows(sg + slot * gsz, a.gstr, hpos, a.hrows, a.gy, b, a.D,
                      a.H, a.W, a.Cout, o0, CO, d0 - 1, h0 - 1, w0 - 1);
  };

  if (first < last) stage(first, 0);
  wgrad::cp_async_commit();
  for (int64_t tile = first; tile < last; ++tile) {
    const int slot = (int)((tile - first) & 1);
    if (tile + 1 < last) stage(tile + 1, slot ^ 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();
    __syncthreads();
    int b, d0, h0, w0;
    origin(tile, b, d0, h0, w0);
    __nv_bfloat16* xs = sx + slot * xsz;
    const __nv_bfloat16* gs = sg + slot * gsz;
    if (SPLIT) {
      // xn = relu(x * s + t) in f32, zero outside the volume (SAME pads the
      // normalized tensor) and outside [dlo, dhi]: hi = bf16(xn) in place,
      // lo = bf16(xn - hi)
      const int c = tid & (CI - 1);
      const bool cin = c0 + c < a.Cin;
      const float sv = cin ? a.s[b * a.Cin + c0 + c] : 0.f;
      const float tv = cin ? a.t[b * a.Cin + c0 + c] : 0.f;
      const int lgc = CI == 8 ? 3 : 4;
      for (int i = tid; i < (a.hrows << lgc); i += kThreads) {
        const int row = i >> lgc;
        const int pp = hpos[row];
        const int gd = d0 - 1 + (pp >> 20), gh = h0 - 1 + ((pp >> 10) & 1023),
                  gw = w0 - 1 + (pp & 1023);
        float v = 0.f;
        if (cin && gd >= a.dlo && gd <= a.dhi && gh >= 0 && gh < a.H &&
            gw >= 0 && gw < a.W)
          v = fmaxf(pre_activation(__bfloat162float(xs[row * a.xstr + c]), sv,
                                   tv), 0.f);
        const __nv_bfloat16 hv = __float2bfloat16(v);
        xs[row * a.xstr + c] = hv;
        slo[row * a.xstr + c] = __float2bfloat16(v - __bfloat162float(hv));
      }
      __syncthreads();
    }

    // ---- dk: M = (tap, channel), N = the CO chunk, K = the brick's voxels
    {
      float acc[MTW][NK][4];
#pragma unroll
      for (int j = 0; j < MTW; ++j)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
      int chain = 0;
      for (int ks = 0; ks < a.kpad; ks += 16) {
        uint32_t bf[NK][2];
        const __nv_bfloat16* bp = gs + brow[ks + b_k] * a.gstr;
        if (NK == 1) {
          wgrad::ldmatrix_x2_trans(bf[0], bp);
        } else {
          uint32_t r[4];
          wgrad::ldmatrix_x4_trans(r, bp + b_n);
          bf[0][0] = r[0]; bf[0][1] = r[1];
          bf[NK - 1][0] = r[2]; bf[NK - 1][1] = r[3];
        }
        const int ar = arow[ks + a_k] * a.xstr;
#pragma unroll
        for (int j = 0; j < MTW; ++j) {
          if (warp + kWarps * j >= mtiles_k) break;   // warp-uniform
          uint32_t af[4];
          wgrad::ldmatrix_x4_trans(af, xs + ar + aoff[j]);
#pragma unroll
          for (int n = 0; n < NK; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
          if (SPLIT) {
            wgrad::ldmatrix_x4_trans(af, slo + ar + aoff[j]);
#pragma unroll
            for (int n = 0; n < NK; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
          }
        }
        if (++chain == kFold || ks + 16 >= a.kpad) {
          chain = 0;
#pragma unroll
          for (int j = 0; j < MTW; ++j)
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dtot[j][n][e] = __fadd_rn(dtot[j][n][e], acc[j][n][e]);
                acc[j][n][e] = 0.f;
              }
        }
      }
    }
    if (sums_bias)
      for (int r = bias_part; r < a.nvox; r += bias_parts)
        bsum += (double)__bfloat162float(gs[brow[r] * a.gstr + bias_c]);

    // ---- dx: M = the brick's voxels, N = the CI chunk, K = (tap, o)
    float acc[MT][NT][4], total[MT][NT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] = total[j][n][e] = 0.f;
    int chain = 0;
    for (int ks = 0; ks < a.nks; ++ks) {
      uint32_t bf[NT][2];
      const __nv_bfloat16* wp = sw + (nb + wb_n) * a.wstr + ks * 16 + wb_k;
      if (NT == 1) {
        wgrad::ldmatrix_x2(bf[0], wp);
      } else {
        uint32_t r[4];
        wgrad::ldmatrix_x4(r, wp);
        bf[0][0] = r[0]; bf[0][1] = r[1];
        bf[NT - 1][0] = r[2]; bf[NT - 1][1] = r[3];
      }
      const int kk = ks * 16 + a_kh;
      const int aoffx = toff[kk >> lgco] * a.gstr + (kk & (CO - 1));
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (wmi + a.wm * j >= a.mtiles) break;   // warp-uniform
        uint32_t af[4];
        wgrad::ldmatrix_x4(af, gs + arow_x[j] * a.gstr + aoffx);
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
      }
      if (++chain == kFold || ks + 1 == a.nks) {
        chain = 0;
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[j][n][e] = __fadd_rn(total[j][n][e], acc[j][n][e]);
              acc[j][n][e] = 0.f;
            }
      }
    }

    // ---- dx's C fragments: lane (g, q) holds rows g and g + 8 of each m16
    // tile, columns 2q and 2q + 1 of each n8 tile. One CO chunk: the post
    // epilogue and the store; several: this chunk's f32 partial
    const int g = lane >> 2, q = lane & 3;
    const bool direct = a.co_chunks == 1;
    float s1[NT][2], s2[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wmi + a.wm * j) * 16 + g + 8 * h;
        const int od = d0 + m / (a.th * a.tw), oh = h0 + (m / a.tw) % a.th,
                  ow = w0 + m % a.tw;
        if (m >= a.nvox || od >= a.D || oh >= a.H || ow >= a.W) continue;
        const int64_t vox = (((int64_t)b * a.D + od) * a.H + oh) * a.W + ow;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = c0 + nb + n * 8 + 2 * q;
          float v[2] = {total[j][n][2 * h], total[j][n][2 * h + 1]};
          const bool pair = (a.Cin & 1) == 0 && c + 1 < a.Cin;
          if (!direct) {
            float* out = a.wsx + ((int64_t)cob * a.B * a.nvol + vox) * a.Cin;
            if (pair) {
              *reinterpret_cast<float2*>(out + c) = make_float2(v[0], v[1]);
            } else {
              if (c < a.Cin) out[c] = v[0];
              if (c + 1 < a.Cin) out[c + 1] = v[1];
            }
            continue;
          }
          if (SPLIT) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e >= a.Cin) continue;
              const int sc = b * a.Cin + c + e;
              const float xv = __bfloat162float(a.x[vox * a.Cin + c + e]);
              const float sv = a.s[sc];
              const float gm = pre_activation(xv, sv, a.t[sc]) > 0.f ? v[e]
                                                                    : 0.f;
              if (od >= a.dlo && od <= a.dhi) {
                s1[n][e] += gm * xv;
                s2[n][e] += gm;
              }
              v[e] = gm * sv;
            }
          }
          __nv_bfloat16* dp = a.dx + vox * a.Cin;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(dp + c) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            if (c < a.Cin) dp[c] = __float2bfloat16(v[0]);
            if (c + 1 < a.Cin) dp[c + 1] = __float2bfloat16(v[1]);
          }
        }
      }
    }
    if (SPLIT && direct) {
      // the brick's [2, CI] (ds, dt): the warp's rows by shuffles, the warps
      // of one column range in order through shared memory, written once
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1[n][e] += __shfl_xor_sync(0xffffffffu, s1[n][e], off);
            s2[n][e] += __shfl_xor_sync(0xffffffffu, s2[n][e], off);
          }
      if (g == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb + n * 8 + 2 * q + e;
            red[(wmi * 2) * CI + col] = s1[n][e];
            red[(wmi * 2 + 1) * CI + col] = s2[n][e];
          }
      }
      __syncthreads();
      if (tid < 2 * CI) {
        const int st = tid / CI, col = tid % CI;
        float sum = 0.f;
        for (int w = 0; w < a.wm; ++w) sum += red[(w * 2 + st) * CI + col];
        if (c0 + col < a.Cin)
          a.part[(((int64_t)b * a.parts + tile % per_b) * 2 + st) * a.Cin +
                 c0 + col] = sum;
      }
    }
    __syncthreads();   // this brick's slot and red are free again
  }

  // ---- this block's dk partial, written once
  float* out = a.wsk + (int64_t)blockIdx.x * 27 * a.Cin * a.Cout;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int mt = warp + kWarps * j;
    if (mt >= mtiles_k) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int blk = 2 * mt + half;
      if (blk >= mblocks) continue;
      const int tap = blk / cib_n;
      const int c = c0 + (blk % cib_n) * 8 + g;
      if (c >= a.Cin) continue;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + n * 8 + 2 * q + e;
          if (o < a.Cout)
            out[((int64_t)tap * a.Cin + c) * a.Cout + o] =
                dtot[j][n][2 * half + e];
        }
    }
  }
  if (sums_bias) {
    sdb[tid] = bsum;
    __syncthreads();
    if (tid < CO && o0 + tid < a.Cout) {
      double sum = 0.0;
      for (int p = 0; p < bias_parts; ++p) sum += sdb[p * CO + tid];
      a.wsdb[(int64_t)blockIdx.x * a.Cout + o0 + tid] = sum;
    }
  }
}

// With several CO chunks: dx = the chunks' f32 partials added in f64 in
// chunk order, rounded once, through the post epilogue, and the block's
// [2, Cin] (ds, dt) written once. Block (b = blockIdx.y, voxels
// [blockIdx.x rvox, + rvox)); thread (row r, channel c) with cpad (a power
// of two, at least Cin) channels a row and 256 / cpad rows.
__global__ void __launch_bounds__(kThreads) bwd_dx_reduce_kernel(const Args a,
                                                                 int cpad) {
  extern __shared__ float rsum[];   // [rows][2][cpad]
  const int tid = threadIdx.x, rows = kThreads / cpad;
  const int c = tid & (cpad - 1), r = tid / cpad, b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.rvox;
  const int64_t v1 = min(v0 + a.rvox, a.nvol);
  const int64_t stride = (int64_t)a.B * a.nvol * a.Cin;
  float s1 = 0.f, s2 = 0.f;
  if (c < a.Cin) {
    for (int64_t v = v0 + r; v < v1; v += rows) {
      const int64_t vox = (int64_t)b * a.nvol + v;
      const float* in = a.wsx + vox * a.Cin + c;
      double sum = 0.0;
      for (int k = 0; k < a.co_chunks; ++k) sum += in[k * stride];
      float out = (float)sum;
      if (a.s != nullptr) {
        const int sc = b * a.Cin + c;
        const float xv = __bfloat162float(a.x[vox * a.Cin + c]);
        const float gm = pre_activation(xv, a.s[sc], a.t[sc]) > 0.f ? out : 0.f;
        const int od = (int)(v / ((int64_t)a.H * a.W));
        if (od >= a.dlo && od <= a.dhi) {
          s1 += gm * xv;
          s2 += gm;
        }
        out = gm * a.s[sc];
      }
      a.dx[vox * a.Cin + c] = __float2bfloat16(out);
    }
  }
  if (a.s == nullptr) return;
  rsum[(r * 2) * cpad + c] = s1;
  rsum[(r * 2 + 1) * cpad + c] = s2;
  __syncthreads();
  for (int i = tid; i < 2 * a.Cin; i += kThreads) {
    const int st = i / a.Cin, cc = i % a.Cin;
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += rsum[(k * 2 + st) * cpad + cc];
    a.part[(((int64_t)b * a.parts + blockIdx.x) * 2 + st) * a.Cin + cc] = sum;
  }
}

template <int CI, int CO, int MT, int NT, bool SPLIT>
cudaError_t launch_main(const Args& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3_bwd_kernel<CI, CO, MT, NT, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((unsigned)a.splits, (unsigned)(a.ci_chunks * a.co_chunks),
                  1);
  conv3_bwd_kernel<CI, CO, MT, NT, SPLIT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dx's warp tiles: MT m16 tiles (1 or 2) by NT n8 tiles (the CI chunk's
// n8 tiles over wn warps: 1, or 2 for a 16-channel chunk on one warp column)
template <int CI, int CO, bool SPLIT>
cudaError_t dispatch_tiles(const Args& a, int smem, cudaStream_t st) {
  if (a.mt == 1 && a.nt == 1) return launch_main<CI, CO, 1, 1, SPLIT>(a, smem, st);
  if (a.mt == 2 && a.nt == 1) return launch_main<CI, CO, 2, 1, SPLIT>(a, smem, st);
  if constexpr (CI == 16) {
    if (a.mt == 1 && a.nt == 2) return launch_main<CI, CO, 1, 2, SPLIT>(a, smem, st);
    if (a.mt == 2 && a.nt == 2) return launch_main<CI, CO, 2, 2, SPLIT>(a, smem, st);
  }
  return cudaErrorInvalidValue;
}

template <bool SPLIT>
cudaError_t dispatch(const Args& a, int smem, cudaStream_t st) {
  if (a.ci == 8 && a.co == 8) return dispatch_tiles<8, 8, SPLIT>(a, smem, st);
  if (a.ci == 8 && a.co == 16) return dispatch_tiles<8, 16, SPLIT>(a, smem, st);
  if (a.ci == 16 && a.co == 8) return dispatch_tiles<16, 8, SPLIT>(a, smem, st);
  if (a.ci == 16 && a.co == 16)
    return dispatch_tiles<16, 16, SPLIT>(a, smem, st);
  return cudaErrorInvalidValue;
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, dx [B, D, H, W, Cin] and gy [B, D, H, W, Cout] bf16; w [27, Cin, Cout]
// bf16 (the forward's kernel layout, read flipped); (s, t) [B, Cin] f32 the
// prologue or null, and then dst [B, 2, Cin] f32 = (ds, dt) over the planes
// [dlo, dhi] (which also bound dk's xn) and part
// [B, parts, 2, Cin] f32; dk [27, Cin, Cout] and db [Cout] f32; wsx
// [co_chunks, B D H W, Cin] f32 (co_chunks > 1), wsk [splits, 27, Cin, Cout]
// f32 and wsdb [splits, Cout] f64 the workspace of `plan`
// (ops/conv3.py::conv3_bwd_plan). Every output is written whole. Returns the
// first launch error (0 on success), or cudaErrorInvalidValue for arguments
// or a plan this file does not compute.
int vaeseg_conv3_bwd(const void* x, const void* gy, const void* w,
                     const void* s, const void* t, void* dx, void* dst,
                     void* dk, void* db, void* wsx, void* wsk, void* wsdb,
                     void* part, int B, int D, int H, int W, int Cin, int Cout,
                     int dlo, int dhi, const void* plan, void* stream) {
  const int* p = static_cast<const int*>(plan);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.wsx = static_cast<float*>(wsx);
  a.wsk = static_cast<float*>(wsk);
  a.wsdb = static_cast<double*>(wsdb);
  a.part = static_cast<float*>(part);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.dlo = dlo; a.dhi = dhi;
  a.nvol = (int64_t)D * H * W;
  a.td = p[kPlanTd]; a.th = p[kPlanTh]; a.tw = p[kPlanTw];
  a.tiles_d = p[kPlanTilesD]; a.tiles_h = p[kPlanTilesH];
  a.tiles_w = p[kPlanTilesW];
  a.ci = p[kPlanCi]; a.co = p[kPlanCo]; a.wm = p[kPlanWm]; a.wn = p[kPlanWn];
  a.mt = p[kPlanMt]; a.nt = p[kPlanNt]; a.splits = p[kPlanSplits];
  a.rvox = p[kPlanRvox]; a.parts = p[kPlanParts];
  a.nvox = a.td * a.th * a.tw;
  a.kpad = wgrad::round_up(a.nvox, 16);
  a.mtiles = (a.nvox + 15) / 16;
  a.ci_chunks = (Cin + a.ci - 1) / a.ci;
  a.co_chunks = (Cout + a.co - 1) / a.co;
  a.nks = (27 * a.co + 15) / 16;
  a.hrows = (a.td + 2) * (a.th + 2) * (a.tw + 2);
  a.xstr = wgrad::row_stride(a.ci);
  a.gstr = wgrad::row_stride(a.co);
  a.wstr = a.nks * 16 + 8;   // an odd number of 16-byte units
  a.wvec = (Cout & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool split = s != nullptr;
  const Layout L = bwd_layout(a.hrows, a.xstr, a.gstr, a.ci, a.wstr, a.kpad,
                              a.wm, split);
  const int64_t per_b = (int64_t)a.tiles_d * a.tiles_h * a.tiles_w;
  const int cpad = pow2_at_least(Cin > 0 ? Cin : 1);
  const int rows = cpad <= kThreads ? kThreads / cpad : 0;
  const bool bad =
      B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      dlo < 0 || dhi >= D || dlo > dhi ||
      (s == nullptr) != (t == nullptr) || split != (dst != nullptr) ||
      split != (part != nullptr) || wsk == nullptr || wsdb == nullptr ||
      a.td <= 0 || a.th <= 0 || a.tw <= 0 || a.tiles_d * a.td < D ||
      a.tiles_h * a.th < H || a.tiles_w * a.tw < W ||
      (a.tiles_d - 1) * a.td >= D || (a.tiles_h - 1) * a.th >= H ||
      (a.tiles_w - 1) * a.tw >= W || a.td + 2 > 1023 || a.th + 2 > 1023 ||
      a.tw + 2 > 1023 || (a.ci != 8 && a.ci != 16) ||
      (a.co != 8 && a.co != 16) || a.wm <= 0 || a.wn <= 0 ||
      a.wm * a.wn != kWarps || a.wn * a.nt * 8 != a.ci ||
      a.wm * a.mt < a.mtiles ||
      (int64_t)a.ci_chunks * a.co_chunks > 65535 || a.splits <= 0 ||
      a.splits > B * per_b || B * per_b > 0x7fffffff ||
      L.bytes > 227 * 1024 ||
      (a.co_chunks > 1 &&
       (wsx == nullptr || rows == 0 || a.rvox <= 0 ||
        (a.nvol + a.rvox - 1) / a.rvox > 0x7fffffff ||
        (split && a.parts != (a.nvol + a.rvox - 1) / a.rvox))) ||
      (a.co_chunks == 1 && split && a.parts != per_b);
  if (bad) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = split ? dispatch<true>(a, L.bytes, st)
                          : dispatch<false>(a, L.bytes, st);
  if (err != cudaSuccess) return err;
  if (a.co_chunks > 1) {
    const dim3 grid((unsigned)((a.nvol + a.rvox - 1) / a.rvox), (unsigned)B,
                    1);
    bwd_dx_reduce_kernel<<<grid, kThreads,
                           sizeof(float) * 2 * rows * cpad, st>>>(a, cpad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (split) {
    err = parts_reduce<float>(a.part, static_cast<float*>(dst), B, a.parts,
                              2 * Cin, st);
    if (err != cudaSuccess) return err;
  }
  const int64_t n_dk = (int64_t)27 * Cin * Cout;
  const int64_t blocks = (n_dk + Cout + 31) / 32;
  wgrad::dk_reduce_kernel<wgrad::kMerged><<<(unsigned)blocks, kThreads, 0, st>>>(
      a.wsk, a.wsdb, static_cast<float*>(dk), static_cast<float*>(db), n_dk,
      Cout, a.splits);
  return cudaGetLastError();
}

}  // extern "C"
