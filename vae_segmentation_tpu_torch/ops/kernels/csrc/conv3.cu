// K1: channels-last 3^3 SAME stride-1 conv + bias for Hopper (sm_90a), with
// an optional InstanceNorm+ReLU prologue and a stats or class-softmax
// epilogue, or the `post` epilogue that makes it the dx conv of a backward.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/stencil3.py
//   _run_conv_grouped (grouped-tap conv on the s2d-folded rep; the
//   conv3_stencil_folded[_pre] and conv3_stencil_folded_softmax[_pre]
//   forwards) and _run_conv (27-tap conv; conv3_stencil[_pre] forwards),
//   each with its `post` epilogue (_apply_post: the backward of the
//   forward's prologue, fused into the dx conv).
// The port computes in the logical representation, so one kernel covers
// both: the fold and the W-pack only existed to fill the TPU's 128 lanes.
//
//   y[b, d, h, w, o] = bias[o] + sum_{tap, c} xn[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                           * wk[tap, c, o]
//   xn = relu(x * s[b, c] + t[b, c])  (prologue, f32; out-of-volume taps
//                                       stay 0: SAME pads the normalized x)
//   stats[b, 0, o] = sum y_bf16,  stats[b, 1, o] = sum y_bf16^2
//   or y = softmax over o (Cout = n_class <= 8), f32 math, bf16 store;
//   or post: the f32 sum g is the cotangent of relu(xs * ps + pt):
//     gm = g where xs * ps + pt > 0 else 0,  y = gm * ps,
//     stats[b, 0, o] = sum gm * xs (ds),  stats[b, 1, o] = sum gm (dt),
//   over in-volume voxels only. x * s + t is two roundings (multiply, then
//   add) wherever it is computed, so the backward's mask repeats the
//   forward's arithmetic bit for bit.
//   [dlo, dhi] is the valid D-plane range (stencil3.py's dlim; default
//   [0, D - 1]): the prologue's xn is 0 on staged planes outside it, and the
//   post epilogue leaves those planes out of (ds, dt). A D-slab of a
//   spatially sharded volume carries its neighbours' boundary planes as
//   halo; an edge slab's missing neighbour is a zero plane, which the
//   prologue would turn into relu(t) != 0 without the range.
//
// What bounds it on the H100: the bytes (3.35 TB/s) at the 128^3 / 64^3
// stages (C = 1..16), the operations at the deep ones (C = 64..256 at
// 4^3..16^3, 27 C Cout MACs a voxel). The design, an implicit GEMM on the
// tensor cores (M = a tile's output voxels, N = an output-channel chunk,
// K = (input-channel chunk, tap, channel)):
// - mma.sync.m16n8k16 bf16 x bf16 -> f32. A block stages the tile's
//   (td+2)(th+2)(tw+2) input halo once per input-channel chunk (cp.async,
//   16 bytes a lane), and the chunk's [27 x ci, co] weight slice. A comes
//   in by ldmatrix: each lane hands it the address of one voxel's row at
//   the tap's offset into the halo, so the 27-tap im2col is an address
//   offset and never a copy (with 8-channel chunks one k16 step covers two
//   taps). B comes in by ldmatrix.trans from the weight slice.
// - The prologue is applied once per staged element, in f32, and its xn
//   enters as three bf16 terms, xn = hi + mid + lo (hi = bf16(xn), mid =
//   bf16(xn - hi), lo = bf16(xn - hi - mid), each difference exact in
//   f32), issued as three MMAs: the sum keeps xn's 24 bits. Two terms keep
//   ~16 (2^-18 a term, ~2.5e-6 of y): ten times the plain version's bf16
//   rounding flips, enough to miss the gate on the stats of a 4^3 stage's
//   64 voxels a channel; one bf16 rounding (2^-9) misses every gate that
//   holds a call or a pass to the plain version's f32 xn.
// - Channel counts that are not a multiple of 8 (Cin 1, 2; Cout 2) are
//   zero-padded to 8 by plain loads, not refused.
// - The tensor cores' f32 accumulation truncates, and a chain of MMAs
//   drifts with its length (as in conv3_dk), so each chain of at most
//   kFold k16 steps starts from zero and joins an f32 register total by a
//   rounded add.
// - The few-tile deep stages split K (the (chunk, tap, channel) steps) over
//   the grid's z axis as well as N over its y axis: each split writes its
//   f32 partial once into a workspace [splits, B, voxels, Cout], and
//   conv3_reduce_kernel adds the splits in a fixed order in f64, then
//   applies bias and the epilogue. Elsewhere one pass applies them to the
//   accumulator fragments.
// - No atomics: the stats and (ds, dt) sums reduce a warp's rows with
//   shuffles, the warps in a fixed order through shared memory, write one
//   [2, chunk] partial per block, and parts_reduce (common.cuh) adds the
//   blocks' partials in a fixed order in f64. y, the stats and (ds, dt) are
//   the same bits on every run.
// The plan (tile, warp grid, chunks, splits) is computed by
// the Python wrapper (ops/conv3.py::conv3_plan) and passed in; vaeseg_conv3
// checks it and lays out the shared memory it needs (conv_layout), refusing
// a plan that does not fit.

#include "wgrad.cuh"

namespace {

using wgrad::kThreads;
using wgrad::kWarps;

// k16 steps a chain of MMAs, at most (tools/k1_fold_error.py builds the
// kernel with other lengths, -DCONV3_FOLD=N, to measure what they cost)
#ifndef CONV3_FOLD
#define CONV3_FOLD 8
#endif
constexpr int kFold = CONV3_FOLD;
static_assert(kFold > 0, "a chain holds at least one k16 step");

// the plan's fields, in order (ops/conv3.py::CONV3_FIELDS)
enum PlanField {
  kPlanTd, kPlanTh, kPlanTw, kPlanTilesD, kPlanTilesH, kPlanTilesW,
  kPlanCi, kPlanWm, kPlanWn, kPlanMt, kPlanNt, kPlanSplits, kPlanRvox,
  kPlanParts
};

enum Epilogue { kNone = 0, kStats = 1, kSoftmax = 2, kPost = 3 };

struct Args {
  const __nv_bfloat16* x;   // [B, D, H, W, Cin]
  const __nv_bfloat16* w;   // [27, Cin, Cout], tap = (kd * 3 + kh) * 3 + kw
  const float* bias;        // [Cout], or null
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  const __nv_bfloat16* xs;  // post: [B, D, H, W, Cout], the forward's input
  const float* ps;          // post: [B, Cout] scale
  const float* pt;          // post: [B, Cout] shift
  __nv_bfloat16* y;         // [B, D, H, W, Cout]
  float* ws;                // [splits, B, D H W, Cout] f32 (splits > 1)
  float* part;              // [B, parts, 2, Cout] f32 (stats and post)
  int64_t nvol;             // D H W
  int B, D, H, W, Cin, Cout, epi;
  int dlo, dhi;             // the valid D-plane range (prologue and post)
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int ci, wm, wn, mt, nt, splits, rvox, parts;
  int nvox, mtiles, co, co_chunks, ci_chunks, nks, hrows, astr, wstr;
  bool xvec, wvec;          // 16-byte rows of x / wk: cp.async, else loads
};

// byte offsets of the conv kernel's shared memory
struct Layout {
  int a, lo, w, toff, red, bytes;
};

__host__ __device__ inline Layout conv_layout(int hrows, int astr, int wrows,
                                              int wstr, bool split, int wm,
                                              int co) {
  Layout l;
  l.a = 0;                                   // [hrows][astr] bf16 (x or hi)
  l.lo = l.a + hrows * astr * 2;             // [2][hrows][astr] (prologue:
                                             // mid, lo)
  l.w = l.lo + (split ? 2 * hrows * astr * 2 : 0);  // [wrows][wstr]
  l.toff = l.w + wrows * wstr * 2;           // [32] int
  l.red = l.toff + 32 * 4;                   // [wm][2][co] f32
  l.bytes = l.red + wm * 2 * co * 4;
  return l;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Stage the halo of input channels [c0, c0 + ci) of the tile whose corner
// (the halo's, one voxel before the tile) is (od, oh, ow): row r is halo
// voxel r (w fastest), zero outside the volume and past Cin. With the
// prologue, xn = relu(x * s + t) in f32 goes in as hi (into sa), mid and
// lo (into sl, the halo's size apart), and is 0 on planes outside
// [dlo, dhi].
template <bool SPLIT>
__device__ __forceinline__ void stage_halo(const Args& a, __nv_bfloat16* sa,
                                           __nv_bfloat16* sl, int b, int c0,
                                           int od, int oh, int ow) {
  const int hsz = a.hrows * a.astr;
  const int hh = a.th + 2, hw = a.tw + 2;
  const int lg = a.ci == 8 ? 0 : 1;  // 16-byte units a row
  const bool vec = a.xvec;
  for (int i = threadIdx.x; i < (a.hrows << lg); i += kThreads) {
    const int r = i >> lg, g = i & ((1 << lg) - 1);
    const int gd = od + r / (hh * hw), gh = oh + (r / hw) % hh,
              gw = ow + r % hw;
    const int c = c0 + 8 * g;
    const bool ok = gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 &&
                    gw < a.W && c < a.Cin;
    const int64_t off =
        ok ? ((((int64_t)b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin + c : 0;
    __nv_bfloat16* out = sa + r * a.astr + 8 * g;
    if (!SPLIT && vec) {
      wgrad::cp_async16(out, a.x + off, ok);
      continue;
    }
    __align__(16) __nv_bfloat16 v[8];
    if (vec) {
      *reinterpret_cast<uint4*>(v) =
          ok ? *reinterpret_cast<const uint4*>(a.x + off) : make_uint4(0, 0, 0, 0);
    } else {
      for (int j = 0; j < 8; ++j)
        v[j] = (ok && c + j < a.Cin) ? a.x[off + j] : __float2bfloat16(0.f);
    }
    if (!SPLIT) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(v);
      continue;
    }
    __align__(16) __nv_bfloat16 hi[8];
    __align__(16) __nv_bfloat16 mid[8];
    __align__(16) __nv_bfloat16 lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float xn = 0.f;
      if (ok && c + j < a.Cin && gd >= a.dlo && gd <= a.dhi) {
        const int sc = b * a.Cin + c + j;
        xn = fmaxf(pre_activation(__bfloat162float(v[j]), a.s[sc], a.t[sc]),
                   0.f);
      }
      hi[j] = __float2bfloat16(xn);
      const float rem = xn - __bfloat162float(hi[j]);
      mid[j] = __float2bfloat16(rem);
      lo[j] = __float2bfloat16(rem - __bfloat162float(mid[j]));
    }
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(hi);
    __nv_bfloat16* rest = sl + r * a.astr + 8 * g;
    *reinterpret_cast<uint4*>(rest) = *reinterpret_cast<const uint4*>(mid);
    *reinterpret_cast<uint4*>(rest + hsz) =
        *reinterpret_cast<const uint4*>(lo);
  }
}

// Stage the weight rows [r0, r1) of input-channel chunk c0: row k is
// (tap = k / ci, channel c0 + k % ci), columns the output channels
// [co0, co0 + co); zero for the padding tap 27, past Cin and past Cout.
__device__ __forceinline__ void stage_weights(const Args& a,
                                              __nv_bfloat16* sw, int c0,
                                              int co0, int r0, int r1) {
  const int lgu = a.co == 8 ? 0 : a.co == 16 ? 1 : a.co == 32 ? 2 : 3;
  const int lgci = a.ci == 8 ? 3 : 4;
  const bool vec = a.wvec;
  for (int i = threadIdx.x; i < ((r1 - r0) << lgu); i += kThreads) {
    const int r = r0 + (i >> lgu), g = i & ((1 << lgu) - 1);
    const int tap = r >> lgci, c = c0 + (r & (a.ci - 1)), n = co0 + 8 * g;
    const bool ok = tap < 27 && c < a.Cin && n < a.Cout;
    const int64_t off = ok ? ((int64_t)tap * a.Cin + c) * a.Cout + n : 0;
    __nv_bfloat16* out = sw + r * a.wstr + 8 * g;
    if (vec) {
      wgrad::cp_async16(out, a.w + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && n + j < a.Cout) ? a.w[off + j] : __float2bfloat16(0.f);
    }
  }
}

// The epilogue of one (voxel, channel) value v = the conv sum + bias at
// plane od: returns what y stores and adds to the two sums of the stats (of
// the stored bf16 value) or post ((ds, dt), planes in [dlo, dhi] only)
// epilogue.
__device__ __forceinline__ float epilogue(const Args& a, float v, int b,
                                          int64_t vox, int od, int c,
                                          float& s1, float& s2) {
  if (a.epi == kPost) {
    const int sc = b * a.Cout + c;
    const float xv = __bfloat162float(a.xs[vox * a.Cout + c]);
    const float ps = a.ps[sc];
    const float gm = pre_activation(xv, ps, a.pt[sc]) > 0.f ? v : 0.f;
    if (od >= a.dlo && od <= a.dhi) {
      s1 += gm * xv;
      s2 += gm;
    }
    return gm * ps;
  }
  if (a.epi == kStats) {
    const float r = bf16_round(v);
    s1 += r;
    s2 += r * r;
  }
  return v;
}

// One block: the output tile blockIdx.x (batch-major), the output-channel
// chunk blockIdx.y, the K split blockIdx.z. MT m16 tiles by NT n8 tiles a
// warp; SPLIT: the prologue's hi + mid + lo split of xn.
template <int MT, int NT, bool SPLIT>
__global__ void __launch_bounds__(kThreads) conv3_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = conv_layout(a.hrows, a.astr, a.nks * 16, a.wstr, SPLIT,
                               a.wm, a.co);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  __nv_bfloat16* sl = reinterpret_cast<__nv_bfloat16*>(smem + L.lo);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wmi = warp % a.wm, wni = warp / a.wm;
  const int per_b = a.tiles_d * a.tiles_h * a.tiles_w;
  const int b = blockIdx.x / per_b, tile = blockIdx.x % per_b;
  const int d0 = tile / (a.tiles_h * a.tiles_w) * a.td;
  const int h0 = (tile / a.tiles_w) % a.tiles_h * a.th;
  const int w0 = tile % a.tiles_w * a.tw;
  const int co0 = blockIdx.y * a.co;
  const int split = blockIdx.z;
  const int hh = a.th + 2, hw = a.tw + 2;
  const int nb = wni * NT * 8;               // this warp's first column
  const int lgci = a.ci == 8 ? 3 : 4;

  // the halo row of each tap's (0, 0, 0) offset; the padding tap 27 (its
  // weights are zero) reads row 0
  if (tid < 28) {
    const int tap = tid < 27 ? tid : 0;
    toff[tid] = ((tap / 9) * hh + (tap / 3) % 3) * hw + tap % 3;
  }
  // this lane's voxel row (A: lanes 0-15 rows 0-15 of a m16 tile, k 0-7;
  // lanes 16-31 the same rows, k 8-15) for each of its warp's m16 tiles
  // (m16 tile wmi + wm * j); padding rows read halo row 0 and are never
  // stored
  int arow[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = (wmi + a.wm * j) * 16 + (lane & 15);
    arow[j] = m < a.nvox
                  ? ((m / (a.th * a.tw)) * hh + (m / a.tw) % a.th) * hw +
                        m % a.tw
                  : 0;
  }
  const int a_kh = (lane >> 4) << 3;                     // A: k half
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);  // B: k row
  const int b_n = (lane >> 4) << 3;                       // B: n in n16

  float acc[MT][NT][4], total[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = total[j][n][e] = 0.f;

  // this split's k16 steps [k0, k1) of ci_chunks x nks
  const int K = a.ci_chunks * a.nks;
  const int k0 = (int)((int64_t)K * split / a.splits);
  const int k1 = (int)((int64_t)K * (split + 1) / a.splits);
  int chain = 0;
  for (int c = k0 / a.nks; c * a.nks < k1; ++c) {
    const int ks0 = max(k0 - c * a.nks, 0), ks1 = min(k1 - c * a.nks, a.nks);
    __syncthreads();   // the previous chunk's reads are done
    stage_halo<SPLIT>(a, sa, sl, b, c * a.ci, d0 - 1, h0 - 1, w0 - 1);
    stage_weights(a, sw, c * a.ci, co0, ks0 * 16, ks1 * 16);
    wgrad::cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t bf[NT][2];
      const __nv_bfloat16* brow = sw + (ks * 16 + b_k) * a.wstr + nb;
      if (NT == 1) {
        wgrad::ldmatrix_x2_trans(bf[0], brow);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          wgrad::ldmatrix_x4_trans(r, brow + b_n + 16 * p);
          bf[2 * p][0] = r[0]; bf[2 * p][1] = r[1];
          bf[2 * p + 1][0] = r[2]; bf[2 * p + 1][1] = r[3];
        }
      }
      const int kk = ks * 16 + a_kh;
      const int aoff = toff[kk >> lgci] * a.astr + (kk & (a.ci - 1));
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (wmi + a.wm * j >= a.mtiles) break;   // warp-uniform
        uint32_t af[4];
        wgrad::ldmatrix_x4(af, sa + arow[j] * a.astr + aoff);
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
        if (SPLIT) {
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            wgrad::ldmatrix_x4(
                af, sl + part * a.hrows * a.astr + arow[j] * a.astr + aoff);
#pragma unroll
            for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[j][n], af, bf[n]);
          }
        }
      }
      if (++chain == kFold) {
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
  }
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        total[j][n][e] = __fadd_rn(total[j][n][e], acc[j][n][e]);

  // ---- the C fragments: lane (g, q) holds rows g and g + 8 of each m16
  // tile, columns 2q and 2q + 1 of each n8 tile
  const int g = lane >> 2, q = lane & 3;
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
      const bool valid = m < a.nvox && od < a.D && oh < a.H && ow < a.W;
      const int64_t vox =
          valid ? (((int64_t)b * a.D + od) * a.H + oh) * a.W + ow : 0;
      float v[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[n][e] = total[j][n][2 * h + e];
      if (a.splits > 1) {
        if (!valid) continue;
        float* out = a.ws + ((int64_t)split * a.B * a.nvol + vox) * a.Cout;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = co0 + nb + n * 8 + 2 * q;
          if ((a.Cout & 1) == 0 && c + 1 < a.Cout) {
            *reinterpret_cast<float2*>(out + c) = make_float2(v[n][0], v[n][1]);
          } else {
            if (c < a.Cout) out[c] = v[n][0];
            if (c + 1 < a.Cout) out[c + 1] = v[n][1];
          }
        }
        continue;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = co0 + nb + n * 8 + 2 * q + e;
          if (a.bias != nullptr && c < a.Cout) v[n][e] += a.bias[c];
        }
      if (a.epi == kSoftmax) {
        // one n8 tile holds every class (Cout <= 8): a row's classes sit
        // in the four lanes of its quad
        const bool v0 = 2 * q < a.Cout, v1 = 2 * q + 1 < a.Cout;
        const float ninf = __int_as_float(0xff800000);
        float mx = fmaxf(v0 ? v[0][0] : ninf, v1 ? v[0][1] : ninf);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float e0 = v0 ? expf(v[0][0] - mx) : 0.f;
        const float e1 = v1 ? expf(v[0][1] - mx) : 0.f;
        float sum = e0 + e1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
        v[0][0] = e0 * inv;
        v[0][1] = e1 * inv;
      }
      if (!valid) continue;
      __nv_bfloat16* yp = a.y + vox * a.Cout;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = co0 + nb + n * 8 + 2 * q;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < a.Cout)
            o[e] = epilogue(a, v[n][e], b, vox, od, c + e, s1[n][e],
                            s2[n][e]);
        if ((a.Cout & 1) == 0 && c + 1 < a.Cout) {
          *reinterpret_cast<__nv_bfloat162*>(yp + c) =
              __floats2bfloat162_rn(o[0], o[1]);
        } else {
          if (c < a.Cout) yp[c] = __float2bfloat16(o[0]);
          if (c + 1 < a.Cout) yp[c + 1] = __float2bfloat16(o[1]);
        }
      }
    }
  }
  if (a.splits > 1 || (a.epi != kStats && a.epi != kPost)) return;

  // ---- the block's [2, co] sums: the warp's rows by shuffles, the warps
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
        red[(wmi * 2) * a.co + col] = s1[n][e];
        red[(wmi * 2 + 1) * a.co + col] = s2[n][e];
      }
  }
  __syncthreads();
  if (tid < 2 * a.co) {
    const int st = tid / a.co, col = tid % a.co;
    float sum = 0.f;
    for (int w = 0; w < a.wm; ++w) sum += red[(w * 2 + st) * a.co + col];
    if (co0 + col < a.Cout)
      a.part[(((int64_t)b * a.parts + tile) * 2 + st) * a.Cout + co0 + col] =
          sum;
  }
}

// The split plans' second pass: y = the sum of the splits' partials in
// f64 in split order, rounded once, + bias, through the epilogue, and the
// block's [2, Cout] sums written once. Block (b = blockIdx.y, voxels
// [blockIdx.x rvox, + rvox)); thread (row r, channel c) with 256 / Cout
// rows (Cout a power of two, at most 256).
__global__ void __launch_bounds__(kThreads) conv3_reduce_kernel(const Args a) {
  extern __shared__ float rsum[];   // [rows][2][Cout]
  const int tid = threadIdx.x;
  const int c = tid & (a.Cout - 1), r = tid / a.Cout, rows = kThreads / a.Cout;
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.rvox;
  const int64_t v1 = min(v0 + a.rvox, a.nvol);
  const int64_t stride = (int64_t)a.B * a.nvol * a.Cout;
  const float bias = a.bias != nullptr ? a.bias[c] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int64_t v = v0 + r; v < v1; v += rows) {
    const int64_t vox = (int64_t)b * a.nvol + v;
    const float* in = a.ws + vox * a.Cout + c;
    double sum = 0.0;
    for (int s = 0; s < a.splits; ++s) sum += in[s * stride];
    const float out = epilogue(a, (float)sum + bias, b, vox,
                               (int)(v / ((int64_t)a.H * a.W)), c, s1, s2);
    a.y[vox * a.Cout + c] = __float2bfloat16(out);
  }
  if (a.part == nullptr) return;
  rsum[(r * 2) * a.Cout + c] = s1;
  rsum[(r * 2 + 1) * a.Cout + c] = s2;
  __syncthreads();
  for (int i = tid; i < 2 * a.Cout; i += kThreads) {
    const int st = i / a.Cout, cc = i % a.Cout;
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += rsum[(k * 2 + st) * a.Cout + cc];
    a.part[(((int64_t)b * a.parts + blockIdx.x) * 2 + st) * a.Cout + cc] = sum;
  }
}

template <int MT, int NT, bool SPLIT>
cudaError_t launch_conv(const Args& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3_kernel<MT, NT, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((unsigned)(a.B * a.tiles_d * a.tiles_h * a.tiles_w),
                  (unsigned)a.co_chunks, (unsigned)a.splits);
  conv3_kernel<MT, NT, SPLIT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// MT x NT <= 8 m16n8 tiles a warp: a thread holds two f32 sets of them
template <int MT, bool SPLIT>
cudaError_t dispatch_nt(const Args& a, int smem, cudaStream_t st) {
  switch (a.nt) {
    case 1: return launch_conv<MT, 1, SPLIT>(a, smem, st);
    case 2: return launch_conv<MT, 2, SPLIT>(a, smem, st);
    case 4:
      if constexpr (MT <= 2) return launch_conv<MT, 4, SPLIT>(a, smem, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <bool SPLIT>
cudaError_t dispatch(const Args& a, int smem, cudaStream_t st) {
  switch (a.mt) {
    case 1: return dispatch_nt<1, SPLIT>(a, smem, st);
    case 2: return dispatch_nt<2, SPLIT>(a, smem, st);
    case 4: return dispatch_nt<4, SPLIT>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, D, H, W, Cin] and wk [27, Cin, Cout] bf16; bias [Cout] f32 or null;
// (s, t) [B, Cin] f32 the prologue or null; epi 0 none, 1 stats, 2 softmax,
// 3 post (xs [B, D, H, W, Cout] bf16 and (ps, pt) [B, Cout] f32); [dlo, dhi]
// the valid D-plane range of the prologue and the post sums; y
// [B, D, H, W, Cout] bf16; stats [B, 2, Cout] f32 (epi 1 and 3), written
// whole; ws [splits, B, D H W, Cout] f32 (splits > 1) and part
// [B, parts, 2, Cout] f32 (epi 1 and 3) the workspace of `plan`
// (ops/conv3.py::conv3_plan). Returns the first launch error (0 on
// success), or cudaErrorInvalidValue for arguments or a plan this file does
// not compute.
int vaeseg_conv3(const void* x, const void* w, const void* bias, const void* s,
                 const void* t, const void* xs, const void* ps, const void* pt,
                 void* y, void* stats, void* ws, void* part, int B, int D,
                 int H, int W, int Cin, int Cout, int epi, int dlo, int dhi,
                 const void* plan, void* stream) {
  const int* p = static_cast<const int*>(plan);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.xs = static_cast<const __nv_bfloat16*>(xs);
  a.ps = static_cast<const float*>(ps);
  a.pt = static_cast<const float*>(pt);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = static_cast<float*>(ws);
  a.part = static_cast<float*>(part);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.epi = epi;
  a.dlo = dlo; a.dhi = dhi;
  a.nvol = (int64_t)D * H * W;
  a.td = p[kPlanTd]; a.th = p[kPlanTh]; a.tw = p[kPlanTw];
  a.tiles_d = p[kPlanTilesD]; a.tiles_h = p[kPlanTilesH];
  a.tiles_w = p[kPlanTilesW];
  a.ci = p[kPlanCi]; a.wm = p[kPlanWm]; a.wn = p[kPlanWn];
  a.mt = p[kPlanMt]; a.nt = p[kPlanNt]; a.splits = p[kPlanSplits];
  a.rvox = p[kPlanRvox]; a.parts = p[kPlanParts];
  a.nvox = a.td * a.th * a.tw;
  a.mtiles = (a.nvox + 15) / 16;
  a.co = a.wn * a.nt * 8;
  a.co_chunks = (Cout + a.co - 1) / a.co;
  a.ci_chunks = (Cin + a.ci - 1) / a.ci;
  a.nks = (27 * a.ci + 15) / 16;
  a.hrows = (a.td + 2) * (a.th + 2) * (a.tw + 2);
  a.astr = wgrad::row_stride(a.ci);
  a.wstr = wgrad::row_stride(a.co);
  a.xvec = (Cin & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.wvec = (Cout & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool split = s != nullptr;
  const bool sums = epi == kStats || epi == kPost;
  const Layout L = conv_layout(a.hrows, a.astr, a.nks * 16, a.wstr, split,
                               a.wm, a.co);
  const int64_t per_b = (int64_t)a.tiles_d * a.tiles_h * a.tiles_w;
  const int rows = Cout <= kThreads ? kThreads / Cout : 0;
  const bool bad =
      B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      epi < kNone || epi > kPost || (s == nullptr) != (t == nullptr) ||
      dlo < 0 || dhi >= D || dlo > dhi ||
      sums != (stats != nullptr) || sums != (part != nullptr) ||
      (epi == kPost && (xs == nullptr || ps == nullptr || pt == nullptr)) ||
      a.td <= 0 || a.th <= 0 || a.tw <= 0 || a.tiles_d * a.td < D ||
      a.tiles_h * a.th < H || a.tiles_w * a.tw < W ||
      (a.tiles_d - 1) * a.td >= D || (a.tiles_h - 1) * a.th >= H ||
      (a.tiles_w - 1) * a.tw >= W ||
      (a.ci != 8 && a.ci != 16) || a.wm * a.wn != kWarps ||
      a.wm <= 0 || a.mtiles > a.wm * a.mt || a.co > 64 ||
      a.co_chunks > 65535 || a.splits <= 0 ||
      a.splits > a.ci_chunks * a.nks || a.splits > 65535 ||
      (int64_t)B * per_b > 0x7fffffff || L.bytes > 227 * 1024 ||
      (epi == kSoftmax && (Cout > 8 || a.co != 8 || a.splits != 1)) ||
      (a.splits > 1 &&
       (ws == nullptr || !pow2(Cout) || Cout > kThreads || a.rvox <= 0 ||
        a.rvox % rows != 0 ||
        (sums && a.parts != (a.nvol + a.rvox - 1) / a.rvox) ||
        (a.nvol + a.rvox - 1) / a.rvox > 0x7fffffff)) ||
      (a.splits == 1 && sums && a.parts != per_b);
  if (bad) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = split ? dispatch<true>(a, L.bytes, st)
                          : dispatch<false>(a, L.bytes, st);
  if (err != cudaSuccess) return err;
  if (a.splits > 1) {
    const dim3 grid((unsigned)((a.nvol + a.rvox - 1) / a.rvox), (unsigned)B, 1);
    conv3_reduce_kernel<<<grid, kThreads, sizeof(float) * 2 * kThreads, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!sums) return cudaSuccess;
  return parts_reduce<float>(a.part, static_cast<float*>(stats), B, a.parts,
                             2 * Cout, st);
}

}  // extern "C"
