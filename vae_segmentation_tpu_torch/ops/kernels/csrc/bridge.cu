// K2 and K3: the stage-boundary bridges for Hopper (sm_90a), channels-last
// bf16 in and out, f32 accumulation, f32 bias added in the accumulator.
//
// K2 down_k2s2 replaces (TPU, Pallas) vae_segmentation_tpu/ops/pallas/
//   upbridge.py::_run_down_fwd (down_bridge_w) and _run_down_fwd_pre
//   (down_bridge_w_pre): the Down entry, a 2^3 stride-2 VALID conv
//     y[b, i, o] = bias[o] + sum_{a in 2^3, c} xn[b, 2i + a, c] * wk[a, c, o]
//   with the optional prologue xn = relu(x * s[b, c] + t[b, c]) in f32.
//   The TPU kernel's optional stats output is not ported: the Down conv's
//   output feeds the next conv raw, so nothing reads its statistics.
// K3 up_k2s2 replaces upbridge.py::_run_fwd (up_bridge_w): the Up entry, a
//   2^3 stride-2 ConvTranspose in torch's semantics
//     y[b, 2i + a, o] = bias[o] + sum_c x[b, i, c] * wk[a, c, o]
//   (wk[a, c, o] = W_torch[c, o, a]).
// The TPU kernels' routing matrices only existed to scatter into the
// folded, W-packed lane layout; in the logical layout both are one GEMM
// over the coarse voxels i with a gather (K2) or a scatter (K3).
//
// What bounds them on the H100: the bytes (3.35 TB/s) at the 128^3 / 64^3
// / 32^3 stages (8 C_in C_out MACs per coarse voxel against 9 voxels of
// traffic), the latency of a few small blocks at the deep ones (64-512
// coarse voxels, C 64-256). The design:
// - A brick is td x th x tw coarse voxels (M, padded to m16 tiles) by a
//   chunk of nc (8 or 16) output channels. A block walks tpb bricks of one
//   channel chunk (bricks blockIdx.x + k gridDim.x): it stages the chunk's
//   [8, kc, nc] weight slice once, and each brick's input rows by cp.async
//   (16 bytes a lane, zero outside the volume and past C_in) into a
//   two-slot ring of shared-memory rows an odd number of 16-byte units
//   apart, so that the next brick's loads are in flight while this one
//   computes and stores. K comes in chunks of at most kc channels (one on
//   the models' path; with more, the weight slice rides in the ring too).
// - K3, on the tensor cores (mma.sync m16n8k16 bf16 x bf16 -> f32, the
//   helpers of wgrad.cuh; A by ldmatrix, B by ldmatrix.trans): M = coarse
//   voxels, K = C_in, N = (tap, channel): warp w computes tap w for every
//   m16 tile of the brick. Its f32 sums (+ bias, rounded to bf16 once) go
//   into the brick's fine voxels 2i + a in shared memory, and the block
//   writes each fine row of 2tw voxels with 16-byte stores: channels-last,
//   one contiguous run when nc = C_out.
// - K2 without the prologue, on the tensor cores: M = coarse voxels, K =
//   (tap, channel), N = channel: the block stages the brick's 8 M fine rows
//   once, and a tap is an ldmatrix row offset into them (as
//   bridge_bwd.cu::up_dx_kernel). The warps split the m16 tiles (wm) and
//   the k16 steps (wk): the deep stages, where a brick is one m16 tile, give
//   each warp one tap. The wk partials meet in shared memory, added in f32
//   in warp order, + bias, rounded once, and each coarse row is written
//   with 16-byte stores: no atomics, the same bits on every run. Bricks
//   hold about 32 KB of fine rows (256 coarse voxels at C_in 8), so the
//   per-brick work amortises at the byte-bound stages.
// - K2 with the prologue (the Down entry of both nets, C_in 8 at 128^3),
//   on the CUDA cores in f32 behind the same staging: a thread takes a
//   coarse voxel and 8 output channels, applies xn = relu(x * s + t)
//   (common.cuh's rounding) to its 8 C_in staged inputs and adds each
//   xn * w in f32 in (tap, channel) order, the weights f32 in shared
//   memory. The call is byte-bound (K = 64, N = 8), and the f32 xn has 24
//   bits: on the tensor cores it takes three bf16 MMAs (hi + mid + lo, as
//   K1 does), and the split alone costs as many instructions per element as
//   these eight FMAs, so that version ran well above both this one and the
//   call's byte bound.
// - The tensor cores' f32 accumulation truncates, so each chain of at most
//   kFold k16 steps starts from zero and joins an f32 total by a rounded
//   add, K1's fold: every tensor-core kernel of the port rounds alike (a
//   call with no longer chains keeps one accumulator: FOLD false).
// - No division per element: a brick's geometry (each staged row's
//   position, each fragment row's fine voxel, each store's voxel) is the
//   same for every brick, so a block works it out once into shared tables,
//   and a brick only adds its origin. At the byte-bound stages the index
//   arithmetic, not the bytes, was the limit: with its global stores
//   removed, a 64^3 -> 128^3 K3 call took about as long.
// - Channel counts that are not a multiple of 8 are staged by plain loads
//   and zero-padded; ragged bricks are masked at the store.
// The plan (brick, channel chunks, warp grid, bricks a block) is computed
// by the Python wrapper (ops/bridges.py::bridge_plan) and passed in;
// vaeseg_bridge checks it and lays out the shared memory it needs
// (bridge_layout), refusing a plan that does not fit.

#include "wgrad.cuh"

namespace {

using wgrad::kThreads;
using wgrad::kWarps;
using wgrad::row_stride;

// k16 steps a chain of MMAs, at most (conv3.cu's CONV3_FOLD)
constexpr int kFold = 8;

// the plan's fields, in order (ops/bridges.py::BRIDGE_FIELDS)
enum PlanField {
  kPlanTd, kPlanTh, kPlanTw, kPlanTilesD, kPlanTilesH, kPlanTilesW,
  kPlanNc, kPlanMt, kPlanWm, kPlanWk, kPlanKc, kPlanTpb
};

struct Args {
  const __nv_bfloat16* x;  // [B, D, H, W, Cin] (input grid)
  const __nv_bfloat16* w;  // [8, Cin, Cout], a = (ad * 2 + ah) * 2 + aw
  const float* bias;       // [Cout]
  const float* s;          // [B, Cin] prologue scale (down only), or null
  const float* t;          // [B, Cin] prologue shift
  __nv_bfloat16* y;        // [B, Do, Ho, Wo, Cout]
  int B, D, H, W, Cin, Cout;  // input dims
  int Dc, Hc, Wc;             // the coarse grid (up: input, down: output)
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int nc, mt, wm, wk, kc, tpb;
  int nvox, mpad, cpad;       // brick voxels, padded to m16; K channels
  int ntiles, kchunks, slots; // bricks of the call; K chunks; ring slots
  int istr, wstr;             // row strides (bf16) of the staged rows
  bool xvec, wvec, yvec;      // 16-byte rows: cp.async / vector stores
};

// byte offsets of the shared memory: the input ring (`slots` of the staged
// rows: up, the brick's mpad coarse rows; down, its 8 nvox fine rows, then
// under the prologue the [2, kc] f32 (s, t)), the [8 kc, nc] weight rows
// (bf16; f32 under the prologue; in the ring too when K has more than one
// chunk), the brick's geometry tables (up: each coarse row's position, its
// fine voxel at tap 0, each fine voxel's position; down: each fine row's
// position), the 8 taps' fine-row offsets (down), and the output staging
// (up: the fine brick [8 nvox, nc] bf16; down without the prologue: the
// warps' partials [wk, mpad, nc] f32)
struct Layout {
  int in, in_slot, st, w, w_slot, pos, toff, out, bytes;
};

__host__ __device__ inline Layout bridge_layout(bool up, bool pre,
                                                int nvox, int mpad, int kc,
                                                int nc, int wk, int slots,
                                                bool wring) {
  Layout l;
  const int rows = up ? mpad : 8 * nvox;
  l.in = 0;
  l.st = rows * row_stride(kc) * 2;   // within a slot
  l.in_slot = l.st + (pre ? 2 * kc * 4 : 0);
  l.w = l.in + slots * l.in_slot;
  l.w_slot = 8 * kc * (pre ? nc * 4 : row_stride(nc) * 2);
  l.pos = l.w + (wring ? slots : 1) * l.w_slot;
  l.toff = l.pos + (up ? 2 * mpad + 8 * nvox : rows) * 4;
  l.out = l.toff + 8 * 4;
  l.bytes = l.out + (up ? 8 * nvox * row_stride(nc) * 2
                        : pre ? 0 : wk * mpad * row_stride(nc) * 4);
  return l;
}

// a position in a brick, 10 bits a coordinate (wgrad::pack)
__device__ __forceinline__ int pd(int p) { return p >> 20; }
__device__ __forceinline__ int ph(int p) { return (p >> 10) & 1023; }
__device__ __forceinline__ int pw(int p) { return p & 1023; }

// r / n, with lg = log2 n where n is a power of two, else -1
__device__ __forceinline__ int div_by(int r, int n, int lg) {
  return lg >= 0 ? r >> lg : r / n;
}

__device__ __forceinline__ int log2_or_minus1(int n) {
  return (n & (n - 1)) == 0 ? __ffs(n) - 1 : -1;
}

struct Brick {
  int b, d0, h0, w0;
};

__device__ __forceinline__ Brick brick_at(const Args& a, int tile) {
  Brick r;
  const int per_b = a.tiles_d * a.tiles_h * a.tiles_w;
  r.b = tile / per_b;
  tile -= r.b * per_b;
  const int hw = a.tiles_h * a.tiles_w;
  const int kd = tile / hw;
  tile -= kd * hw;
  const int kh = tile / a.tiles_w;
  r.d0 = kd * a.td;
  r.h0 = kh * a.th;
  r.w0 = (tile - kh * a.tiles_w) * a.tw;
  return r;
}

// This block's steps: (brick k, K chunk) for its bricks blockIdx.x +
// k gridDim.x (k < tpb) and each chunk; returns how many.
__device__ __forceinline__ int block_steps(const Args& a) {
  const int mine = (a.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  return min(mine, a.tpb) * a.kchunks;
}

__device__ __forceinline__ Brick step_brick(const Args& a, int step) {
  return brick_at(a, blockIdx.x + step / a.kchunks * gridDim.x);
}

// Stage `rows` input rows of channels [c0, c0 + cw) (cw a multiple of 8)
// at stride a.istr: row r from the grid's voxel (od, oh, ow) + pos[r] of
// batch b, zero where pos[r] < 0, outside the volume and past Cin.
__device__ __forceinline__ void stage_input(const Args& a, __nv_bfloat16* dst,
                                            const int* pos, int rows, int b,
                                            int od, int oh, int ow, int c0,
                                            int cw) {
  const int units = cw >> 3, lg = log2_or_minus1(units);
  for (int i = threadIdx.x; i < rows * units; i += kThreads) {
    const int r = div_by(i, units, lg), u = i - r * units;
    const int pp = pos[r];
    const int gd = od + pd(pp), gh = oh + ph(pp), gw = ow + pw(pp);
    const int c = c0 + 8 * u;
    const bool ok = pp >= 0 && gd < a.D && gh < a.H && gw < a.W && c < a.Cin;
    const int64_t off =
        ok ? ((((int64_t)b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin + c : 0;
    __nv_bfloat16* out = dst + r * a.istr + 8 * u;
    if (a.xvec) {
      wgrad::cp_async16(out, a.x + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && c + j < a.Cin) ? a.x[off + j] : __float2bfloat16(0.f);
    }
  }
}

// Stage the weight rows of channels [c0, c0 + cw) and output channels
// [o0, o0 + nc): row tap * cw + k holds wk[tap, c0 + k, o0 ...], zero past
// Cin and Cout; bf16 at stride a.wstr by cp.async, or (F32) f32 at stride
// nc by plain loads.
template <bool F32>
__device__ __forceinline__ void stage_weights(const Args& a, void* dst,
                                              int c0, int cw, int o0) {
  const int units = a.nc >> 3;
  for (int i = threadIdx.x; i < 8 * cw * units; i += kThreads) {
    const int r = i / units, u = i - r * units;
    const int tap = r / cw, c = c0 + r % cw, o = o0 + 8 * u;
    const bool ok = c < a.Cin && o < a.Cout;
    const int64_t off = ok ? ((int64_t)tap * a.Cin + c) * a.Cout + o : 0;
    if (F32) {
      float* out = static_cast<float*>(dst) + r * a.nc + 8 * u;
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && o + j < a.Cout) ? __bfloat162float(a.w[off + j]) : 0.f;
      continue;
    }
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dst) + r * a.wstr + 8 * u;
    if (a.wvec) {
      wgrad::cp_async16(out, a.w + off, ok);
    } else {
      for (int j = 0; j < 8; ++j)
        out[j] = (ok && o + j < a.Cout) ? a.w[off + j] : __float2bfloat16(0.f);
    }
  }
}

// the B fragments of one k16 step (rows row0 + 0..15 of the staged
// weights, NT n8 tiles from column 0)
template <int NT>
__device__ __forceinline__ void load_b(uint32_t bf[NT][2],
                                       const __nv_bfloat16* ws, int wstr,
                                       int row0, int lane) {
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = (lane >> 4) << 3;
  const __nv_bfloat16* brow = ws + (row0 + b_k) * wstr;
  if (NT == 1) {
    wgrad::ldmatrix_x2_trans(bf[0], brow);
  } else {
    uint32_t r[4];
    wgrad::ldmatrix_x4_trans(r, brow + b_n);
    bf[0][0] = r[0]; bf[0][1] = r[1];
    bf[1][0] = r[2]; bf[1][1] = r[3];
  }
}

// The f32 sums of a warp's m16n8 tiles: MMA chains of at most kFold k16
// steps, each joining the total with a rounded add (FOLD), or one chain
// (the call's chains are no longer: no second accumulator).
template <int MT, int NT, bool FOLD>
struct Sums {
  float acc[MT][NT][4];
  float total[FOLD ? MT : 1][FOLD ? NT : 1][4];
  int chain;

  __device__ __forceinline__ void start() {
    chain = 0;
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][n][e] = 0.f;
          if (FOLD) total[FOLD ? j : 0][FOLD ? n : 0][e] = 0.f;
        }
  }

  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& t = total[FOLD ? j : 0][FOLD ? n : 0][e];
          t = __fadd_rn(t, acc[j][n][e]);
          acc[j][n][e] = 0.f;
        }
  }

  // after each k16 step
  __device__ __forceinline__ void step() {
    if (FOLD && ++chain == kFold) {
      chain = 0;
      fold();
    }
  }

  // after the last: the sums are in acc
  __device__ __forceinline__ void finish() {
    if (!FOLD) return;
    fold();
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][n][e] = total[FOLD ? j : 0][FOLD ? n : 0][e];
  }
};

// K3: block (bricks of blockIdx.x, channel chunk blockIdx.y); warp w
// computes tap w: MT m16 tiles (the brick's) by NT n8 tiles (nc = 8 NT
// channels). Each brick's f32 sums + bias, rounded to bf16 once, go into
// the fine brick ys, and the fine brick out in 16-byte stores,
// neighbouring lanes on neighbouring channel groups, then voxels along w.
template <int MT, int NT, bool FOLD>
__global__ void __launch_bounds__(kThreads) up_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 8 * NT;
  const bool wring = a.kchunks > 1;
  const Layout L = bridge_layout(true, false, a.nvox, a.mpad, a.kc, NC, 1,
                                 a.slots, wring);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L.out);
  int* pos = reinterpret_cast<int*>(smem + L.pos);   // [mpad] coarse rows
  int* mfine = pos + a.mpad;          // [mpad] fine voxel 2i (tap 0), or -1
  int* fpos = mfine + a.mpad;         // [8 nvox] fine voxels' positions
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int o0 = blockIdx.y * NC;
  const int a_row = lane & 15, a_kh = (lane >> 4) << 3;
  const int g = lane >> 2, q = lane & 3;
  const int fh = 2 * a.th, fw = 2 * a.tw;
  const int ystr = row_stride(NC);
  const int tapoff = ((tap >> 2) * fh + ((tap >> 1) & 1)) * fw + (tap & 1);
  const int nsteps = block_steps(a);

  // the brick's geometry, once
  for (int m = tid; m < a.mpad; m += kThreads) {
    const int kd = m / (a.th * a.tw), kh = (m / a.tw) % a.th, kw = m % a.tw;
    pos[m] = m < a.nvox ? wgrad::pack(kd, kh, kw) : -1;
    mfine[m] = m < a.nvox ? (2 * kd * fh + 2 * kh) * fw + 2 * kw : -1;
  }
  for (int v = tid; v < 8 * a.nvox; v += kThreads)
    fpos[v] = wgrad::pack(v / (fh * fw), (v / fw) % fh, v % fw);
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o0 + 8 * n + 2 * q + e;
      bv[n][e] = o < a.Cout ? a.bias[o] : 0.f;
    }
  __syncthreads();

  auto stage = [&](int step) {
    const int slot = step % a.slots, ch = step % a.kchunks;
    const Brick br = step_brick(a, step);
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);
    stage_input(a, reinterpret_cast<__nv_bfloat16*>(
                       smem + L.in + slot * L.in_slot),
                pos, a.mpad, br.b, br.d0, br.h0, br.w0, c0, cw);
    if (wring)
      stage_weights<false>(a, smem + L.w + slot * L.w_slot, c0, cw, o0);
  };
  if (!wring) stage_weights<false>(a, smem + L.w, 0, a.cpad, o0);
  stage(0);
  wgrad::cp_async_commit();

  Sums<MT, NT, FOLD> sum;
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) stage(step + 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();   // this step's rows have landed
    __syncthreads();
    const int slot = step % a.slots, ch = step % a.kchunks;
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);   // 16 k
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + L.in + slot * L.in_slot);
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(
        smem + L.w + (wring ? slot * L.w_slot : 0));
    const int wrow = wring ? tap * cw : tap * a.cpad;
    if (ch == 0) sum.start();
    for (int ks = 0; ks < (cw >> 4); ++ks) {
      uint32_t bf[NT][2];
      load_b<NT>(bf, ws, a.wstr, wrow + 16 * ks, lane);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (16 * j >= a.mpad) break;   // warp-uniform
        uint32_t af[4];
        wgrad::ldmatrix_x4(af, xs + (16 * j + a_row) * a.istr + 16 * ks + a_kh);
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(sum.acc[j][n], af, bf[n]);
      }
      sum.step();
    }
    if (ch == a.kchunks - 1) {
      sum.finish();
      // the C fragments (lane (g, q): rows g and g + 8 of each m16 tile,
      // columns 2q and 2q + 1 of each n8 tile) + bias into the fine brick
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * j + g + 8 * h;
          if (m >= a.mpad) break;
          const int f = mfine[m];
          if (f < 0) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<__nv_bfloat162*>(ys + (f + tapoff) * ystr +
                                               8 * n + 2 * q) =
                __floats2bfloat162_rn(
                    __fadd_rn(sum.acc[j][n][2 * h], bv[n][0]),
                    __fadd_rn(sum.acc[j][n][2 * h + 1], bv[n][1]));
        }
      __syncthreads();
      const Brick br = step_brick(a, step);
      const int Df = 2 * a.Dc, Hf = 2 * a.Hc, Wf = 2 * a.Wc;
      for (int i = tid; i < 8 * a.nvox * NT; i += kThreads) {
        const int v = NT == 1 ? i : i >> 1, u = i - v * NT;
        const int pp = fpos[v];
        const int vd = 2 * br.d0 + pd(pp), vh = 2 * br.h0 + ph(pp),
                  vw = 2 * br.w0 + pw(pp);
        const int o = o0 + 8 * u;
        if (vd >= Df || vh >= Hf || vw >= Wf || o >= a.Cout) continue;
        __nv_bfloat16* out =
            a.y + ((((int64_t)br.b * Df + vd) * Hf + vh) * Wf + vw) * a.Cout +
            o;
        const __nv_bfloat16* in = ys + v * ystr + 8 * u;
        if (a.yvec) {
          *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
        } else {
          for (int e = 0; e < 8 && o + e < a.Cout; ++e) out[e] = in[e];
        }
      }
    }
    __syncthreads();   // this step's slot and ys are free again
  }
}

// The brick geometry of K2 (both routes), once per block: each fine row's
// position and the 8 taps' fine-row offsets from a coarse voxel's 2i.
__device__ __forceinline__ void down_tables(const Args& a, int* pos,
                                            int* toff) {
  const int fh = 2 * a.th, fw = 2 * a.tw;
  for (int r = threadIdx.x; r < 8 * a.nvox; r += kThreads)
    pos[r] = wgrad::pack(r / (fh * fw), (r / fw) % fh, r % fw);
  if (threadIdx.x < 8) {
    const int tap = threadIdx.x;
    toff[tap] = ((tap >> 2) * fh + ((tap >> 1) & 1)) * fw + (tap & 1);
  }
}

// the fine row 2i of the brick's coarse voxel m
__device__ __forceinline__ int fine_row(const Args& a, int m) {
  return (2 * (m / (a.th * a.tw)) * 2 * a.th + 2 * ((m / a.tw) % a.th)) * 2 *
             a.tw + 2 * (m % a.tw);
}

// One coarse voxel's 8 outputs (+ bias, rounded once) in one 16-byte store.
__device__ __forceinline__ void down_store(const Args& a, const Brick& br,
                                           int m, int o, const float v[8],
                                           const float bias[8]) {
  const int vd = br.d0 + m / (a.th * a.tw), vh = br.h0 + (m / a.tw) % a.th,
            vw = br.w0 + m % a.tw;
  if (vd >= a.Dc || vh >= a.Hc || vw >= a.Wc || o >= a.Cout) return;
  __align__(16) __nv_bfloat16 ob[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16(__fadd_rn(v[e], bias[e]));
  __nv_bfloat16* out =
      a.y + ((((int64_t)br.b * a.Dc + vd) * a.Hc + vh) * a.Wc + vw) * a.Cout + o;
  if (a.yvec) {
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(ob);
  } else {
    for (int e = 0; e < 8 && o + e < a.Cout; ++e) out[e] = ob[e];
  }
}

// K2 without the prologue: block (bricks of blockIdx.x, channel chunk
// blockIdx.y); warp (wmi, wki) = (warp % wm, warp / wm) computes m16 tiles
// wmi + wm j (j < MT) of the brick over its share wki of each chunk's k16
// steps, NT n8 tiles. Each brick's warp partials meet in red, added in
// warp order.
template <int MT, int NT, bool FOLD>
__global__ void __launch_bounds__(kThreads) down_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 8 * NT;
  const bool wring = a.kchunks > 1;
  const Layout L = bridge_layout(false, false, a.nvox, a.mpad, a.kc, NC,
                                 a.wk, a.slots, wring);
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  float* red = reinterpret_cast<float*>(smem + L.out);
  const int nf = 8 * a.nvox;          // the brick's fine rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wmi = warp % a.wm, wki = warp / a.wm;
  const int o0 = blockIdx.y * NC;
  const int rstr = row_stride(NC);
  const int g = lane >> 2, q = lane & 3;
  const int nsteps = block_steps(a);

  down_tables(a, pos, toff);
  // this lane's fine row 2i of each of its m16 tiles' voxels (A: lanes
  // 0-15 rows 0-15, k 0-7; lanes 16-31 the same rows, k 8-15); padding rows
  // read row 0 and are never stored
  int arow[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = (wmi + a.wm * j) * 16 + (lane & 15);
    arow[j] = m < a.nvox ? fine_row(a, m) : 0;
  }
  const int a_kh = (lane >> 4) << 3;
  // the coarse voxel and channel group this thread stores (nvox NT <= 256)
  const int sm = NT == 1 ? tid : tid >> 1, su = tid - sm * NT;
  const int so = o0 + 8 * su;
  float sbias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sbias[e] = so + e < a.Cout ? a.bias[so + e] : 0.f;
  __syncthreads();

  auto stage = [&](int step) {
    const int slot = step % a.slots, ch = step % a.kchunks;
    const Brick br = step_brick(a, step);
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);
    stage_input(a, reinterpret_cast<__nv_bfloat16*>(
                       smem + L.in + slot * L.in_slot),
                pos, nf, br.b, 2 * br.d0, 2 * br.h0, 2 * br.w0, c0, cw);
    if (wring)
      stage_weights<false>(a, smem + L.w + slot * L.w_slot, c0, cw, o0);
  };
  if (!wring) stage_weights<false>(a, smem + L.w, 0, a.cpad, o0);
  stage(0);
  wgrad::cp_async_commit();

  Sums<MT, NT, FOLD> sum;
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) stage(step + 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();   // this step's rows have landed
    __syncthreads();
    const int slot = step % a.slots, ch = step % a.kchunks;
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);   // 8, or 16 k
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + L.in + slot * L.in_slot);
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(
        smem + L.w + (wring ? slot * L.w_slot : 0));
    if (ch == 0) sum.start();
    // this warp's k16 steps of the chunk's 8 cw / 16: k = tap * cw + c
    const int nks = cw >> 1, cwlg = log2_or_minus1(cw);
    const int k0 = nks * wki / a.wk, k1 = nks * (wki + 1) / a.wk;
    for (int ks = k0; ks < k1; ++ks) {
      uint32_t bf[NT][2];
      load_b<NT>(bf, ws, a.wstr, 16 * ks, lane);
      const int kk = 16 * ks + a_kh;
      const int tap = div_by(kk, cw, cwlg), c = kk - tap * cw;
      const int aoff = toff[tap] * a.istr + c;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if ((wmi + a.wm * j) * 16 >= a.mpad) break;   // warp-uniform
        uint32_t af[4];
        wgrad::ldmatrix_x4(af, xs + arow[j] * a.istr + aoff);
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(sum.acc[j][n], af, bf[n]);
      }
      sum.step();
    }
    if (ch == a.kchunks - 1) {
      sum.finish();
      // each warp's [m16, nc] partials into red[wki]
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int t = wmi + a.wm * j;
        if (16 * t >= a.mpad) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* row = red + (wki * a.mpad + 16 * t + g + 8 * h) * rstr;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<float2*>(row + 8 * n + 2 * q) =
                make_float2(sum.acc[j][n][2 * h], sum.acc[j][n][2 * h + 1]);
        }
      }
      __syncthreads();
      if (sm < a.nvox) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
        for (int p = 0; p < a.wk; ++p) {
          const float* row = red + (p * a.mpad + sm) * rstr + 8 * su;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], row[e]);
        }
        down_store(a, step_brick(a, step), sm, so, v, sbias);
      }
    }
    __syncthreads();   // this step's slot and red are free again
  }
}

// K2 with the prologue, on the CUDA cores: block (bricks of blockIdx.x,
// channel chunk blockIdx.y); thread (m, u) = the brick's coarse voxel m and
// output channels o0 + 8u .. + 7 (nvox NT <= 256), its 8 sums f32 FMAs in
// (chunk, tap, channel) order.
template <int NT>
__global__ void __launch_bounds__(kThreads) down_pre_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 8 * NT;
  const bool wring = a.kchunks > 1;
  const Layout L = bridge_layout(false, true, a.nvox, a.mpad, a.kc, NC, 1,
                                 a.slots, wring);
  int* pos = reinterpret_cast<int*>(smem + L.pos);
  int* toff = reinterpret_cast<int*>(smem + L.toff);
  const int nf = 8 * a.nvox;
  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * NC;
  const int nsteps = block_steps(a);

  down_tables(a, pos, toff);
  const int sm = NT == 1 ? tid : tid >> 1, su = tid - sm * NT;
  const int so = o0 + 8 * su;
  const int frow = sm < a.nvox ? fine_row(a, sm) : 0;
  float sbias[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sbias[e] = so + e < a.Cout ? a.bias[so + e] : 0.f;
  __syncthreads();

  auto stage = [&](int step) {
    const int slot = step % a.slots, ch = step % a.kchunks;
    const Brick br = step_brick(a, step);
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);
    unsigned char* base = smem + L.in + slot * L.in_slot;
    stage_input(a, reinterpret_cast<__nv_bfloat16*>(base), pos, nf, br.b,
                2 * br.d0, 2 * br.h0, 2 * br.w0, c0, cw);
    // the prologue's (s, t) of this brick's batch entry and chunk (0 past
    // Cin, where the staged x is 0 too: xn = 0)
    float* st = reinterpret_cast<float*>(base + L.st);
    for (int i = tid; i < 2 * cw; i += kThreads) {
      const int c = c0 + (i < cw ? i : i - cw);
      st[i] = c < a.Cin ? (i < cw ? a.s : a.t)[br.b * a.Cin + c] : 0.f;
    }
    if (wring) stage_weights<true>(a, smem + L.w + slot * L.w_slot, c0, cw, o0);
  };
  if (!wring) stage_weights<true>(a, smem + L.w, 0, a.cpad, o0);
  stage(0);
  wgrad::cp_async_commit();

  float v[8];
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) stage(step + 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();   // this step's rows have landed
    __syncthreads();
    const int slot = step % a.slots, ch = step % a.kchunks;
    const int c0 = ch * a.kc, cw = min(a.kc, a.cpad - c0);
    const unsigned char* base = smem + L.in + slot * L.in_slot;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const float* st = reinterpret_cast<const float*>(base + L.st);
    const float* ws = reinterpret_cast<const float*>(
        smem + L.w + (wring ? slot * L.w_slot : 0));
    if (ch == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    if (sm < a.nvox) {
      for (int tap = 0; tap < 8; ++tap) {
        const __nv_bfloat16* xr = xs + (frow + toff[tap]) * a.istr;
        for (int c8 = 0; c8 < cw; c8 += 8) {
          __align__(16) __nv_bfloat16 xv[8];
          *reinterpret_cast<uint4*>(xv) =
              *reinterpret_cast<const uint4*>(xr + c8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xn = fmaxf(pre_activation(__bfloat162float(xv[j]),
                                                  st[c8 + j], st[cw + c8 + j]),
                                   0.f);
            const float4* wr = reinterpret_cast<const float4*>(
                ws + (tap * cw + c8 + j) * NC + 8 * su);
            const float4 w0 = wr[0], w1 = wr[1];
            v[0] = fmaf(xn, w0.x, v[0]); v[1] = fmaf(xn, w0.y, v[1]);
            v[2] = fmaf(xn, w0.z, v[2]); v[3] = fmaf(xn, w0.w, v[3]);
            v[4] = fmaf(xn, w1.x, v[4]); v[5] = fmaf(xn, w1.y, v[5]);
            v[6] = fmaf(xn, w1.z, v[6]); v[7] = fmaf(xn, w1.w, v[7]);
          }
        }
      }
      if (ch == a.kchunks - 1) down_store(a, step_brick(a, step), sm, so, v, sbias);
    }
    __syncthreads();   // this step's slot is free again
  }
}

template <typename K>
cudaError_t launch(K kernel, bool& sized, const Args& a, int smem,
                   cudaStream_t stream) {
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((unsigned)((a.ntiles + a.tpb - 1) / a.tpb),
                  (unsigned)((a.Cout + a.nc - 1) / a.nc), 1);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MT, int NT, bool FOLD>
cudaError_t launch_up(const Args& a, int smem, cudaStream_t st) {
  static bool sized = false;
  return launch(up_kernel<MT, NT, FOLD>, sized, a, smem, st);
}

template <int MT, int NT, bool FOLD>
cudaError_t launch_down(const Args& a, int smem, cudaStream_t st) {
  static bool sized = false;
  return launch(down_kernel<MT, NT, FOLD>, sized, a, smem, st);
}

template <int NT>
cudaError_t launch_down_pre(const Args& a, int smem, cudaStream_t st) {
  static bool sized = false;
  return launch(down_pre_kernel<NT>, sized, a, smem, st);
}

template <int NT, bool FOLD>
cudaError_t dispatch_up(const Args& a, int smem, cudaStream_t st) {
  switch (a.mt) {
    case 1: return launch_up<1, NT, FOLD>(a, smem, st);
    case 2: return launch_up<2, NT, FOLD>(a, smem, st);
    case 4: return launch_up<4, NT, FOLD>(a, smem, st);
    case 8:
      if constexpr (NT == 1) return launch_up<8, 1, FOLD>(a, smem, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int NT, bool FOLD>
cudaError_t dispatch_down(const Args& a, int smem, cudaStream_t st) {
  switch (a.mt) {
    case 1: return launch_down<1, NT, FOLD>(a, smem, st);
    case 2: return launch_down<2, NT, FOLD>(a, smem, st);
    case 4: return launch_down<4, NT, FOLD>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3 (up != 0): x [B, D, H, W, Cin] -> y [B, 2D, 2H, 2W, Cout]; K2: x ->
// y [B, D/2, H/2, W/2, Cout] with (s, t) [B, Cin] f32 the prologue or null
// (K2 only). wk [8, Cin, Cout] bf16, bias [Cout] f32, `plan` the int32
// fields of ops/bridges.py::bridge_plan. Returns the first launch error (0
// on success), or cudaErrorInvalidValue for arguments or a plan this file
// does not compute.
int vaeseg_bridge(int up, const void* x, const void* w, const void* bias,
                  const void* s, const void* t, void* y, int B, int D, int H,
                  int W, int Cin, int Cout, const void* plan, void* stream) {
  const int* p = static_cast<const int*>(plan);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.Dc = up ? D : D / 2; a.Hc = up ? H : H / 2; a.Wc = up ? W : W / 2;
  a.td = p[kPlanTd]; a.th = p[kPlanTh]; a.tw = p[kPlanTw];
  a.tiles_d = p[kPlanTilesD]; a.tiles_h = p[kPlanTilesH];
  a.tiles_w = p[kPlanTilesW];
  a.nc = p[kPlanNc]; a.mt = p[kPlanMt]; a.wm = p[kPlanWm]; a.wk = p[kPlanWk];
  a.kc = p[kPlanKc]; a.tpb = p[kPlanTpb];
  a.nvox = a.td * a.th * a.tw;
  a.mpad = (a.nvox + 15) / 16 * 16;
  a.cpad = (!up && Cin <= 8) ? 8 : (Cin + 15) / 16 * 16;
  const int64_t tiles = (int64_t)B * a.tiles_d * a.tiles_h * a.tiles_w;
  a.ntiles = (int)(tiles < 0x7fffffff ? tiles : 0x7fffffff);
  a.kchunks = a.kc > 0 ? (a.cpad + a.kc - 1) / a.kc : 0;
  a.slots = (int64_t)a.tpb * a.kchunks > 1 ? 2 : 1;
  a.istr = row_stride(a.kc);
  a.wstr = row_stride(a.nc);
  a.xvec = (Cin & 7) == 0 && aligned16(x);
  a.wvec = (Cout & 7) == 0 && aligned16(w);
  a.yvec = (Cout & 7) == 0 && aligned16(y);
  const bool pre = s != nullptr;
  const Layout L = bridge_layout(up != 0, pre, a.nvox, a.mpad, a.kc, a.nc,
                                 a.wk, a.slots, a.kchunks > 1);
  // k16 steps a warp chains: up, all of K; down, its share of each chunk
  const int chain = up ? a.cpad / 16
                       : a.kchunks * ((a.kc / 2 + a.wk - 1) / (a.wk > 0 ? a.wk : 1));
  const bool fold = chain > kFold;
  const bool bad =
      B <= 0 || a.Dc <= 0 || a.Hc <= 0 || a.Wc <= 0 || Cin <= 0 ||
      Cout <= 0 || x == nullptr || w == nullptr || bias == nullptr ||
      y == nullptr || (s == nullptr) != (t == nullptr) || (up && pre) ||
      a.td <= 0 || a.th <= 0 || a.tw <= 0 || a.tiles_d * a.td < a.Dc ||
      a.tiles_h * a.th < a.Hc || a.tiles_w * a.tw < a.Wc ||
      (a.tiles_d - 1) * a.td >= a.Dc || (a.tiles_h - 1) * a.th >= a.Hc ||
      (a.tiles_w - 1) * a.tw >= a.Wc || (a.nc != 8 && a.nc != 16) ||
      a.wm <= 0 || a.wk <= 0 || a.wm * a.wk != (up ? 1 : kWarps) ||
      a.mt * 16 * a.wm < a.mpad || (up && a.mt * a.nc > 64) ||
      a.kc <= 0 || a.kc > a.cpad ||
      (a.cpad == 8 ? a.kc != 8 : a.kc % 16 != 0) || a.tpb <= 0 ||
      2 * a.td > 1023 || 2 * a.th > 1023 || 2 * a.tw > 1023 ||
      (!up && a.nvox * (a.nc >> 3) > kThreads) ||
      tiles >= 0x7fffffff || (Cout + a.nc - 1) / a.nc > 65535 ||
      L.bytes > 227 * 1024;
  if (bad) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up) {
    if (a.nc == 8)
      return fold ? dispatch_up<1, true>(a, L.bytes, st)
                  : dispatch_up<1, false>(a, L.bytes, st);
    return fold ? dispatch_up<2, true>(a, L.bytes, st)
                : dispatch_up<2, false>(a, L.bytes, st);
  }
  if (pre) {
    return a.nc == 8 ? launch_down_pre<1>(a, L.bytes, st)
                     : launch_down_pre<2>(a, L.bytes, st);
  }
  if (a.nc == 8)
    return fold ? dispatch_down<1, true>(a, L.bytes, st)
                : dispatch_down<1, false>(a, L.bytes, st);
  return fold ? dispatch_down<2, true>(a, L.bytes, st)
              : dispatch_down<2, false>(a, L.bytes, st);
}

}  // extern "C"
