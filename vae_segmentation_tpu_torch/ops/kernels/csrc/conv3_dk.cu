// conv3_dk: the weight and bias gradient of K1 (the channels-last 3^3 SAME
// stride-1 conv) for Hopper (sm_90a).
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/stencil3.py
//   _run_dk_grouped (grouped taps on the s2d-folded rep) and _run_dk (27
//   dense taps), with and without the norm+ReLU prologue. The port computes
//   in the logical representation, so one kernel covers both.
//
//   dk[tap, c, o] = sum_{b, d, h, w} xn[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                    * gy[b, d, h, w, o]      (f32)
//   db[o]         = sum_{b, d, h, w} gy[b, d, h, w, o]          (f32)
//   xn = relu(x * s[b, c] + t[b, c]) with the prologue, else x; an
//   out-of-volume tap contributes 0 (SAME pads the normalized tensor), and
//   x * s + t is rounded as in K1's forward (common.cuh).
//
// What bounds it on the H100: it does the forward's 27 Cin Cout MACs per
// voxel, so the bytes bound it at the 128^3/64^3 stages (C = 1..16) and the
// operations at the deep ones. The TPU kernel carried its [taps, Cin, Cout]
// sum in VMEM across a sequential grid; here blocks run in parallel, so the
// reduction is in three levels. A block stages a (td+2)(th+2)(tw+2) x CIT
// halo of xn and a td*th*tw x COT tile of gy in shared memory; thread
// (tap, slice) keeps a CIT x COT partial in registers over every eighth
// voxel of the tile and over all tiles the block walks (a grid-stride loop:
// a block visits many tiles, so it adds to device memory once, not once a
// tile); the eight slices meet in shared memory, and one atomicAdd per
// (tap, c, o) and block reaches dk, so the grid is kept to two blocks per
// SM. The order of those atomics varies from run to run.
//
// Precision: the weight gradient of a conv under an InstanceNorm cancels
// (the norm's backward leaves gy orthogonal to constants), and db is zero
// in exact arithmetic there, so the sums end orders of magnitude below
// their terms. dk and db accumulate across blocks in f64 (the wrapper
// rounds them to f32 once at the end), and the threads that sum db do so in
// f64 throughout: it costs them nothing beside the dk work. A second
// register set per thread (a tile's chain, then the block's tiles) made dk
// exact to 2e-6 but cost the 8 x 8 variant its second block per SM and
// the step 40% more time in this kernel, so dk's register chains stay f32.
// This first version runs on the CUDA cores in f32; wgmma tiles are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSlices = 8;                 // voxel slices per tap
constexpr int kWorkers = 27 * kSlices;     // threads that accumulate dk
constexpr int kThreads = 256;              // the other 40 sum db

struct DkArgs {
  const __nv_bfloat16* x;   // [B, D, H, W, Cin]
  const __nv_bfloat16* gy;  // [B, D, H, W, Cout]
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  double* dk;               // [27, Cin, Cout], zeroed by the caller
  double* db;               // [Cout], zeroed by the caller
  int B, D, H, W, Cin, Cout;
  int td, th, tw;           // spatial tile
  int tiles_d, tiles_h, tiles_w;
  int co_chunks;            // ceil(Cout / COT)
};

template <int CIT, int COT>
__global__ void __launch_bounds__(kThreads) conv3_dk_kernel(const DkArgs a) {
  extern __shared__ float smem[];
  const int hh = a.th + 2, hw = a.tw + 2;
  const int halo = (a.td + 2) * hh * hw;
  const int nvox = a.td * a.th * a.tw;
  float* sx = smem;                 // [halo][CIT]
  float* sg = sx + halo * CIT;      // [nvox][COT]
  float* sred = sg + nvox * COT;    // [27][CIT][COT]
  // the tile's geometry is the same for every tile a block walks: each halo
  // position's and each voxel's (d, h, w) is worked out once and kept packed
  // 10 bits a coordinate, so that no loop below divides by a runtime extent
  int* hpos = reinterpret_cast<int*>(sred + 27 * CIT * COT);  // [halo]
  int* vpos = hpos + halo;                                    // [nvox]

  const int tid = threadIdx.x;
  const int ci0 = (blockIdx.y / a.co_chunks) * CIT;
  const int co0 = (blockIdx.y % a.co_chunks) * COT;
  const int tap = tid % 27, slice = tid / 27;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  // the threads past the workers sum db: thread (part, channel) takes every
  // kBiasParts-th voxel of a tile, and adds a tile's sum to its total as one
  // term (short chains: db often cancels to far below its terms)
  constexpr int kBiasParts = (kThreads - kWorkers) / COT;
  const int bias_c = (tid - kWorkers) % COT, bias_part = (tid - kWorkers) / COT;
  const bool sums_bias = ci0 == 0 && tid >= kWorkers && bias_part < kBiasParts;

  float acc[CIT * COT];
#pragma unroll
  for (int i = 0; i < CIT * COT; ++i) acc[i] = 0.f;
  double bsum = 0.0;

  for (int p = tid; p < halo; p += kThreads)
    hpos[p] = ((p / (hw * hh)) << 20) | (((p / hw) % hh) << 10) | (p % hw);
  for (int v = tid; v < nvox; v += kThreads)
    vpos[v] = ((v / (a.tw * a.th)) << 20) | (((v / a.tw) % a.th) << 10) | (v % a.tw);
  const int tap_off = (kd * hh + kh) * hw + kw;
  __syncthreads();

  const int tiles_per_b = a.tiles_d * a.tiles_h * a.tiles_w;
  const int ntiles = a.B * tiles_per_b;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int r = tile;
    const int w0 = (r % a.tiles_w) * a.tw; r /= a.tiles_w;
    const int h0 = (r % a.tiles_h) * a.th; r /= a.tiles_h;
    const int d0 = (r % a.tiles_d) * a.td;
    const int b = r / a.tiles_d;

    for (int i = tid; i < halo * CIT; i += kThreads) {
      const int ci = i % CIT;
      const int pp = hpos[i / CIT];
      const int gw = w0 + (pp & 1023) - 1, gh = h0 + ((pp >> 10) & 1023) - 1;
      const int gd = d0 + (pp >> 20) - 1;
      float v = 0.f;
      if (ci0 + ci < a.Cin && gd >= 0 && gd < a.D && gh >= 0 && gh < a.H &&
          gw >= 0 && gw < a.W) {
        v = __bfloat162float(
            a.x[((((int64_t)b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin + ci0 + ci]);
        if (a.s != nullptr) {
          const int sc = b * a.Cin + ci0 + ci;
          v = fmaxf(pre_activation(v, a.s[sc], a.t[sc]), 0.f);
        }
      }
      sx[i] = v;
    }
    for (int i = tid; i < nvox * COT; i += kThreads) {
      const int co = i % COT;
      const int vp = vpos[i / COT];
      const int ow = w0 + (vp & 1023), oh = h0 + ((vp >> 10) & 1023);
      const int od = d0 + (vp >> 20);
      float g = 0.f;
      if (co0 + co < a.Cout && od < a.D && oh < a.H && ow < a.W)
        g = __bfloat162float(
            a.gy[((((int64_t)b * a.D + od) * a.H + oh) * a.W + ow) * a.Cout + co0 + co]);
      sg[i] = g;
    }
    __syncthreads();
    if (slice < kSlices) {
      for (int v = slice; v < nvox; v += kSlices) {
        const int vp = vpos[v];
        const float* xp =
            sx + (((vp >> 20) * hh + ((vp >> 10) & 1023)) * hw + (vp & 1023) + tap_off) * CIT;
        const float* gp = sg + v * COT;
        float gv[COT];
#pragma unroll
        for (int co = 0; co < COT; ++co) gv[co] = gp[co];
#pragma unroll
        for (int ci = 0; ci < CIT; ++ci) {
          const float xv = xp[ci];
#pragma unroll
          for (int co = 0; co < COT; ++co)
            acc[ci * COT + co] = fmaf(xv, gv[co], acc[ci * COT + co]);
        }
      }
    } else if (sums_bias) {
      double part = 0.0;
      for (int v = bias_part; v < nvox; v += kBiasParts) part += sg[v * COT + bias_c];
      bsum += part;
    }
    __syncthreads();
  }

  for (int i = tid; i < 27 * CIT * COT; i += kThreads) sred[i] = 0.f;
  __syncthreads();
  if (slice < kSlices) {
#pragma unroll
    for (int i = 0; i < CIT * COT; ++i) atomicAdd(&sred[tap * CIT * COT + i], acc[i]);
  }
  __syncthreads();
  for (int i = tid; i < 27 * CIT * COT; i += kThreads) {
    const int co = i % COT, ci = (i / COT) % CIT, tp = i / (COT * CIT);
    if (ci0 + ci < a.Cin && co0 + co < a.Cout)
      atomicAdd(&a.dk[((int64_t)tp * a.Cin + ci0 + ci) * a.Cout + co0 + co],
                static_cast<double>(sred[i]));
  }
  if (sums_bias && co0 + bias_c < a.Cout) atomicAdd(&a.db[co0 + bias_c], bsum);
}

int pow2_tile(int c) { return c >= 8 ? 8 : c >= 4 ? 4 : c >= 2 ? 2 : 1; }

template <int CIT, int COT>
cudaError_t launch(DkArgs a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int ci_chunks = (a.Cin + CIT - 1) / CIT;
  a.co_chunks = (a.Cout + COT - 1) / COT;
  const long chunks = (long)ci_chunks * a.co_chunks;
  const long ntiles = (long)a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  if (chunks > 65535 || ntiles > 0x7fffffffL) return cudaErrorInvalidValue;
  // two blocks per SM: every block ends with 27 CIT COT global atomics
  // whatever it walked, so more blocks only add atomics (with 16 per SM the
  // atomics took half to two thirds of the time at every stage on an H100)
  long gx = (2L * sms + chunks - 1) / chunks;
  if (gx > ntiles) gx = ntiles;
  // (+ 1: a halo position's and a voxel's packed coordinates)
  const size_t smem =
      sizeof(float) * ((size_t)(a.td + 2) * (a.th + 2) * (a.tw + 2) * (CIT + 1) +
                       (size_t)a.td * a.th * a.tw * (COT + 1) + (size_t)27 * CIT * COT);
  if (smem > 48 * 1024 || a.td + 2 > 1023) return cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)chunks, 1);
  conv3_dk_kernel<CIT, COT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CIT>
cudaError_t dispatch_cot(const DkArgs& a, int cot, cudaStream_t st) {
  switch (cot) {
    case 8: return launch<CIT, 8>(a, st);
    case 4: return launch<CIT, 4>(a, st);
    case 2: return launch<CIT, 2>(a, st);
    default: return launch<CIT, 1>(a, st);
  }
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dk [27, Cin, Cout] and db [Cout] are f64 and must arrive zeroed; s/t may
// be null.
// Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_conv3_dk(const void* x, const void* gy, const void* s, const void* t,
                    void* dk, void* db, int B, int D, int H, int W, int Cin,
                    int Cout, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  DkArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.dk = static_cast<double*>(dk);
  a.db = static_cast<double*>(db);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.tw = W < 16 ? W : 16;
  a.th = H < 8 ? H : 8;
  int td = 256 / (a.tw * a.th);
  a.td = D < td ? D : td;
  a.tiles_d = (D + a.td - 1) / a.td;
  a.tiles_h = (H + a.th - 1) / a.th;
  a.tiles_w = (W + a.tw - 1) / a.tw;
  a.co_chunks = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cot = pow2_tile(Cout);
  switch (pow2_tile(Cin)) {
    case 8: return dispatch_cot<8>(a, cot, st);
    case 4: return dispatch_cot<4>(a, cot, st);
    case 2: return dispatch_cot<2>(a, cot, st);
    default: return dispatch_cot<1>(a, cot, st);
  }
}

}  // extern "C"
