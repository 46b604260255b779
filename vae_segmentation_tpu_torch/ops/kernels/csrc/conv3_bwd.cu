// conv3_bwd: the merged backward of K1 (the channels-last 3^3 SAME stride-1
// conv) for Hopper (sm_90a): dx, dk and db (and the prologue's (ds, dt)) in
// one launch that reads each tile of x and gy once, where the default
// backward runs K1 as the dx conv and then conv3_dk.
//
// Replaces (TPU, Pallas): vae_segmentation_tpu/ops/pallas/stencil3.py
//   _run_bwd_grouped (the merged grouped-tap backward, _bwd_kernel_grouped,
//   taken under VAESEG_MERGED_BWD=1), with and without the prologue. The port
//   computes in the logical representation, so the grouped taps are 27
//   dense taps here.
//
//   dx[b, v, c]  = sum_{tap, o} gy[b, v - tap + 1, o] * wk[tap, c, o]
//                  (K1 on the flipped, transposed weight), and with the
//                  prologue relu(x * s + t) its backward, as K1's `post`
//                  epilogue: gm = dx where x * s + t > 0 else 0, dx = gm * s,
//                  dst[b, 0, c] += sum gm * x, dst[b, 1, c] += sum gm;
//   dk[tap, c, o] = sum_{b, v} xn[b, v + tap - 1, c] * gy[b, v, o],
//   db[o]         = sum_{b, v} gy[b, v, o],
//   xn = relu(x * s + t) with the prologue, else x; out-of-volume taps are 0,
//   and x * s + t is rounded as in every kernel of the port (common.cuh).
//
// Design. A block owns a chunk of CIT input channels (dx's output channels,
// dk's rows) and walks spatial tiles (a grid-stride loop, as conv3_dk). For
// each tile it stages the x halo of its channels once, through the
// prologue, then for each chunk of COT output channels the gy halo and the
// flipped weight slice: every thread accumulates its voxel's CIT dx values
// in registers (K1's dx body), and thread (tap, slice) the tile's CIT x COT
// dk partial over every eighth voxel against the halo's centre (conv3_dk's
// body). A tap's eight slices sit in one warp and add their partials with
// shuffles; each element of the block's f32 dk in shared memory then has
// one owner lane, so no atomics are needed there (shared-memory float
// atomics, contended by eight warps, made the first version 6.7x slower
// than the pair on an H100). The last warp sums db in f64 the same way.
// After the last chunk the dx epilogue runs as in K1. At the end every
// block adds its dk (and, for the first channel chunk, db) to the f64
// outputs with one atomicAdd per element (the wrapper rounds them to f32
// once), so the order of those atomics varies from run to run.
//
// What bounds it on the H100: the work is the two backward convs' (54 Cin
// Cout MACs a voxel), so the bytes bound it at the 128^3/64^3 stages (C =
// 8..16) and the operations at the deep ones. Merging saves one read of x
// and gy at the cost of a larger working set: both halos and the block's dk
// in shared memory (up to ~120 KB at CIT = 8), so fewer blocks fit an SM
// than with the pair (the TPU measured the same trade: its doubled DMA
// working set broke double-buffering). This first version runs on the CUDA
// cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 8;              // voxel slices per tap (dk), one warp
constexpr int kWorkers = 27 * kSlices;  // threads that accumulate dk
constexpr int kDkWarps = (kWorkers + 31) / 32;  // warp 7 sums db
constexpr int kMaxHalo = 1024;          // halo positions a tile may stage
constexpr size_t kMaxDkSmem = 64 * 1024;

struct BwdArgs {
  const __nv_bfloat16* x;   // [B, D, H, W, Cin], the forward's input
  const __nv_bfloat16* gy;  // [B, D, H, W, Cout]
  const __nv_bfloat16* w;   // [27, Cin, Cout], the forward's kernel layout
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  __nv_bfloat16* dx;        // [B, D, H, W, Cin]
  float* dst;               // [B, 2, Cin] (ds, dt), zeroed, with the prologue
  double* dk;               // [27, Cin, Cout], zeroed by the caller
  double* db;               // [Cout], zeroed by the caller
  int B, D, H, W, Cin, Cout;
  int td, th, tw;           // spatial tile (at most kThreads voxels)
  int tiles_d, tiles_h, tiles_w;
};

// odd row strides: neighbouring voxels hit different banks
__host__ __device__ constexpr int padded(int c) { return c % 2 == 0 ? c + 1 : c; }

template <int CIT, int COT>
size_t smem_bytes(const BwdArgs& a) {
  const size_t halo = (size_t)(a.td + 2) * (a.th + 2) * (a.tw + 2);
  return sizeof(double) * a.Cout + sizeof(float) * ((size_t)27 * CIT * a.Cout +
         halo * (padded(CIT) + padded(COT)) + 27 * COT * CIT + 2 * CIT);
}

// Stages channels [c0, c0 + N) of a [B, D, H, W, C] bf16 volume around the
// tile at (b, d0, h0, w0) into `dst`, one row of `stride` floats a halo
// position: zero outside the volume and past C; with (s, t) through
// relu(x * s + t). Eight channels go as one 16-byte load where C allows.
template <int N>
__device__ __forceinline__ void stage_halo(const __nv_bfloat16* src, int C, int c0,
                                           const float* s, const float* t,
                                           float* dst, int stride, const BwdArgs& a,
                                           int b, int d0, int h0, int w0) {
  const int hh = a.th + 2, hw = a.tw + 2;
  const int halo = (a.td + 2) * hh * hw;
  const bool vec = N == 8 && C % 8 == 0;
  const int per = vec ? 1 : N;
  for (int i = threadIdx.x; i < halo * per; i += kThreads) {
    const int p = i / per, c = i % per;
    const int gw = w0 + p % hw - 1, gh = h0 + (p / hw) % hh - 1;
    const int gd = d0 + p / (hw * hh) - 1;
    const bool in = gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    const int64_t row = ((((int64_t)b * a.D + gd) * a.H + gh) * a.W + gw) * C + c0;
    if (vec) {
      float v[8];
      if (in) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + row);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h2[k]);
          v[2 * k] = f.x;
          v[2 * k + 1] = f.y;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float val = 0.f;
        if (in) {
          val = v[k];
          if (s != nullptr)
            val = fmaxf(pre_activation(val, s[b * C + c0 + k], t[b * C + c0 + k]), 0.f);
        }
        dst[p * stride + k] = val;
      }
    } else {
      float val = 0.f;
      if (in && c0 + c < C) {
        val = __bfloat162float(src[row + c]);
        if (s != nullptr)
          val = fmaxf(pre_activation(val, s[b * C + c0 + c], t[b * C + c0 + c]), 0.f);
      }
      dst[p * stride + c] = val;
    }
  }
}

template <int CIT, int COT>
__global__ void __launch_bounds__(kThreads, 2) conv3_bwd_kernel(const BwdArgs a) {
  extern __shared__ double smem_d[];
  constexpr int XS = padded(CIT), GS = padded(COT);
  const int hh = a.th + 2, hw = a.tw + 2;
  const int halo = (a.td + 2) * hh * hw;
  const int nvox = a.td * a.th * a.tw;
  double* sdb = smem_d;                                   // [Cout]
  float* sdk = reinterpret_cast<float*>(sdb + a.Cout);    // [27][CIT][Cout]
  float* sx = sdk + 27 * CIT * a.Cout;                    // [halo][XS]
  float* sg = sx + halo * XS;                             // [halo][GS]
  float* sw = sg + halo * GS;                             // [27][COT][CIT]
  float* red = sw + 27 * COT * CIT;                       // [2][CIT]

  const int tid = threadIdx.x;
  const int ci0 = blockIdx.y * CIT;
  // dx: one voxel per thread
  const int lw = tid % a.tw, lh = (tid / a.tw) % a.th, ld = tid / (a.tw * a.th);
  const bool has_vox = tid < nvox;
  const int centre = ((ld + 1) * hh + lh + 1) * hw + lw + 1;
  // dk: thread (tap, slice), the slices of a tap in one warp (the warp's
  // lanes past the 216 workers take part in its shuffles with zeros); the
  // last warp sums db: lane (part, channel)
  const int tap = tid / kSlices, slice = tid % kSlices;
  const bool dk_warp = tid < 32 * kDkWarps;
  const bool dk_lane = tid < kWorkers;
  const int tap_off = ((tap / 9) * hh + (tap / 3) % 3) * hw + tap % 3;
  constexpr int kBiasParts = 32 / COT;
  const int lane = tid % 32;
  const int bias_c = lane % COT, bias_part = lane / COT;
  const bool sums_bias = blockIdx.y == 0 && !dk_warp;

  for (int i = tid; i < 27 * CIT * a.Cout; i += kThreads) sdk[i] = 0.f;
  for (int i = tid; i < a.Cout; i += kThreads) sdb[i] = 0.0;

  const int ntiles = a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int r = tile;
    const int w0 = (r % a.tiles_w) * a.tw; r /= a.tiles_w;
    const int h0 = (r % a.tiles_h) * a.th; r /= a.tiles_h;
    const int d0 = (r % a.tiles_d) * a.td;
    const int b = r / a.tiles_d;
    __syncthreads();  // the previous tile is done with sx, sg, sw and red
    stage_halo<CIT>(a.x, a.Cin, ci0, a.s, a.t, sx, XS, a, b, d0, h0, w0);
    if (tid < 2 * CIT) red[tid] = 0.f;

    float acc[CIT];
#pragma unroll
    for (int ci = 0; ci < CIT; ++ci) acc[ci] = 0.f;
    for (int c0 = 0; c0 < a.Cout; c0 += COT) {
      stage_halo<COT>(a.gy, a.Cout, c0, nullptr, nullptr, sg, GS, a, b, d0, h0, w0);
      // the dx conv's weight: the forward's taps flipped, Cin and Cout swapped
      for (int i = tid; i < 27 * COT * CIT; i += kThreads) {
        const int ci = i % CIT, co = (i / CIT) % COT, tp = i / (CIT * COT);
        sw[i] = (ci0 + ci < a.Cin && c0 + co < a.Cout)
                    ? __bfloat162float(
                          a.w[((int64_t)(26 - tp) * a.Cin + ci0 + ci) * a.Cout + c0 + co])
                    : 0.f;
      }
      __syncthreads();
      if (has_vox) {
        for (int kd = 0; kd < 3; ++kd) {
          for (int kh = 0; kh < 3; ++kh) {
            for (int kw = 0; kw < 3; ++kw) {
              const float* gp = sg + (((ld + kd) * hh + lh + kh) * hw + lw + kw) * GS;
              const float* wp = sw + ((kd * 3 + kh) * 3 + kw) * COT * CIT;
#pragma unroll
              for (int co = 0; co < COT; ++co) {
                const float gv = gp[co];
#pragma unroll
                for (int ci = 0; ci < CIT; ++ci) acc[ci] = fmaf(gv, wp[co * CIT + ci], acc[ci]);
              }
            }
          }
        }
      }
      if (dk_warp) {
        float part[CIT * COT];
#pragma unroll
        for (int i = 0; i < CIT * COT; ++i) part[i] = 0.f;
        for (int v = slice; dk_lane && v < nvox; v += kSlices) {
          const int vw = v % a.tw, vh = (v / a.tw) % a.th, vd = v / (a.tw * a.th);
          const int pos = (vd * hh + vh) * hw + vw;
          const float* xp = sx + (pos + tap_off) * XS;
          const float* gp = sg + (pos + (hh + 1) * hw + 1) * GS;  // the centre
          float gv[COT];
#pragma unroll
          for (int co = 0; co < COT; ++co) gv[co] = gp[co];
#pragma unroll
          for (int ci = 0; ci < CIT; ++ci) {
            const float xv = xp[ci];
#pragma unroll
            for (int co = 0; co < COT; ++co)
              part[ci * COT + co] = fmaf(xv, gv[co], part[ci * COT + co]);
          }
        }
        // the tap's eight slices meet in registers; lane `slice` then owns
        // the elements i = slice (mod 8) of the tap's partial
#pragma unroll
        for (int i = 0; i < CIT * COT; ++i) {
#pragma unroll
          for (int off = 1; off < kSlices; off <<= 1)
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
        }
        if (dk_lane) {
#pragma unroll
          for (int i = 0; i < CIT * COT; ++i) {
            const int co = i % COT;
            if (i % kSlices == slice && c0 + co < a.Cout)
              sdk[(tap * CIT + i / COT) * a.Cout + c0 + co] += part[i];
          }
        }
      } else if (sums_bias) {
        double part = 0.0;
        for (int v = bias_part; v < nvox; v += kBiasParts) {
          const int vw = v % a.tw, vh = (v / a.tw) % a.th, vd = v / (a.tw * a.th);
          part += sg[(((vd + 1) * hh + vh + 1) * hw + vw + 1) * GS + bias_c];
        }
        for (int off = COT; off < 32; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (bias_part == 0 && c0 + bias_c < a.Cout) sdb[c0 + bias_c] += part;
      }
      __syncthreads();
    }

    // the dx epilogue: K1's, with the prologue's backward (`post`)
    const int od = d0 + ld, oh = h0 + lh, ow = w0 + lw;
    const bool valid = has_vox && od < a.D && oh < a.H && ow < a.W;
    const int64_t vox = (((int64_t)b * a.D + od) * a.H + oh) * a.W + ow;
    float ds[CIT], dt[CIT];
    if (a.s != nullptr) {
#pragma unroll
      for (int ci = 0; ci < CIT; ++ci) {
        const bool in = valid && ci0 + ci < a.Cin;
        const float xv = in ? __bfloat162float(a.x[vox * a.Cin + ci0 + ci]) : 0.f;
        // the staged relu(x * s + t) is positive exactly where x * s + t is
        const float gm = (in && sx[centre * XS + ci] > 0.f) ? acc[ci] : 0.f;
        acc[ci] = in ? gm * a.s[b * a.Cin + ci0 + ci] : 0.f;
        ds[ci] = gm * xv;
        dt[ci] = gm;
      }
    }
    if (valid) {
      __nv_bfloat16* dp = a.dx + vox * a.Cin + ci0;
#pragma unroll
      for (int ci = 0; ci < CIT; ++ci)
        if (ci0 + ci < a.Cin) dp[ci] = __float2bfloat16(acc[ci]);
    }
    if (a.s != nullptr) {
#pragma unroll
      for (int ci = 0; ci < CIT; ++ci) {
        float v = ds[ci], q = dt[ci];
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
          q += __shfl_down_sync(0xffffffffu, q, off);
        }
        if ((tid & 31) == 0) {
          atomicAdd(&red[ci], v);
          atomicAdd(&red[CIT + ci], q);
        }
      }
      __syncthreads();
      if (tid < CIT && ci0 + tid < a.Cin) {
        atomicAdd(&a.dst[(int64_t)(b * 2) * a.Cin + ci0 + tid], red[tid]);
        atomicAdd(&a.dst[(int64_t)(b * 2 + 1) * a.Cin + ci0 + tid], red[CIT + tid]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < 27 * CIT * a.Cout; i += kThreads) {
    const int co = i % a.Cout, ci = (i / a.Cout) % CIT, tp = i / (a.Cout * CIT);
    if (ci0 + ci < a.Cin)
      atomicAdd(&a.dk[((int64_t)tp * a.Cin + ci0 + ci) * a.Cout + co],
                static_cast<double>(sdk[i]));
  }
  if (blockIdx.y == 0)
    for (int i = tid; i < a.Cout; i += kThreads) atomicAdd(&a.db[i], sdb[i]);
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

template <int CIT, int COT>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const long ci_chunks = (a.Cin + CIT - 1) / CIT;
  const long ntiles = (long)a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  if (ci_chunks > 65535 || ntiles > 0x7fffffffL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CIT, COT>(a);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3_bwd_kernel<CIT, COT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // two blocks per SM where they fit: every block ends with 27 CIT Cout
  // global atomics whatever it walked (conv3_dk's finding)
  long gx = (2L * sm_count() + ci_chunks - 1) / ci_chunks;
  if (gx > ntiles) gx = ntiles;
  dim3 grid((unsigned)gx, (unsigned)ci_chunks, 1);
  conv3_bwd_kernel<CIT, COT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int CIT>
cudaError_t dispatch_cot(const BwdArgs& a, int cot, cudaStream_t st) {
  switch (cot) {
    case 8: return launch<CIT, 8>(a, st);
    case 4: return launch<CIT, 4>(a, st);
    case 2: return launch<CIT, 2>(a, st);
    default: return launch<CIT, 1>(a, st);
  }
}

int pow2_tile(int c) { return c >= 8 ? 8 : c >= 4 ? 4 : c >= 2 ? 2 : 1; }

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, dx: [B, D, H, W, Cin] bf16; gy: [B, D, H, W, Cout] bf16; w: [27, Cin,
// Cout] bf16 (the forward's kernel layout); s, t: [B, Cin] f32 or both null;
// dst: [B, 2, Cin] f32, zeroed, given exactly when s is; dk [27, Cin, Cout]
// and db [Cout] f64, zeroed.
// Returns cudaGetLastError() after the launch (0 on success).
int vaeseg_conv3_bwd(const void* x, const void* gy, const void* w, const void* s,
                     const void* t, void* dx, void* dst, void* dk, void* db, int B,
                     int D, int H, int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if ((s == nullptr) != (t == nullptr) || (s == nullptr) != (dst == nullptr))
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dst = static_cast<float*>(dst);
  a.dk = static_cast<double*>(dk);
  a.db = static_cast<double*>(db);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.tw = W < 16 ? W : 16;
  a.th = H < 8 ? H : 8;
  int td = kThreads / (a.tw * a.th);
  a.td = D < td ? D : td;
  while (a.td > 1 && (a.td + 2) * (a.th + 2) * (a.tw + 2) > kMaxHalo) a.td /= 2;
  a.tiles_d = (D + a.td - 1) / a.td;
  a.tiles_h = (H + a.th - 1) / a.th;
  a.tiles_w = (W + a.tw - 1) / a.tw;
  // the block's dk sits in shared memory: fewer input channels a block
  // where Cout is wide
  int cit = pow2_tile(Cin);
  while (cit > 1 && sizeof(float) * 27 * cit * Cout > kMaxDkSmem) cit /= 2;
  const int cot = pow2_tile(Cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cit) {
    case 8: return dispatch_cot<8>(a, cot, st);
    case 4: return dispatch_cot<4>(a, cot, st);
    case 2: return dispatch_cot<2>(a, cot, st);
    default: return dispatch_cot<1>(a, cot, st);
  }
}

}  // extern "C"
