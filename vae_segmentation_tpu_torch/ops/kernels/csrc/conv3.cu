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
//   stats[b, 0, o] += sum y_bf16,  stats[b, 1, o] += sum y_bf16^2
//   or y = softmax over o (Cout == n_class), f32 math, bf16 store;
//   or post: the f32 sum g is the cotangent of relu(xs * ps + pt):
//     gm = g where xs * ps + pt > 0 else 0,  y = gm * ps,
//     stats[b, 0, o] += sum gm * xs (ds),  stats[b, 1, o] += sum gm (dt),
//   over in-volume voxels only. x * s + t is two roundings (multiply, then
//   add) wherever it is computed, so the backward's mask repeats the
//   forward's arithmetic bit for bit.
//
// What bounds it on the H100: at the 128^3/64^3 stages (C = 8..16) the
// bytes (3.35 TB/s) bound the work; at 8^3/4^3 with C = 128..256 the
// operations do. This first version runs on the CUDA cores in f32 (no
// tensor cores): each block stages a (td+2)(th+2)(tw+2) x cit input halo,
// prologue applied once per element, plus a 27 x cit x COT weight slice in
// shared memory, and every thread accumulates one output voxel's COT
// channels in registers. Each input element is read from device memory
// once per block (not 27x), which is what the byte-bound stages need. The
// deep stages have few voxels, so there COT shrinks until the grid fills
// the SMs.
// The stats epilogue reduces a block's voxels with warp shuffles and
// shared-memory atomics, then adds one partial per (block, channel) to the
// [B, 2, Cout] f32 output with global atomics (order varies run to run).
// Tensor-core tiles (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

struct Conv3Args {
  const __nv_bfloat16* x;  // [B, D, H, W, Cin]
  const __nv_bfloat16* w;  // [27, Cin, Cout], tap = (kd * 3 + kh) * 3 + kw
  const float* bias;       // [Cout], or null for none
  const float* s;          // [B, Cin] prologue scale, or null
  const float* t;          // [B, Cin] prologue shift
  const __nv_bfloat16* xs; // post: [B, D, H, W, Cout], the forward's input
  const float* ps;         // post: [B, Cout] scale
  const float* pt;         // post: [B, Cout] shift
  __nv_bfloat16* y;        // [B, D, H, W, Cout]
  float* stats;            // [B, 2, Cout], zeroed by the caller, or null
  int B, D, H, W, Cin, Cout;
  int cit;                 // input channels per shared-memory chunk
  int td, th, tw;          // output tile (one voxel per thread)
  int tiles_h, tiles_w;
  int softmax;
};

template <int COT>
__global__ void conv3_kernel(const Conv3Args a) {
  extern __shared__ float smem[];
  __shared__ float red[2 * COT];
  const int cit = a.cit;
  const int cs = (cit % 2 == 0) ? cit + 1 : cit;  // odd stride: no bank conflicts
  const int hd = a.td + 2, hh = a.th + 2, hw = a.tw + 2;
  const int halo = hd * hh * hw;
  float* sx = smem;
  float* sw = smem + halo * cs;

  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  const int tw_i = tile % a.tiles_w;
  tile /= a.tiles_w;
  const int th_i = tile % a.tiles_h;
  const int td_i = tile / a.tiles_h;
  const int co0 = blockIdx.y * COT;
  const int b = blockIdx.z;
  const int d0 = td_i * a.td, h0 = th_i * a.th, w0 = tw_i * a.tw;
  const int lw = tid % a.tw, lh = (tid / a.tw) % a.th;
  const int ld_raw = tid / (a.tw * a.th);
  // threads past the tile (block rounded up to whole warps) compute on a
  // clamped position and store nothing
  const int ld = ld_raw < a.td ? ld_raw : a.td - 1;
  const int od = d0 + ld, oh = h0 + lh, ow = w0 + lw;
  const bool valid = ld_raw < a.td && od < a.D && oh < a.H && ow < a.W;

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < a.Cin; c0 += cit) {
    for (int i = tid; i < halo * cit; i += nthr) {
      const int ci = i % cit;
      const int p = i / cit;
      const int pw = p % hw, ph = (p / hw) % hh, pd = p / (hw * hh);
      const int gd = d0 + pd - 1, gh = h0 + ph - 1, gw = w0 + pw - 1;
      float v = 0.f;
      if (gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W) {
        const int64_t idx =
            ((((int64_t)b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin + c0 + ci;
        v = __bfloat162float(a.x[idx]);
        if (a.s != nullptr) {
          const int sc = b * a.Cin + c0 + ci;
          v = fmaxf(pre_activation(v, a.s[sc], a.t[sc]), 0.f);
        }
      }
      sx[p * cs + ci] = v;
    }
    for (int i = tid; i < 27 * cit * COT; i += nthr) {
      const int co = i % COT;
      const int ci = (i / COT) % cit;
      const int tap = i / (COT * cit);
      sw[i] = __bfloat162float(
          a.w[((int64_t)tap * a.Cin + c0 + ci) * a.Cout + co0 + co]);
    }
    __syncthreads();
    for (int kd = 0; kd < 3; ++kd) {
      for (int kh = 0; kh < 3; ++kh) {
        for (int kw = 0; kw < 3; ++kw) {
          const float* xp = sx + (((ld + kd) * hh + lh + kh) * hw + lw + kw) * cs;
          const float* wp = sw + ((kd * 3 + kh) * 3 + kw) * cit * COT;
          for (int ci = 0; ci < cit; ++ci) {
            const float xv = xp[ci];
#pragma unroll
            for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, wp[ci * COT + c], acc[c]);
          }
        }
      }
    }
    __syncthreads();
  }

  float out[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c)
    out[c] = a.bias != nullptr ? acc[c] + a.bias[co0 + c] : acc[c];
  if (a.softmax) {  // COT == Cout: the whole class vector is in this thread
    float m = out[0];
#pragma unroll
    for (int c = 1; c < COT; ++c) m = fmaxf(m, out[c]);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      out[c] = expf(out[c] - m);
      sum += out[c];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int c = 0; c < COT; ++c) out[c] *= inv;
  }
  const int64_t vox = (((int64_t)b * a.D + od) * a.H + oh) * a.W + ow;
  float sec[COT];  // the second statistic: y^2 (stats) or gm (post)
  if (a.xs != nullptr) {
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const int sc = b * a.Cout + co0 + c;
      const float xv = valid ? __bfloat162float(a.xs[vox * a.Cout + co0 + c]) : 0.f;
      const float gm =
          (valid && pre_activation(xv, a.ps[sc], a.pt[sc]) > 0.f) ? out[c] : 0.f;
      out[c] = gm * a.ps[sc];
      acc[c] = gm * xv;
      sec[c] = gm;
    }
  }
  if (valid) {
    __nv_bfloat16* yp = a.y + vox * a.Cout + co0;
#pragma unroll
    for (int c = 0; c < COT; ++c) yp[c] = __float2bfloat16(out[c]);
  }
  if (a.stats != nullptr) {
    if (tid < 2 * COT) red[tid] = 0.f;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      float v, q;
      if (a.xs != nullptr) {
        v = acc[c];
        q = sec[c];
      } else {
        // stats of the STORED bf16 values, as the norm that reads y sees them
        v = valid ? __bfloat162float(__float2bfloat16(out[c])) : 0.f;
        q = v * v;
      }
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
        q += __shfl_down_sync(0xffffffffu, q, off);
      }
      if ((tid & 31) == 0) {
        atomicAdd(&red[c], v);
        atomicAdd(&red[COT + c], q);
      }
    }
    __syncthreads();
    if (tid < COT) {
      atomicAdd(&a.stats[(int64_t)(b * 2) * a.Cout + co0 + tid], red[tid]);
      atomicAdd(&a.stats[(int64_t)(b * 2 + 1) * a.Cout + co0 + tid], red[COT + tid]);
    }
  }
}

template <int COT>
cudaError_t launch(const Conv3Args& a, cudaStream_t stream) {
  const int tiles_d = (a.D + a.td - 1) / a.td;
  const int nvox = a.td * a.th * a.tw;
  const int nthr = (nvox + 31) / 32 * 32;
  const int cs = (a.cit % 2 == 0) ? a.cit + 1 : a.cit;
  const size_t smem =
      sizeof(float) * ((size_t)(a.td + 2) * (a.th + 2) * (a.tw + 2) * cs +
                       (size_t)27 * a.cit * COT);
  if (smem > 48 * 1024 || nthr > 1024) return cudaErrorInvalidValue;
  dim3 grid(tiles_d * a.tiles_h * a.tiles_w, a.Cout / COT, a.B);
  conv3_kernel<COT><<<grid, nthr, smem, stream>>>(a);
  return cudaGetLastError();
}

int pick_cot(int cout, int softmax) {
  if (softmax) {
    return (cout == 1 || cout == 2 || cout == 3 || cout == 4 || cout == 8 ||
            cout == 16) ? cout : 0;
  }
  const int opts[] = {16, 8, 4, 3, 2, 1};
  for (int c : opts)
    if (cout % c == 0) return c;
  return 0;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success). bias, (s, t),
// (xs, ps, pt) and stats may be null; with xs the post epilogue is on and
// stats receives (ds, dt).
int vaeseg_conv3(const void* x, const void* w, const void* bias, const void* s,
                 const void* t, const void* xs, const void* ps, const void* pt,
                 void* y, void* stats, int B, int D, int H, int W, int Cin,
                 int Cout, int softmax, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if (softmax && stats != nullptr) return cudaErrorInvalidValue;
  if (xs != nullptr && (softmax || stats == nullptr || ps == nullptr || pt == nullptr))
    return cudaErrorInvalidValue;
  Conv3Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.xs = static_cast<const __nv_bfloat16*>(xs);
  a.ps = static_cast<const float*>(ps);
  a.pt = static_cast<const float*>(pt);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.stats = static_cast<float*>(stats);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.softmax = softmax;
  a.cit = (Cin % 8 == 0) ? 8 : (Cin % 4 == 0) ? 4 : (Cin % 2 == 0) ? 2 : 1;
  a.tw = W < 16 ? W : 16;
  a.th = H < 8 ? H : 8;
  int td = 256 / (a.tw * a.th);
  if (td < 1) td = 1;
  a.td = D < td ? D : td;
  a.tiles_h = (H + a.th - 1) / a.th;
  a.tiles_w = (W + a.tw - 1) / a.tw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cot = pick_cot(Cout, softmax);
  if (!softmax && (cot & (cot - 1)) == 0) {
    // the deep stages (4^3..16^3) have few spatial tiles: narrow the
    // channel tile until the grid holds two blocks per SM
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long tiles = (long)((D + a.td - 1) / a.td) * a.tiles_h * a.tiles_w * B;
    while (cot > 1 && tiles * (Cout / cot) < 2L * sms) cot /= 2;
  }
  switch (cot) {
    case 16: return launch<16>(a, st);
    case 8: return launch<8>(a, st);
    case 4: return launch<4>(a, st);
    case 3: return launch<3>(a, st);
    case 2: return launch<2>(a, st);
    case 1: return launch<1>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
