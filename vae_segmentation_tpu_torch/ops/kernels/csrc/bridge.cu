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
//
// What bounds them on the H100: both move more bytes than they compute
// (8 C_in C_out MACs per coarse voxel against 9 voxels of traffic), so the
// 3.35 TB/s memory rate is the bound at every stage of the path. The TPU
// kernels' routing matrices only existed to scatter into the folded,
// W-packed lane layout; in the logical layout each thread owns one output
// voxel and COT of its channels, reads its input channels contiguously
// (neighbouring threads read neighbouring voxels) and takes the weights
// from L1, where every thread of a warp reads the same element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

struct BridgeArgs {
  const __nv_bfloat16* x;  // [B, D, H, W, Cin] (input grid)
  const __nv_bfloat16* w;  // [8, Cin, Cout], a = (ad * 2 + ah) * 2 + aw
  const float* bias;       // [Cout]
  const float* s;          // [B, Cin] prologue scale (down only), or null
  const float* t;          // [B, Cin] prologue shift
  __nv_bfloat16* y;        // [B, Do, Ho, Wo, Cout]
  int B, D, H, W, Cin, Cout;  // input dims
  int Do, Ho, Wo;             // output dims
};

template <int COT>
__global__ void down_kernel(const BridgeArgs a) {
  const int64_t nvox = (int64_t)a.B * a.Do * a.Ho * a.Wo;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int co0 = blockIdx.y * COT;
  int64_t r = v;
  const int ow = (int)(r % a.Wo); r /= a.Wo;
  const int oh = (int)(r % a.Ho); r /= a.Ho;
  const int od = (int)(r % a.Do);
  const int b = (int)(r / a.Do);
  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = a.bias[co0 + c];
  for (int tap = 0; tap < 8; ++tap) {
    const int ad = tap >> 2, ah = (tap >> 1) & 1, aw = tap & 1;
    const __nv_bfloat16* xp =
        a.x + ((((int64_t)b * a.D + 2 * od + ad) * a.H + 2 * oh + ah) * a.W +
               2 * ow + aw) * a.Cin;
    const __nv_bfloat16* wp = a.w + (int64_t)tap * a.Cin * a.Cout + co0;
    for (int ci = 0; ci < a.Cin; ++ci) {
      float xv = __bfloat162float(xp[ci]);
      if (a.s != nullptr) {
        const int sc = b * a.Cin + ci;
        xv = fmaxf(pre_activation(xv, a.s[sc], a.t[sc]), 0.f);
      }
      const __nv_bfloat16* wr = wp + (int64_t)ci * a.Cout;
#pragma unroll
      for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, __bfloat162float(wr[c]), acc[c]);
    }
  }
  __nv_bfloat16* yp = a.y + v * a.Cout + co0;
#pragma unroll
  for (int c = 0; c < COT; ++c) yp[c] = __float2bfloat16(acc[c]);
}

template <int COT>
__global__ void up_kernel(const BridgeArgs a) {
  const int64_t nvox = (int64_t)a.B * a.Do * a.Ho * a.Wo;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int co0 = blockIdx.y * COT;
  int64_t r = v;
  const int ow = (int)(r % a.Wo); r /= a.Wo;
  const int oh = (int)(r % a.Ho); r /= a.Ho;
  const int od = (int)(r % a.Do);
  const int b = (int)(r / a.Do);
  const int tap = ((od & 1) * 2 + (oh & 1)) * 2 + (ow & 1);
  const __nv_bfloat16* xp =
      a.x + ((((int64_t)b * a.D + (od >> 1)) * a.H + (oh >> 1)) * a.W + (ow >> 1)) * a.Cin;
  const __nv_bfloat16* wp = a.w + (int64_t)tap * a.Cin * a.Cout + co0;
  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = a.bias[co0 + c];
  for (int ci = 0; ci < a.Cin; ++ci) {
    const float xv = __bfloat162float(xp[ci]);
    const __nv_bfloat16* wr = wp + (int64_t)ci * a.Cout;
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, __bfloat162float(wr[c]), acc[c]);
  }
  __nv_bfloat16* yp = a.y + v * a.Cout + co0;
#pragma unroll
  for (int c = 0; c < COT; ++c) yp[c] = __float2bfloat16(acc[c]);
}

template <int COT>
cudaError_t launch(const BridgeArgs& a, bool up, cudaStream_t stream) {
  const int64_t nvox = (int64_t)a.B * a.Do * a.Ho * a.Wo;
  const int nthr = 256;
  const int64_t nblk = (nvox + nthr - 1) / nthr;
  if (nblk > 0x7fffffff) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nblk, a.Cout / COT, 1);
  if (up) {
    up_kernel<COT><<<grid, nthr, 0, stream>>>(a);
  } else {
    down_kernel<COT><<<grid, nthr, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const BridgeArgs& a, bool up, cudaStream_t stream) {
  if (a.Cout % 16 == 0) return launch<16>(a, up, stream);
  if (a.Cout % 8 == 0) return launch<8>(a, up, stream);
  if (a.Cout % 4 == 0) return launch<4>(a, up, stream);
  if (a.Cout % 2 == 0) return launch<2>(a, up, stream);
  return launch<1>(a, up, stream);
}

BridgeArgs make_args(const void* x, const void* w, const void* bias,
                     const void* s, const void* t, void* y, int B, int D,
                     int H, int W, int Cin, int Cout) {
  BridgeArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B; a.D = D; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
  a.Do = a.Ho = a.Wo = 0;
  return a;
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, D, H, W, Cin] -> y [B, D/2, H/2, W/2, Cout]; s/t may be null.
int vaeseg_down_k2s2(const void* x, const void* w, const void* bias,
                     const void* s, const void* t, void* y, int B, int D,
                     int H, int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || D < 2 || H < 2 || W < 2 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  BridgeArgs a = make_args(x, w, bias, s, t, y, B, D, H, W, Cin, Cout);
  a.Do = D / 2; a.Ho = H / 2; a.Wo = W / 2;
  return dispatch(a, false, static_cast<cudaStream_t>(stream));
}

// x [B, D, H, W, Cin] -> y [B, 2D, 2H, 2W, Cout].
int vaeseg_up_k2s2(const void* x, const void* w, const void* bias, void* y,
                   int B, int D, int H, int W, int Cin, int Cout,
                   void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  BridgeArgs a = make_args(x, w, bias, nullptr, nullptr, y, B, D, H, W, Cin, Cout);
  a.Do = 2 * D; a.Ho = 2 * H; a.Wo = 2 * W;
  return dispatch(a, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
