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
//   x * s + t is rounded as in K1's forward (common.cuh). Under the
//   prologue xn is also 0 on planes outside [dlo, dhi] (stencil3.py's dlim:
//   a D-slab's missing-neighbour halo is no plane of the volume).
//
// What bounds it on the H100: the forward's 27 Cin Cout MACs a voxel, so
// the bytes (3.35 TB/s) at the 128^3 / 64^3 stages (C = 1..16) and the
// tensor-core operations at the deep ones (counted twice under the
// prologue, whose products are two MMAs each). The TPU kernel carried its
// [taps, Cin, Cout] sum in VMEM across a sequential grid. Here it is the
// split-K implicit GEMM of wgrad.cuh (M = (tap, Cin), N = Cout, K = voxels):
// a block stages a tile's (td+2)(th+2)(tw+2) halo of x and its gy once by
// cp.async, double-buffered, and runs mma.sync on the tensor cores with
// ldmatrix.trans addressing each tap's voxel rows inside the halo; the
// prologue's f32 xn enters as bf16 hi + lo (two MMAs, ~2^-17 a term). Each
// block writes its f32 partial once, and a second kernel sums the partials
// of the voxel splits in a fixed order in f64: no atomics, the same bits on
// every run.

#include "wgrad.cuh"

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [B, D, H, W, Cin] and gy [B, D, H, W, Cout] bf16; s/t [B, Cin] f32 or
// null, [dlo, dhi] the planes the prologue keeps; ws [splits, 27, Cin,
// Cout] f32 and wsdb [splits, Cout] f64 the
// workspace of `plan` (ops/conv3.py::wgrad_plan, mode 0); dk [27, Cin, Cout]
// and db [Cout] f32, written whole. Returns the first launch error (0 on
// success).
int vaeseg_conv3_dk(const void* x, const void* gy, const void* s,
                    const void* t, void* ws, void* wsdb, void* dk, void* db,
                    int B, int D, int H, int W, int Cin, int Cout, int dlo,
                    int dhi, const void* plan, void* stream) {
  const int* p = static_cast<const int*>(plan);
  if (D <= 0 || H <= 0 || W <= 0 || dhi >= D) return cudaErrorInvalidValue;
  return wgrad::weight_grad<wgrad::kConv3>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<float*>(ws),
      static_cast<double*>(wsdb), static_cast<float*>(dk),
      static_cast<float*>(db), B, D, H, W, Cin, D, H, W, Cout, p,
      static_cast<cudaStream_t>(stream), dlo, dhi);
}

}  // extern "C"
