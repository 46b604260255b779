// Shared by the port's kernel sources.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The prologue's pre-activation x * s + t with one rounding per operation
// (no fused multiply-add): every kernel that applies relu(x * s + t) or its
// backward mask, and the plain PyTorch versions (a multiply, then an add),
// compute the same value, so the ReLU mask never flips between a forward
// and its backward.
__device__ __forceinline__ float pre_activation(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}

namespace {

// The second pass of a reduction without atomics: each block of the first
// pass wrote its f32 partial of O sums once, part[b, p, o] for P partials a
// batch entry, and out[b, o] = sum_p part[b, p, o] is added here in f64 in
// a fixed order and rounded once to OutT, so the result is the same bits on
// every run. Block (32 x 32): lane = output, warp w sums the partials w,
// w + 32, ...; warp 0 adds the 32 sums in order. Grid (ceil(O / 32), B).
template <typename OutT>
__global__ void __launch_bounds__(1024) parts_reduce_kernel(
    const float* part, OutT* out, int P, int O) {
  __shared__ double sums[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane, b = blockIdx.y;
  double s = 0.0;
  if (o < O)
    for (int p = warp; p < P; p += 32) s += part[((int64_t)b * P + p) * O + o];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && o < O) {
    double t = 0.0;
    for (int w = 0; w < 32; ++w) t += sums[w][lane];
    out[(int64_t)b * O + o] = static_cast<OutT>(t);
  }
}

template <typename OutT>
cudaError_t parts_reduce(const float* part, OutT* out, int B, int P, int O,
                         cudaStream_t stream) {
  if (B <= 0 || B > 65535 || P <= 0 || O <= 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((O + 31) / 32), (unsigned)B, 1);
  parts_reduce_kernel<OutT><<<grid, 1024, 0, stream>>>(part, out, P, O);
  return cudaGetLastError();
}

}  // namespace
