// Shared by the port's kernel sources.
#pragma once

// The prologue's pre-activation x * s + t with one rounding per operation
// (no fused multiply-add): every kernel that applies relu(x * s + t) or its
// backward mask, and the plain PyTorch versions (a multiply, then an add),
// compute the same value, so the ReLU mask never flips between a forward
// and its backward.
__device__ __forceinline__ float pre_activation(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}
