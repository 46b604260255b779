// The backwards of K2 (down_k2s2) and K3 (up_k2s2) for Hopper (sm_90a):
// channels-last bf16 activations and cotangents, f32 accumulation, f32
// weight, bias and affine gradients.
//
// down_k2s2_bwd replaces (TPU, Pallas) vae_segmentation_tpu/ops/pallas/
//   upbridge.py::_run_down_bwd and ::_run_down_bwd_pre. With fine voxel
//   f = 2i + a of coarse voxel i (a in 2^3):
//     g[b, f, c]  = sum_o gy[b, i, o] * wk[a, c, o]
//     dx          = g, or with the prologue gm * s[b, c], gm = g where
//                   x * s + t > 0 else 0, dst[b, 0, c] = sum_f gm * x (ds),
//                   dst[b, 1, c] = sum_f gm (dt)
//     dk[a, c, o] = sum_{b, i} xn[b, 2i + a, c] * gy[b, i, o]
//     db[o]       = sum_{b, i} gy[b, i, o]
//   xn = relu(x * s + t) or x, rounded as in the forward (common.cuh).
// up_k2s2_bwd replaces upbridge.py::_run_bwd:
//     dx[b, i, c] = sum_{a, o} gy[b, 2i + a, o] * wk[a, c, o]
//     dk[a, c, o] = sum_{b, i} x[b, i, c] * gy[b, 2i + a, o]
//     db[o]       = sum_{b, f} gy[b, f, o]
//
// What bounds them on the H100: the bytes, as for the forwards (8 Cin Cout
// MACs per coarse voxel against 9 voxels of traffic each for dx and dk).
// The TPU kernels ran dx, dk and db in one pass over a sequential grid and
// carried dk in VMEM. Here dx is one kernel (a thread per output voxel and
// CT of its channels, weights from L1, the prologue backward's ds/dt
// reduced by warp shuffles, shared and then global atomics) and dk/db
// another: a block stages 128 coarse voxels and their 1024 fine voxels,
// CIT x COT channels of them, in shared memory; thread (tap, slice) keeps a
// CIT x COT partial in registers over the voxels of its slice and over all
// tiles the block walks, the 32 slices meet in shared memory, and one f32
// atomicAdd per (tap, c, o) and block reaches dk. A caller that needs only
// dx (a frozen weight) launches only the dx kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

struct BwdArgs {
  const __nv_bfloat16* x;   // forward input: coarse grid (up) or fine grid (down)
  const __nv_bfloat16* gy;  // output cotangent: fine grid (up) or coarse grid (down)
  const __nv_bfloat16* w;   // [8, Cin, Cout], a = (ad * 2 + ah) * 2 + aw
  const float* s;           // [B, Cin] prologue scale (down), or null
  const float* t;           // [B, Cin] prologue shift
  __nv_bfloat16* dx;        // like x, or null
  float* dk;                // [8, Cin, Cout] zeroed, or null
  float* db;                // [Cout] zeroed, or null
  float* dst;               // [B, 2, Cin] zeroed (down with prologue), or null
  int B, Dc, Hc, Wc;        // coarse grid
  int Df, Hf, Wf;           // fine grid as stored (>= 2 * coarse)
  int Cin, Cout;
  int co_chunks, tiles_per_b;
};

// dx of K3: one thread per coarse voxel and CT input channels.
template <int CT>
__global__ void up_dx_kernel(const BwdArgs a) {
  const int64_t nvox = (int64_t)a.B * a.Dc * a.Hc * a.Wc;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int c0 = blockIdx.y * CT;
  int64_t r = v;
  const int iw = (int)(r % a.Wc); r /= a.Wc;
  const int ih = (int)(r % a.Hc); r /= a.Hc;
  const int id = (int)(r % a.Dc);
  const int b = (int)(r / a.Dc);
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.f;
  for (int tap = 0; tap < 8; ++tap) {
    const int ad = tap >> 2, ah = (tap >> 1) & 1, aw = tap & 1;
    const __nv_bfloat16* gp =
        a.gy + ((((int64_t)b * a.Df + 2 * id + ad) * a.Hf + 2 * ih + ah) * a.Wf +
                2 * iw + aw) * a.Cout;
    const __nv_bfloat16* wp = a.w + ((int64_t)tap * a.Cin + c0) * a.Cout;
    for (int o = 0; o < a.Cout; ++o) {
      const float gv = __bfloat162float(gp[o]);
#pragma unroll
      for (int c = 0; c < CT; ++c)
        acc[c] = fmaf(gv, __bfloat162float(wp[(int64_t)c * a.Cout + o]), acc[c]);
    }
  }
  __nv_bfloat16* dp = a.dx + v * a.Cin + c0;
#pragma unroll
  for (int c = 0; c < CT; ++c) dp[c] = __float2bfloat16(acc[c]);
}

// dx of K2: one thread per fine voxel of batch blockIdx.z and CT input
// channels, with the prologue's backward when s is given.
template <int CT>
__global__ void down_dx_kernel(const BwdArgs a) {
  __shared__ float red[2 * CT];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CT;
  const int64_t per_b = (int64_t)a.Df * a.Hf * a.Wf;
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + tid;
  const bool in = f < per_b;
  int64_t r = in ? f : 0;
  const int fw = (int)(r % a.Wf); r /= a.Wf;
  const int fh = (int)(r % a.Hf);
  const int fd = (int)(r / a.Hf);
  const int id = fd >> 1, ih = fh >> 1, iw = fw >> 1;
  // an odd fine extent leaves a last plane the forward never read
  const bool live = in && id < a.Dc && ih < a.Hc && iw < a.Wc;
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.f;
  if (live) {
    const int tap = ((fd & 1) * 2 + (fh & 1)) * 2 + (fw & 1);
    const __nv_bfloat16* gp =
        a.gy + ((((int64_t)b * a.Dc + id) * a.Hc + ih) * a.Wc + iw) * a.Cout;
    const __nv_bfloat16* wp = a.w + ((int64_t)tap * a.Cin + c0) * a.Cout;
    for (int o = 0; o < a.Cout; ++o) {
      const float gv = __bfloat162float(gp[o]);
#pragma unroll
      for (int c = 0; c < CT; ++c)
        acc[c] = fmaf(gv, __bfloat162float(wp[(int64_t)c * a.Cout + o]), acc[c]);
    }
  }
  const int64_t off = ((int64_t)b * per_b + f) * a.Cin + c0;
  if (a.s == nullptr) {
    if (in) {
#pragma unroll
      for (int c = 0; c < CT; ++c) a.dx[off + c] = __float2bfloat16(acc[c]);
    }
    return;
  }
  if (tid < 2 * CT) red[tid] = 0.f;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int sc = b * a.Cin + c0 + c;
    const float sv = a.s[sc];
    const float xv = in ? __bfloat162float(a.x[off + c]) : 0.f;
    const float gm = (live && pre_activation(xv, sv, a.t[sc]) > 0.f) ? acc[c] : 0.f;
    if (in) a.dx[off + c] = __float2bfloat16(gm * sv);
    float ds = gm * xv, dt = gm;
    for (int o = 16; o > 0; o >>= 1) {
      ds += __shfl_down_sync(0xffffffffu, ds, o);
      dt += __shfl_down_sync(0xffffffffu, dt, o);
    }
    if ((tid & 31) == 0) {
      atomicAdd(&red[c], ds);
      atomicAdd(&red[CT + c], dt);
    }
  }
  __syncthreads();
  if (tid < CT) {
    atomicAdd(&a.dst[(int64_t)(b * 2) * a.Cin + c0 + tid], red[tid]);
    atomicAdd(&a.dst[(int64_t)(b * 2 + 1) * a.Cin + c0 + tid], red[CT + tid]);
  }
}

constexpr int kTileVox = 128;   // coarse voxels per tile
constexpr int kSlices = 32;     // voxel slices per tap
constexpr int kThreads = 8 * kSlices;

// dk and db of both bridges. UP: x is coarse (Cin), gy fine (Cout);
// else x is fine (Cin, through the prologue), gy coarse (Cout).
template <bool UP, int CIT, int COT>
__global__ void __launch_bounds__(kThreads) bridge_dk_kernel(const BwdArgs a) {
  constexpr int CC = UP ? CIT : COT;  // channels staged of the coarse tensor
  constexpr int FC = UP ? COT : CIT;  // and of the fine one
  __shared__ float sc_[kTileVox * CC];
  __shared__ float sf_[kTileVox * 8 * FC];
  __shared__ float sred[8 * CIT * COT];
  __shared__ float sdb[COT];
  const int tid = threadIdx.x;
  const int ci0 = (blockIdx.y / a.co_chunks) * CIT;
  const int co0 = (blockIdx.y % a.co_chunks) * COT;
  const int cc0 = UP ? ci0 : co0, fc0 = UP ? co0 : ci0;
  const int c_lim = UP ? a.Cin : a.Cout, f_lim = UP ? a.Cout : a.Cin;
  const __nv_bfloat16* coarse = UP ? a.x : a.gy;
  const __nv_bfloat16* fine = UP ? a.gy : a.x;
  const int tap = tid % 8, slice = tid / 8;
  const int64_t nc = (int64_t)a.Dc * a.Hc * a.Wc;
  const bool sums_bias = a.db != nullptr && ci0 == 0;

  float acc[CIT * COT];
#pragma unroll
  for (int i = 0; i < CIT * COT; ++i) acc[i] = 0.f;
  float bsum = 0.f;

  const int ntiles = a.B * a.tiles_per_b;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / a.tiles_per_b;
    const int64_t i0 = (int64_t)(tile % a.tiles_per_b) * kTileVox;
    for (int i = tid; i < kTileVox * CC; i += kThreads) {
      const int c = i % CC;
      const int64_t iv = i0 + i / CC;
      float v = 0.f;
      if (iv < nc && cc0 + c < c_lim)
        v = __bfloat162float(coarse[((int64_t)b * nc + iv) * c_lim + cc0 + c]);
      sc_[i] = v;
    }
    for (int i = tid; i < kTileVox * 8 * FC; i += kThreads) {
      const int c = i % FC;
      const int row = i / FC;          // local coarse voxel * 8 + tap
      const int64_t iv = i0 + row / 8;
      const int ta = row % 8;
      float v = 0.f;
      if (iv < nc && fc0 + c < f_lim) {
        int64_t r = iv;
        const int iw = (int)(r % a.Wc); r /= a.Wc;
        const int ih = (int)(r % a.Hc);
        const int id = (int)(r / a.Hc);
        const int64_t fv = (((int64_t)b * a.Df + 2 * id + (ta >> 2)) * a.Hf + 2 * ih +
                            ((ta >> 1) & 1)) * a.Wf + 2 * iw + (ta & 1);
        v = __bfloat162float(fine[fv * f_lim + fc0 + c]);
        if (!UP && a.s != nullptr) {
          const int sc = b * a.Cin + fc0 + c;
          v = fmaxf(pre_activation(v, a.s[sc], a.t[sc]), 0.f);
        }
      }
      sf_[i] = v;
    }
    __syncthreads();
    for (int lv = slice; lv < kTileVox; lv += kSlices) {
      const float* cp = sc_ + lv * CC;
      const float* fp = sf_ + (lv * 8 + tap) * FC;
      const float* xp = UP ? cp : fp;
      const float* gp = UP ? fp : cp;
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
    if (sums_bias) {
      // every row of the staged gy, COT channels wide, shared by the block
      const float* g = UP ? sf_ : sc_;
      const int rows = UP ? kTileVox * 8 : kTileVox;
      const int co = tid % COT;
      float part = 0.f;  // a tile's sum enters the total as one term
      for (int row = tid / COT; row < rows; row += kThreads / COT)
        part += g[row * COT + co];
      bsum += part;
    }
    __syncthreads();
  }

  for (int i = tid; i < 8 * CIT * COT; i += kThreads) sred[i] = 0.f;
  if (tid < COT) sdb[tid] = 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < CIT * COT; ++i) atomicAdd(&sred[tap * CIT * COT + i], acc[i]);
  if (sums_bias) atomicAdd(&sdb[tid % COT], bsum);
  __syncthreads();
  for (int i = tid; i < 8 * CIT * COT; i += kThreads) {
    const int co = i % COT, ci = (i / COT) % CIT, tp = i / (COT * CIT);
    if (ci0 + ci < a.Cin && co0 + co < a.Cout)
      atomicAdd(&a.dk[((int64_t)tp * a.Cin + ci0 + ci) * a.Cout + co0 + co], sred[i]);
  }
  if (sums_bias && tid < COT && co0 + tid < a.Cout) atomicAdd(&a.db[co0 + tid], sdb[tid]);
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

template <int CT>
cudaError_t launch_dx(const BwdArgs& a, bool up, cudaStream_t stream) {
  const int nthr = 256;
  if (up) {
    const int64_t nvox = (int64_t)a.B * a.Dc * a.Hc * a.Wc;
    const int64_t nblk = (nvox + nthr - 1) / nthr;
    if (nblk > 0x7fffffff) return cudaErrorInvalidValue;
    up_dx_kernel<CT><<<dim3((unsigned)nblk, a.Cin / CT, 1), nthr, 0, stream>>>(a);
  } else {
    const int64_t per_b = (int64_t)a.Df * a.Hf * a.Wf;
    const int64_t nblk = (per_b + nthr - 1) / nthr;
    if (nblk > 0x7fffffff || a.B > 65535) return cudaErrorInvalidValue;
    down_dx_kernel<CT><<<dim3((unsigned)nblk, a.Cin / CT, a.B), nthr, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_dx(const BwdArgs& a, bool up, cudaStream_t st) {
  if (a.Cin % 16 == 0) return launch_dx<16>(a, up, st);
  if (a.Cin % 8 == 0) return launch_dx<8>(a, up, st);
  if (a.Cin % 4 == 0) return launch_dx<4>(a, up, st);
  if (a.Cin % 2 == 0) return launch_dx<2>(a, up, st);
  return launch_dx<1>(a, up, st);
}

template <int CIT, int COT>
cudaError_t launch_dk(BwdArgs a, bool up, cudaStream_t stream) {
  const int ci_chunks = (a.Cin + CIT - 1) / CIT;
  a.co_chunks = (a.Cout + COT - 1) / COT;
  const long chunks = (long)ci_chunks * a.co_chunks;
  const int64_t nc = (int64_t)a.Dc * a.Hc * a.Wc;
  const int64_t per_b = (nc + kTileVox - 1) / kTileVox;
  const int64_t ntiles = per_b * a.B;
  if (chunks > 65535 || ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  a.tiles_per_b = (int)per_b;
  // two blocks per SM: each block ends with 8 CIT COT global atomics, and
  // more blocks only add atomics (as in conv3_dk.cu)
  long gx = (2L * sm_count() + chunks - 1) / chunks;
  if (gx > ntiles) gx = ntiles;
  dim3 grid((unsigned)gx, (unsigned)chunks, 1);
  if (up) {
    bridge_dk_kernel<true, CIT, COT><<<grid, kThreads, 0, stream>>>(a);
  } else {
    bridge_dk_kernel<false, CIT, COT><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

int pow2_tile(int c) { return c >= 8 ? 8 : c >= 4 ? 4 : c >= 2 ? 2 : 1; }

template <int CIT>
cudaError_t dispatch_dk_cot(const BwdArgs& a, bool up, int cot, cudaStream_t st) {
  switch (cot) {
    case 8: return launch_dk<CIT, 8>(a, up, st);
    case 4: return launch_dk<CIT, 4>(a, up, st);
    case 2: return launch_dk<CIT, 2>(a, up, st);
    default: return launch_dk<CIT, 1>(a, up, st);
  }
}

cudaError_t dispatch_dk(const BwdArgs& a, bool up, cudaStream_t st) {
  const int cot = pow2_tile(a.Cout);
  switch (pow2_tile(a.Cin)) {
    case 8: return dispatch_dk_cot<8>(a, up, cot, st);
    case 4: return dispatch_dk_cot<4>(a, up, cot, st);
    case 2: return dispatch_dk_cot<2>(a, up, cot, st);
    default: return dispatch_dk_cot<1>(a, up, cot, st);
  }
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of K3 (up != 0) or K2. x [B, D, H, W, Cin] is the forward's
// input and gy its output's cotangent ([B, 2D, 2H, 2W, Cout] for K3,
// [B, D/2, H/2, W/2, Cout] for K2). dx (like x), dk [8, Cin, Cout] with db
// [Cout], and dst [B, 2, Cin] may each be null; dk, db and dst arrive zeroed;
// dst goes with s and t (K2's prologue) and needs dx. Returns the first
// launch error (0 on success).
int vaeseg_bridge_bwd(int up, const void* x, const void* gy, const void* w,
                      const void* s, const void* t, void* dx, void* dk,
                      void* db, void* dst, int B, int D, int H, int W, int Cin,
                      int Cout, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if (!up && (D < 2 || H < 2 || W < 2)) return cudaErrorInvalidValue;
  if ((dk == nullptr) != (db == nullptr)) return cudaErrorInvalidValue;
  if (up && s != nullptr) return cudaErrorInvalidValue;
  if (dx != nullptr && (s != nullptr) != (dst != nullptr)) return cudaErrorInvalidValue;
  BwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gy = static_cast<const __nv_bfloat16*>(gy);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dk = static_cast<float*>(dk);
  a.db = static_cast<float*>(db);
  a.dst = static_cast<float*>(dst);
  a.B = B; a.Cin = Cin; a.Cout = Cout;
  if (up) {
    a.Dc = D; a.Hc = H; a.Wc = W;
    a.Df = 2 * D; a.Hf = 2 * H; a.Wf = 2 * W;
  } else {
    a.Dc = D / 2; a.Hc = H / 2; a.Wc = W / 2;
    a.Df = D; a.Hf = H; a.Wf = W;
  }
  a.co_chunks = 0; a.tiles_per_b = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    cudaError_t rc = dispatch_dx(a, up != 0, st);
    if (rc != cudaSuccess) return rc;
  }
  if (dk != nullptr) return dispatch_dk(a, up != 0, st);
  return cudaSuccess;
}

}  // extern "C"
