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
// What bounds them on the H100: the bytes (8 Cin Cout MACs per coarse
// voxel against 9 voxels of traffic each for dx and dk). The TPU kernels
// ran dx, dk and db in one pass over a sequential grid and carried dk in
// VMEM. Here each part is its own kernel, and a caller that needs only one
// part (a frozen weight, an input without gradient) launches only that:
// - dk and db of both bridges: the split-K tensor-core kernel of
//   wgrad.cuh, M = (tap, fine channel), N = coarse channel, K = coarse
//   voxels (each coarse voxel's 8 fine rows, one per tap), the prologue's
//   xn as bf16 hi + lo, partials summed in a fixed order in f64 (no
//   atomics; the same bits on every run).
// - up's dx: a GEMM on the tensor cores, M = coarse voxels, N = Cin,
//   K = 8 Cout (up_dx_kernel): a block stages a brick of 64 coarse voxels'
//   8 fine rows and the matching [8, nc, 16] weight slice, 16 channels of
//   gy at a time, by cp.async into a two-slot ring, and runs mma.sync
//   (ldmatrix without transpose: the fine rows are channels-last already).
// - down's dx (down_dx_kernel): a thread per fine voxel and CT of its
//   channels on the CUDA cores; the prologue backward's ds/dt reduced by
//   warp shuffles and the warps in a fixed order in shared memory, each
//   block's [2, CT] partial written once and the blocks' partials added in
//   f64 in a fixed order (common.cuh::parts_reduce): no atomics.

#include "wgrad.cuh"

namespace {

using wgrad::kThreads;
using wgrad::kWarps;

struct BwdArgs {
  const __nv_bfloat16* x;   // forward input: the fine grid (down)
  const __nv_bfloat16* gy;  // output cotangent: the coarse grid (down)
  const __nv_bfloat16* w;   // [8, Cin, Cout], a = (ad * 2 + ah) * 2 + aw
  const float* s;           // [B, Cin] prologue scale, or null
  const float* t;           // [B, Cin] prologue shift
  __nv_bfloat16* dx;        // like x
  float* dpart;             // [B, blocks, 2, Cin] f32 partials of dst
  int B, Dc, Hc, Wc;        // coarse grid
  int Df, Hf, Wf;           // fine grid as stored (>= 2 * coarse)
  int Cin, Cout;
};

// the up dx plan's fields, in order (ops/bridges.py::up_dx_plan)
enum DxField {
  kDxTd, kDxTh, kDxTw, kDxTilesD, kDxTilesH, kDxTilesW, kDxNc
};

constexpr int kDxStr = 24;  // row stride of a 16-channel chunk (bf16)

struct DxArgs {
  const __nv_bfloat16* gy;  // [B, 2Dc, 2Hc, 2Wc, Cout]
  const __nv_bfloat16* w;   // [8, Cin, Cout]
  __nv_bfloat16* dx;        // [B, Dc, Hc, Wc, Cin]
  int B, Dc, Hc, Wc, Cin, Cout;
  int td, th, tw, tiles_d, tiles_h, tiles_w;
  int nvox, kpad, nc;
};

inline int dx_smem(int kpad, int nc) {
  return 2 * (8 * kpad + 8 * nc) * kDxStr * 2 + (8 * kpad + kpad) * 4;
}

// dx of K3 on the tensor cores: block (tile, channel chunk) computes
// dx[tile's kpad coarse voxels, nc channels] = sum over (a, o) of
// gy[2i + a, o] * wk[a, c, o]. Warp (mw, nw): m16 tile mw of the voxels,
// half nw of the channels (NT n8 tiles).
template <int NT>
__global__ void __launch_bounds__(kThreads) up_dx_kernel(const DxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NC = 16 * NT;
  const int grows = 8 * a.kpad, wrows = 8 * NC;
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = sg + 2 * grows * kDxStr;
  int* tpos = reinterpret_cast<int*>(sw + 2 * wrows * kDxStr);
  int* dpos = tpos + grows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mw = warp & 3, nw = warp >> 2;
  const int c0 = blockIdx.y * NC;

  for (int r = tid; r < grows; r += kThreads) {
    const int tap = r / a.kpad, k = r % a.kpad;
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    tpos[r] = k < a.nvox ? wgrad::pack(2 * kd + (tap >> 2),
                                       2 * kh + ((tap >> 1) & 1),
                                       2 * kw + (tap & 1))
                         : -1;
  }
  for (int k = tid; k < a.kpad; k += kThreads) {
    const int kw = k % a.tw, kh = (k / a.tw) % a.th, kd = k / (a.tw * a.th);
    dpos[k] = k < a.nvox ? wgrad::pack(kd, kh, kw) : -1;
  }
  int64_t r = blockIdx.x;
  const int w0 = (int)(r % a.tiles_w) * a.tw; r /= a.tiles_w;
  const int h0 = (int)(r % a.tiles_h) * a.th; r /= a.tiles_h;
  const int d0 = (int)(r % a.tiles_d) * a.td;
  const int b = (int)(r / a.tiles_d);
  const bool wvec = (a.Cout & 7) == 0;
  __syncthreads();

  auto stage = [&](int kc, int slot) {
    wgrad::stage_rows(sg + slot * grows * kDxStr, kDxStr, tpos, grows, a.gy,
                      b, 2 * a.Dc, 2 * a.Hc, 2 * a.Wc, a.Cout, 16 * kc, 16,
                      2 * d0, 2 * h0, 2 * w0);
    __nv_bfloat16* dst = sw + slot * wrows * kDxStr;
    for (int i = tid; i < 2 * wrows; i += kThreads) {
      const int row = i >> 1, g = i & 1;
      const int tap = row / NC, c = c0 + row % NC, o = 16 * kc + 8 * g;
      const bool ok = c < a.Cin && o < a.Cout;
      const int64_t off = ok ? ((int64_t)tap * a.Cin + c) * a.Cout + o : 0;
      __nv_bfloat16* out = dst + row * kDxStr + 8 * g;
      if (wvec) {
        wgrad::cp_async16(out, a.w + off, ok);
      } else {
        for (int j = 0; j < 8; ++j)
          out[j] = (ok && o + j < a.Cout) ? a.w[off + j]
                                          : __float2bfloat16(0.f);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool live = mw * 16 < a.kpad;   // warp-uniform
  const int am = mw * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int ak = (lane >> 4) << 3;
  const int bn = nw * NT * 8 + (lane & 7) + ((lane >> 4) << 3);
  const int bk = ((lane >> 3) & 1) << 3;
  const int nk = (a.Cout + 15) / 16;

  stage(0, 0);
  wgrad::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int slot = kc & 1;
    if (kc + 1 < nk) stage(kc + 1, slot ^ 1);
    wgrad::cp_async_commit();
    wgrad::cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* g_ = sg + slot * grows * kDxStr;
    const __nv_bfloat16* w_ = sw + slot * wrows * kDxStr;
    if (live) {
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) {
        uint32_t af[4], bf[NT][2];
        wgrad::ldmatrix_x4(af, g_ + (tap * a.kpad + am) * kDxStr + ak);
        if (NT == 1) {
          wgrad::ldmatrix_x2(bf[0], w_ + (tap * NC + bn) * kDxStr + bk);
        } else {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t q[4];
            wgrad::ldmatrix_x4(q, w_ + (tap * NC + bn + 16 * p) * kDxStr + bk);
            bf[2 * p][0] = q[0]; bf[2 * p][1] = q[1];
            bf[2 * p + 1][0] = q[2]; bf[2 * p + 1][1] = q[3];
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) wgrad::mma_bf16(acc[n], af, bf[n]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = mw * 16 + g + 8 * half;
    const int pp = k < a.nvox ? dpos[k] : -1;
    if (pp < 0) continue;
    const int od = d0 + (pp >> 20), oh = h0 + ((pp >> 10) & 1023),
              ow = w0 + (pp & 1023);
    if (od >= a.Dc || oh >= a.Hc || ow >= a.Wc) continue;
    __nv_bfloat16* out =
        a.dx + ((((int64_t)b * a.Dc + od) * a.Hc + oh) * a.Wc + ow) * a.Cin;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + nw * NT * 8 + n * 8 + 2 * q + e;
        if (c < a.Cin) out[c] = __float2bfloat16(acc[n][2 * half + e]);
      }
    }
  }
}

// dx of K2: one thread per fine voxel of batch blockIdx.z and CT input
// channels, with the prologue's backward when s is given.
template <int CT>
__global__ void down_dx_kernel(const BwdArgs a) {
  __shared__ float red[kWarps][2 * CT];
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
      red[tid >> 5][c] = ds;
      red[tid >> 5][CT + c] = dt;
    }
  }
  __syncthreads();
  if (tid < 2 * CT) {
    const int row = tid / CT, c = tid % CT;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w][tid];
    a.dpart[(((int64_t)b * gridDim.x + blockIdx.x) * 2 + row) * a.Cin + c0 + c] =
        sum;
  }
}

template <int CT>
cudaError_t launch_down_dx(const BwdArgs& a, cudaStream_t stream) {
  const int nthr = 256;
  const int64_t per_b = (int64_t)a.Df * a.Hf * a.Wf;
  const int64_t nblk = (per_b + nthr - 1) / nthr;
  if (nblk > 0x7fffffff || a.B > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)nblk, (unsigned)(a.Cin / CT), (unsigned)a.B);
  dim3 block(nthr, 1, 1);
  down_dx_kernel<CT><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_down_dx(const BwdArgs& a, cudaStream_t st) {
  if (a.Cin % 16 == 0) return launch_down_dx<16>(a, st);
  if (a.Cin % 8 == 0) return launch_down_dx<8>(a, st);
  if (a.Cin % 4 == 0) return launch_down_dx<4>(a, st);
  if (a.Cin % 2 == 0) return launch_down_dx<2>(a, st);
  return launch_down_dx<1>(a, st);
}

template <int NT>
cudaError_t launch_up_dx(const DxArgs& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        up_dx_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int64_t tiles = (int64_t)a.B * a.tiles_d * a.tiles_h * a.tiles_w;
  const int chunks = (a.Cin + a.nc - 1) / a.nc;
  if (tiles > 0x7fffffff || chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)chunks, 1);
  dim3 block(kThreads, 1, 1);
  up_dx_kernel<NT><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t up_dx(const __nv_bfloat16* gy, const __nv_bfloat16* w,
                  __nv_bfloat16* dx, int B, int D, int H, int W, int Cin,
                  int Cout, const int* plan, cudaStream_t st) {
  DxArgs a;
  a.gy = gy; a.w = w; a.dx = dx;
  a.B = B; a.Dc = D; a.Hc = H; a.Wc = W; a.Cin = Cin; a.Cout = Cout;
  a.td = plan[kDxTd]; a.th = plan[kDxTh]; a.tw = plan[kDxTw];
  a.tiles_d = plan[kDxTilesD]; a.tiles_h = plan[kDxTilesH];
  a.tiles_w = plan[kDxTilesW]; a.nc = plan[kDxNc];
  a.nvox = a.td * a.th * a.tw;
  a.kpad = wgrad::round_up(a.nvox, 16);
  const int smem = dx_smem(a.kpad, a.nc);
  if (a.td <= 0 || a.th <= 0 || a.tw <= 0 || a.kpad > 64 ||
      a.tiles_d * a.td < D || a.tiles_h * a.th < H || a.tiles_w * a.tw < W ||
      smem > 227 * 1024 || 2 * a.td + 1 > 1023 || 2 * a.th + 1 > 1023 ||
      2 * a.tw + 1 > 1023)
    return cudaErrorInvalidValue;
  switch (a.nc) {
    case 16: return launch_up_dx<1>(a, smem, st);
    case 32: return launch_up_dx<2>(a, smem, st);
    case 64: return launch_up_dx<4>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* vaeseg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of K3 (up != 0) or K2. x [B, D, H, W, Cin] is the forward's
// input and gy its output's cotangent ([B, 2D, 2H, 2W, Cout] for K3,
// [B, D/2, H/2, W/2, Cout] for K2). dx (like x) and dk [8, Cin, Cout] with
// db [Cout] may each be null; dk and db are written whole from the
// workspace ws [splits, 8, Cin, Cout] f32 and wsdb [splits, Cout] f64 of
// dk_plan (ops/conv3.py::wgrad_plan, mode 2 for K3, 1 for K2); K3's dx
// follows dx_plan (ops/bridges.py::up_dx_plan). dst [B, 2, Cin] f32 is
// written whole and goes with s and t (K2's prologue) and needs dx, and
// with its workspace dpart [B, ceil(D H W / 256), 2, Cin] f32. Returns the
// first launch error (0 on success).
int vaeseg_bridge_bwd(int up, const void* x, const void* gy, const void* w,
                      const void* s, const void* t, void* dx, void* dk,
                      void* db, void* dst, void* dpart, void* ws, void* wsdb,
                      int B, int D,
                      int H, int W, int Cin, int Cout, const void* dk_plan,
                      const void* dx_plan, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if (!up && (D < 2 || H < 2 || W < 2)) return cudaErrorInvalidValue;
  if ((dk == nullptr) != (db == nullptr)) return cudaErrorInvalidValue;
  if (up && s != nullptr) return cudaErrorInvalidValue;
  if (dx != nullptr && !up && ((s != nullptr) != (dst != nullptr) ||
                                (dst != nullptr) != (dpart != nullptr)))
    return cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    cudaError_t rc;
    if (up) {
      rc = up_dx(gb, static_cast<const __nv_bfloat16*>(w),
                 static_cast<__nv_bfloat16*>(dx), B, D, H, W, Cin, Cout,
                 static_cast<const int*>(dx_plan), st);
    } else {
      BwdArgs a;
      a.x = xb; a.gy = gb;
      a.w = static_cast<const __nv_bfloat16*>(w);
      a.s = static_cast<const float*>(s);
      a.t = static_cast<const float*>(t);
      a.dx = static_cast<__nv_bfloat16*>(dx);
      a.dpart = static_cast<float*>(dpart);
      a.B = B; a.Cin = Cin; a.Cout = Cout;
      a.Dc = D / 2; a.Hc = H / 2; a.Wc = W / 2;
      a.Df = D; a.Hf = H; a.Wf = W;
      rc = dispatch_down_dx(a, st);
      if (rc == cudaSuccess && s != nullptr)
        rc = parts_reduce<float>(a.dpart, static_cast<float*>(dst), B,
                                 (int)((int64_t(D) * H * W + 255) / 256),
                                 2 * Cin, st);
    }
    if (rc != cudaSuccess) return rc;
  }
  if (dk == nullptr) return cudaSuccess;
  const int* p = static_cast<const int*>(dk_plan);
  float* wsf = static_cast<float*>(ws);
  double* wsd = static_cast<double*>(wsdb);
  float* dkf = static_cast<float*>(dk);
  float* dbf = static_cast<float*>(db);
  if (up)   // T = gy on the fine grid, D = x on the coarse grid
    return wgrad::weight_grad<wgrad::kUp>(gb, xb, nullptr, nullptr, wsf, wsd, dkf, dbf,
                              B, 2 * D, 2 * H, 2 * W, Cout, D, H, W, Cin, p,
                              st);
  // T = x on the fine grid through the prologue, D = gy on the coarse grid
  return wgrad::weight_grad<wgrad::kDown>(xb, gb, static_cast<const float*>(s),
                            static_cast<const float*>(t), wsf, wsd, dkf, dbf,
                            B, D, H, W, Cin, D / 2, H / 2, W / 2, Cout, p, st);
}

}  // extern "C"
