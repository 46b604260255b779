// Native case loader for the merge.npy data contract (the PyTorch port's
// copy of the JAX package's native/fastloader.cpp, with the same C ABI).
//
// The reference feeds its trainers through 16 forked torch DataLoader
// workers (main_source.py:237); here a C++ thread pool mmaps merge.npy
// cases, splits image/label channels, remaps raw labels to class ids
// (NumpyLoader_Multi_merge semantics, utils/utils.py:366-374), finds the
// class-foreground bounding box and fills caller-provided float32 buffers,
// all off the Python GIL; the same pool runs the separable anti-aliased
// resize. Exposed over a plain C ABI consumed with ctypes
// (vae_segmentation_tpu_torch/data/native_loader.py).
//
// Scope: the npy subset our preprocessing writes — little-endian
// C-contiguous '<i2' / '<f4' / '|i1', v1.0/2.0 headers, shape [D, H, W, 2].
// The caller decides from the header whether a file is in it.
//
// Against the JAX package's copy: int8 cases load (that copy parses them
// and then refuses them), a raw label equal to several entries of the map
// takes the last one and labels compare by value (numpy's remap_labels),
// and the resize's source coordinate is scipy's grid-mode formula
// (o + 0.5) * (n_in / n_out) - 0.5, so nearest-neighbour picks equal
// scipy's at exact ties too.
//
// Built at first use by native_loader.py:
//   $CXX -O3 -std=c++17 -fPIC -shared -pthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cmath>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  size_t data_offset = 0;
  char dtype = 0;        // 'h' int16, 'f' float32, 'b' int8
  size_t elem_size = 0;
  std::vector<size_t> shape;
};

// Minimal .npy header parser (v1.x/2.x, little-endian, C order).
bool parse_npy_header(const unsigned char* buf, size_t len, NpyInfo* out) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    hoff = 10;
  } else {
    hlen = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
           (static_cast<size_t>(buf[11]) << 24);
    hoff = 12;
  }
  if (hoff + hlen > len) return false;
  std::string hdr(reinterpret_cast<const char*>(buf + hoff), hlen);
  if (hdr.find("'fortran_order': False") == std::string::npos) return false;
  size_t dt = hdr.find("'descr':");
  if (dt == std::string::npos) return false;
  size_t q1 = hdr.find('\'', dt + 8);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<i2") { out->dtype = 'h'; out->elem_size = 2; }
  else if (descr == "<f4") { out->dtype = 'f'; out->elem_size = 4; }
  else if (descr == "|i1" || descr == "<i1") { out->dtype = 'b'; out->elem_size = 1; }
  else return false;
  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t p1 = hdr.find('(', sp);
  size_t p2 = hdr.find(')', p1);
  std::string dims = hdr.substr(p1 + 1, p2 - p1 - 1);
  size_t pos = 0;
  out->shape.clear();
  while (pos < dims.size()) {
    while (pos < dims.size() && (dims[pos] == ' ' || dims[pos] == ',')) pos++;
    if (pos >= dims.size()) break;
    out->shape.push_back(std::strtoull(dims.c_str() + pos, nullptr, 10));
    while (pos < dims.size() && dims[pos] != ',') pos++;
  }
  out->data_offset = hoff + hlen;
  return true;
}

struct BBox {
  int64_t lo[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
  int64_t hi[3] = {-1, -1, -1};
  void update(int64_t d, int64_t h, int64_t w) {
    if (d < lo[0]) lo[0] = d;
    if (h < lo[1]) lo[1] = h;
    if (w < lo[2]) lo[2] = w;
    if (d > hi[0]) hi[0] = d;
    if (h > hi[1]) hi[1] = h;
    if (w > hi[2]) hi[2] = w;
  }
  void merge(const BBox& o) {
    for (int i = 0; i < 3; ++i) {
      if (o.lo[i] < lo[i]) lo[i] = o.lo[i];
      if (o.hi[i] > hi[i]) hi[i] = o.hi[i];
    }
  }
};

// One D-slab range of the channel split + label remap + class-foreground
// bbox accumulation. merge layout: [..., 2] channel-last
// (data_process.py:75). The remap inner search is tiny (pan_index maps have
// 1-3 entries); the class>0 branch is rare (sparse foreground). As in
// remap_labels, a later map entry overrides an earlier one, and a raw value
// matches an entry only when it equals it (a float 1.5 is no label 1): the
// search runs backwards and compares in double, exact for every type here.
template <typename T>
void split_and_remap_range(const T* merge, int64_t d0, int64_t d1, int64_t hw,
                           int64_t w, const int32_t* raw_labels,
                           const int32_t* class_ids, int n_map,
                           float* img_out, float* lab_out, BBox* box) {
  for (int64_t d = d0; d < d1; ++d) {
    const T* src = merge + 2 * d * hw;
    float* img = img_out + d * hw;
    float* lab = lab_out + d * hw;
    for (int64_t i = 0; i < hw; ++i) {
      img[i] = static_cast<float>(src[2 * i]);
      const double raw = static_cast<double>(src[2 * i + 1]);
      float cls = 0.0f;
      for (int m = n_map - 1; m >= 0; --m) {
        if (static_cast<double>(raw_labels[m]) == raw) {
          cls = static_cast<float>(class_ids[m]);
          break;
        }
      }
      lab[i] = cls;
      if (cls > 0.0f) box->update(d, i / w, i % w);
    }
  }
}

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> q;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !q.empty(); });
            if (stop && q.empty()) return;
            job = std::move(q.front());
            q.pop();
          }
          job();
        }
      });
  }
  ~Pool() {
    stop = true;
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      q.push(std::move(f));
    }
    cv.notify_one();
  }
};

Pool* g_pool = nullptr;

int default_pool_threads() {
  // same sizing as vaeseg_init_pool's default path: a C-API caller that
  // submits work before calling vaeseg_init_pool still honors
  // VAESEG_LOADER_THREADS instead of silently getting a fixed-4 pool
  if (const char* env = getenv("VAESEG_LOADER_THREADS")) {
    int n = atoi(env);
    if (n > 0) return n;
  }
  return 4;
}

void pool_submit(std::function<void()> f) {
  if (!g_pool) g_pool = new Pool(default_pool_threads());
  g_pool->submit(std::move(f));
}

int pool_size() {
  return g_pool ? static_cast<int>(g_pool->workers.size()) : 1;
}

struct Latch {
  std::mutex mu;
  std::condition_variable cv;
  int remaining;
  explicit Latch(int n) : remaining(n) {}
  void count_down() {
    std::lock_guard<std::mutex> lk(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return remaining == 0; });
  }
};

void pool_submit(std::function<void()> f);
int pool_size();

template <typename T>
void remap_parallel(const T* data, const NpyInfo& info,
                    const int32_t* raw_labels, const int32_t* class_ids,
                    int n_map, float* img_out, float* lab_out,
                    int64_t* bbox_out) {
  const int64_t d_total = static_cast<int64_t>(info.shape[0]);
  const int64_t hw = static_cast<int64_t>(info.shape[1] * info.shape[2]);
  const int64_t w = static_cast<int64_t>(info.shape[2]);
  int chunks = pool_size();
  if (chunks > d_total) chunks = static_cast<int>(d_total);
  if (chunks < 1) chunks = 1;
  std::vector<BBox> boxes(chunks);
  Latch latch(chunks);
  const int64_t per = (d_total + chunks - 1) / chunks;
  for (int c = 0; c < chunks; ++c) {
    const int64_t d0 = c * per;
    const int64_t d1 = std::min(d_total, d0 + per);
    BBox* box = &boxes[c];
    auto job = [=, &latch] {
      if (d0 < d1)
        split_and_remap_range(data, d0, d1, hw, w, raw_labels, class_ids,
                              n_map, img_out, lab_out, box);
      latch.count_down();
    };
    if (chunks == 1)
      job();
    else
      pool_submit(std::move(job));
  }
  latch.wait();
  BBox total;
  for (const auto& b : boxes) total.merge(b);
  if (bbox_out) {
    const bool empty = total.hi[0] < 0;
    for (int i = 0; i < 3; ++i) {
      bbox_out[i] = empty ? -1 : total.lo[i];
      bbox_out[3 + i] = empty ? -1 : total.hi[i];
    }
  }
}

int load_one(const char* path, const int32_t* raw_labels,
             const int32_t* class_ids, int n_map, float* img_out,
             float* lab_out, int64_t* shape_out, int64_t* bbox_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -3;
  NpyInfo info;
  int rc = 0;
  if (!parse_npy_header(static_cast<const unsigned char*>(mem), st.st_size,
                        &info) ||
      info.shape.size() != 4 || info.shape[3] != 2) {
    rc = -4;
  } else if (info.data_offset + info.shape[0] * info.shape[1] *
                 info.shape[2] * 2 * info.elem_size >
             static_cast<size_t>(st.st_size)) {
    rc = -6;  // truncated: fewer data bytes than the header's shape needs
  } else {
    const void* data = static_cast<const char*>(mem) + info.data_offset;
    for (int i = 0; i < 3; ++i) shape_out[i] = info.shape[i];
    if (info.dtype == 'h')
      remap_parallel(static_cast<const int16_t*>(data), info, raw_labels,
                     class_ids, n_map, img_out, lab_out, bbox_out);
    else if (info.dtype == 'f')
      remap_parallel(static_cast<const float*>(data), info, raw_labels,
                     class_ids, n_map, img_out, lab_out, bbox_out);
    else if (info.dtype == 'b')
      remap_parallel(static_cast<const int8_t*>(data), info, raw_labels,
                     class_ids, n_map, img_out, lab_out, bbox_out);
    else
      rc = -5;
  }
  munmap(mem, st.st_size);
  return rc;
}

}  // namespace


// ---------------------------------------------------------------------------
// Separable anti-aliased volume resize (skimage.transform.resize semantics,
// the contract of data/resize.py::resize_volume): per axis, the gaussian
// prefilter (sigma = max(0, (1/f - 1)/2), truncate 4.0, mirror boundary)
// composed with the grid_mode zoom's 2-tap linear resample (src =
// (o + 0.5)/f - 0.5, out-of-grid taps = 0) collapses into ONE combined FIR
// per output position. Weights/indices are precomputed per axis, then each
// pass is a dense small dot product per line, pool-parallel over slabs.
// Gaussian-then-resample along different axes commute (both linear), so
// interleaving per axis equals scipy's filter-all-then-zoom-all to fp noise.
// ---------------------------------------------------------------------------

struct AxisPlan {
  int64_t n_out = 0;
  int taps = 0;                  // weights per output position
  std::vector<int32_t> idx;      // [n_out * taps] source indices
  std::vector<float> wgt;        // [n_out * taps]
};

int64_t mirror_index(int64_t i, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  i = i % period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

void build_axis_plan(int64_t n_in, int64_t n_out, int order, bool anti_alias,
                     AxisPlan* plan) {
  const double f = static_cast<double>(n_out) / static_cast<double>(n_in);
  const double zoom = static_cast<double>(n_in) / static_cast<double>(n_out);
  plan->n_out = n_out;
  double sigma = 0.0;
  if (anti_alias && order != 0 && f < 1.0) sigma = (1.0 / f - 1.0) / 2.0;
  int r = 0;
  std::vector<double> g(1, 1.0);
  if (sigma > 0.0) {
    r = static_cast<int>(4.0 * sigma + 0.5);
    g.assign(2 * r + 1, 0.0);
    double norm = 0.0;
    for (int k = -r; k <= r; ++k) {
      g[k + r] = std::exp(-0.5 * (k / sigma) * (k / sigma));
      norm += g[k + r];
    }
    for (double& v : g) v /= norm;
  }
  const int ltaps = (order == 0) ? 1 : 2;
  plan->taps = ltaps * (2 * r + 1);
  plan->idx.assign(static_cast<size_t>(n_out) * plan->taps, 0);
  plan->wgt.assign(static_cast<size_t>(n_out) * plan->taps, 0.0f);
  for (int64_t o = 0; o < n_out; ++o) {
    const double src = (o + 0.5) * zoom - 0.5;
    int64_t i0;
    double lw[2];
    if (order == 0) {
      i0 = static_cast<int64_t>(std::floor(src + 0.5));
      lw[0] = 1.0;
      lw[1] = 0.0;
    } else {
      i0 = static_cast<int64_t>(std::floor(src));
      const double t = src - i0;
      lw[0] = 1.0 - t;
      lw[1] = t;
    }
    size_t slot = static_cast<size_t>(o) * plan->taps;
    for (int lt = 0; lt < ltaps; ++lt) {
      const int64_t i = i0 + lt;
      // grid-constant: a linear tap outside the grid contributes zero
      // (weights stay 0; indices stay at the safe default 0)
      if (i < 0 || i >= n_in) {
        slot += 2 * r + 1;
        continue;
      }
      for (int k = -r; k <= r; ++k, ++slot) {
        plan->idx[slot] = static_cast<int32_t>(mirror_index(i + k, n_in));
        plan->wgt[slot] = static_cast<float>(lw[lt] * g[k + r]);
      }
    }
  }
}

// Resample axis `axis` of the C-order volume [n0, n1, n2] (sizes BEFORE the
// pass) into `out` (same layout, axis size plan->n_out). Parallel over n0
// slabs (or output rows for axis 0).
void resample_axis(const float* in, int64_t n0, int64_t n1, int64_t n2,
                   int axis, const AxisPlan& plan, float* out) {
  const int taps = plan.taps;
  const int32_t* idx = plan.idx.data();
  const float* wgt = plan.wgt.data();
  const int64_t n_out = plan.n_out;
  int jobs;
  if (axis == 0)
    jobs = static_cast<int>(std::min<int64_t>(n_out, pool_size()));
  else
    jobs = static_cast<int>(std::min<int64_t>(n0, pool_size()));
  if (jobs < 1) jobs = 1;
  Latch latch(jobs);
  for (int j = 0; j < jobs; ++j) {
    const int64_t total = (axis == 0) ? n_out : n0;
    const int64_t per = (total + jobs - 1) / jobs;
    const int64_t b0 = j * per;
    const int64_t b1 = std::min<int64_t>(total, b0 + per);
    pool_submit([=, &latch] {
      if (axis == 0) {
        const int64_t line = n1 * n2;
        for (int64_t o = b0; o < b1; ++o) {
          float* dst = out + o * line;
          std::fill(dst, dst + line, 0.0f);
          for (int k = 0; k < taps; ++k) {
            const float wv = wgt[o * taps + k];
            if (wv == 0.0f) continue;
            const float* src = in + static_cast<int64_t>(idx[o * taps + k])
                               * line;
            for (int64_t i = 0; i < line; ++i) dst[i] += wv * src[i];
          }
        }
      } else if (axis == 1) {
        for (int64_t s = b0; s < b1; ++s) {
          const float* slab = in + s * n1 * n2;
          float* dslab = out + s * n_out * n2;
          for (int64_t o = 0; o < n_out; ++o) {
            float* dst = dslab + o * n2;
            std::fill(dst, dst + n2, 0.0f);
            for (int k = 0; k < taps; ++k) {
              const float wv = wgt[o * taps + k];
              if (wv == 0.0f) continue;
              const float* src = slab
                  + static_cast<int64_t>(idx[o * taps + k]) * n2;
              for (int64_t i = 0; i < n2; ++i) dst[i] += wv * src[i];
            }
          }
        }
      } else {
        for (int64_t s = b0; s < b1; ++s) {
          for (int64_t r0 = 0; r0 < n1; ++r0) {
            const float* src = in + (s * n1 + r0) * n2;
            float* dst = out + (s * n1 + r0) * n_out;
            for (int64_t o = 0; o < n_out; ++o) {
              float acc = 0.0f;
              for (int k = 0; k < taps; ++k)
                acc += wgt[o * taps + k] * src[idx[o * taps + k]];
              dst[o] = acc;
            }
          }
        }
      }
      latch.count_down();
    });
  }
  latch.wait();
}


extern "C" {

void vaeseg_init_pool(int n_threads) {
  if (!g_pool) g_pool = new Pool(n_threads > 0 ? n_threads : 4);
}


// Anti-aliased separable resize: in [d, h, w] f32 C-order -> out
// [od, oh, ow]. order: 0 nearest (labels) / 1 linear (+ gaussian
// anti-aliasing on downscaled axes when anti_alias). Pool-parallel.
int vaeseg_resize_volume(const float* in, const int64_t* in_shape,
                         float* out, const int64_t* out_shape,
                         int order, int anti_alias) {
  if (!g_pool) vaeseg_init_pool(0);
  const int64_t d = in_shape[0], h = in_shape[1], w = in_shape[2];
  const int64_t od = out_shape[0], oh = out_shape[1], ow = out_shape[2];
  if (d <= 0 || h <= 0 || w <= 0 || od <= 0 || oh <= 0 || ow <= 0) return -1;
  AxisPlan pd, ph, pw;
  build_axis_plan(d, od, order, anti_alias, &pd);
  build_axis_plan(h, oh, order, anti_alias, &ph);
  build_axis_plan(w, ow, order, anti_alias, &pw);
  std::vector<float> buf1(static_cast<size_t>(od) * h * w);
  std::vector<float> buf2(static_cast<size_t>(od) * oh * w);
  resample_axis(in, d, h, w, 0, pd, buf1.data());
  resample_axis(buf1.data(), od, h, w, 1, ph, buf2.data());
  resample_axis(buf2.data(), od, oh, w, 2, pw, out);
  return 0;
}

// Peek a case's volume shape (so the caller can size buffers).
int vaeseg_case_shape(const char* path, int64_t* shape_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  unsigned char head[4096];
  ssize_t n = read(fd, head, sizeof(head));
  close(fd);
  NpyInfo info;
  if (n <= 0 || !parse_npy_header(head, static_cast<size_t>(n), &info) ||
      info.shape.size() != 4)
    return -4;
  for (int i = 0; i < 3; ++i) shape_out[i] = static_cast<int64_t>(info.shape[i]);
  return 0;
}

// Synchronous single-case load (image/label split + label remap),
// chunk-parallel over the pool.
int vaeseg_load_case(const char* path, const int32_t* raw_labels,
                     const int32_t* class_ids, int n_map, float* img_out,
                     float* lab_out, int64_t* shape_out) {
  return load_one(path, raw_labels, class_ids, n_map, img_out, lab_out,
                  shape_out, nullptr);
}

// As above, also writing the class-foreground bounding box
// [dmin,hmin,wmin,dmax,hmax,wmax] (-1s when empty) — computed in the same
// pass, so CropResize needs no separate argwhere sweep.
int vaeseg_load_case_bbox(const char* path, const int32_t* raw_labels,
                          const int32_t* class_ids, int n_map,
                          float* img_out, float* lab_out, int64_t* shape_out,
                          int64_t* bbox_out) {
  return load_one(path, raw_labels, class_ids, n_map, img_out, lab_out,
                  shape_out, bbox_out);
}

}  // extern "C"
