// MISE active-voxel refinement bookkeeping (host side): a copy of
// vtaco_tpu/native/mise.cpp for the PyTorch port, built by
// vtaco_tpu_torch/native/__init__.py.
//
// The engine behind generate/mise.py MultiGridExtractorNative, with the
// protocol of MultiGridExtractorNumpy (the reference's MultiGridExtractor,
// src/utils/mesh.py:7-84): query() -> lattice points needing evaluation,
// update(points, values) -> record + refresh voxel activity,
// increase_resolution() -> double the grid keeping known values.
//
// Why native: the numpy protocol's full-grid passes (np.repeat upsample
// in float64, boundary slicing) are several passes over the whole grid
// per level; here each is one cache-friendly sweep in float32.
//
// Why the block pool: glibc returns every allocation above ~32 MB to the
// OS on free, so a grid reallocated per level (67 MB at 256^3) would fault
// its pages in again at every level of every object, and fresh pages cost
// far more than recycled warm ones. The pool recycles blocks process-wide
// and never returns them to the OS; sizes are highly repetitive ((R+1)^3
// for a handful of R), so what it keeps is bounded by a flight's working
// set.
//
// Grid conventions match the numpy class exactly: values/known are
// (R+1)^3 C-order arrays indexed (i0, i1, i2) with i2 fastest;
// voxel_active is R^3; query() emits points in C-order lexicographic
// order (numpy.where order), so value streams can be replayed through
// either implementation interchangeably (values are stored f32; every
// value the protocol ever holds is an f32 decode output or a copy of
// one, so the f64-numpy and f32-native grids are bit-identical).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

struct Pool {
  std::unordered_map<size_t, std::vector<void*>> free_;
  std::mutex mu_;

  void* get(size_t bytes) {
    if (!bytes) return nullptr;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = free_.find(bytes);
      if (it != free_.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        return p;
      }
    }
    return ::operator new(bytes);
  }
  void put(void* p, size_t bytes) {
    if (!p) return;
    std::lock_guard<std::mutex> lk(mu_);
    free_[bytes].push_back(p);
  }
};

Pool g_pool;

template <typename T>
struct Buf {
  T* p = nullptr;
  size_t n = 0;

  void resize_discard(size_t n_) {  // contents not preserved
    if (n == n_) return;
    g_pool.put(p, n * sizeof(T));
    n = n_;
    p = (T*)g_pool.get(n * sizeof(T));
  }
  void assign(size_t n_, T v) {
    resize_discard(n_);
    std::fill(p, p + n, v);
  }
  void swap(Buf& o) {
    std::swap(p, o.p);
    std::swap(n, o.n);
  }
  T& operator[](size_t i) { return p[i]; }
  const T& operator[](size_t i) const { return p[i]; }
  T* data() { return p; }
  const T* data() const { return p; }
  size_t size() const { return n; }
  ~Buf() { g_pool.put(p, n * sizeof(T)); }
};

struct Mise {
  int64_t reso;
  float threshold;
  bool invert;
  Buf<float> values;          // (R+1)^3
  Buf<uint8_t> known;         // (R+1)^3
  Buf<uint8_t> voxel_active;  // R^3
  Buf<uint8_t> occ_scratch;   // (R+1)^3, reused across update() calls
  Buf<uint8_t> va_scratch;    // (R+1)^3, reused across query() calls
  Buf<float> values_tmp;      // upsample ping-pong
  Buf<uint8_t> bytes_tmp;     // upsample ping-pong (known / voxel_active)
  std::vector<int32_t> qpts;  // cached query() result, (n, 3)
  bool q_valid = false;
  // update() defers recompute_active(): the mask is only consumed by
  // query() and increase_resolution(), so the final level's full-grid
  // occupancy+voxel pass (the largest of the flight, ~1 GB of traffic
  // at 513^3) is skipped entirely when the caller only reads values.
  bool active_dirty = false;

  int64_t n1() const { return reso + 1; }

  inline uint8_t occ(float v) const {
    return invert ? (v < threshold) : (v >= threshold);
  }

  // voxel_active = "corner occupancies disagree" (surface-possible voxel),
  // recomputed from the current values grid — mise.py update()'s
  // `voxel_active = ~voxel_empty`.
  void recompute_active() {
    const int64_t n = n1(), R = reso;
    occ_scratch.resize_discard((size_t)(n * n * n));
    uint8_t* o = occ_scratch.data();
    const size_t total = (size_t)(n * n * n);
    for (size_t i = 0; i < total; ++i) o[i] = occ(values[i]);
    voxel_active.resize_discard((size_t)(R * R * R));
    for (int64_t a = 0; a < R; ++a)
      for (int64_t b = 0; b < R; ++b) {
        const uint8_t* r00 = &o[(a * n + b) * n];
        const uint8_t* r01 = r00 + n;       // b+1
        const uint8_t* r10 = r00 + n * n;   // a+1
        const uint8_t* r11 = r10 + n;
        uint8_t* out = &voxel_active[(a * R + b) * R];
        for (int64_t c = 0; c < R; ++c) {
          unsigned s = r00[c] + r00[c + 1] + r01[c] + r01[c + 1] +
                       r10[c] + r10[c + 1] + r11[c] + r11[c + 1];
          out[c] = (s != 0u && s != 8u);
        }
      }
    q_valid = false;
  }

  void flush_active() {
    if (active_dirty) {
      recompute_active();
      active_dirty = false;
    }
  }

  // query = points with ~known & value_active (corner adjacent to any
  // active voxel), in numpy.where (C-order lexicographic) order.
  void compute_query() {
    flush_active();
    if (q_valid) return;
    const int64_t n = n1(), R = reso;
    va_scratch.assign((size_t)(n * n * n), 0);
    uint8_t* va = va_scratch.data();
    for (int64_t a = 0; a < R; ++a)
      for (int64_t b = 0; b < R; ++b) {
        const uint8_t* act = &voxel_active[(a * R + b) * R];
        for (int d = 0; d < 4; ++d) {
          uint8_t* row = &va[((a + (d >> 1)) * n + (b + (d & 1))) * n];
          for (int64_t c = 0; c < R; ++c)
            if (act[c]) { row[c] = 1; row[c + 1] = 1; }
        }
      }
    qpts.clear();
    size_t p = 0;
    for (int64_t a = 0; a < n; ++a)
      for (int64_t b = 0; b < n; ++b)
        for (int64_t c = 0; c < n; ++c, ++p)
          if (va[p] && !known[p]) {
            qpts.push_back((int32_t)a);
            qpts.push_back((int32_t)b);
            qpts.push_back((int32_t)c);
          }
    q_valid = true;
  }

  void update(const int32_t* pts, const float* vals, int64_t m) {
    const int64_t n = n1();
    for (int64_t i = 0; i < m; ++i) {
      size_t idx = ((size_t)pts[3 * i] * n + pts[3 * i + 1]) * n +
                   pts[3 * i + 2];
      values[idx] = vals[i];
      known[idx] = 1;
    }
    active_dirty = true;
    q_valid = false;
  }

  // update the cached query points in query order (skips re-passing pts)
  void update_queried(const float* vals) {
    compute_query();
    update(qpts.data(), vals, (int64_t)(qpts.size() / 3));
  }

  void increase_resolution() {
    flush_active();  // the stale mask must not be upsampled
    const int64_t n_old = n1(), R_old = reso;
    reso *= 2;
    const int64_t n_new = n1(), R_new = reso;
    // values: nearest upsample, out[i] = in[i >> 1] per axis
    values_tmp.resize_discard((size_t)(n_new * n_new * n_new));
    for (int64_t a = 0; a < n_new; ++a) {
      const float* plane = &values[(a >> 1) * n_old * n_old];
      for (int64_t b = 0; b < n_new; ++b) {
        const float* src = plane + (b >> 1) * n_old;
        float* dst = &values_tmp[(a * n_new + b) * n_new];
        int64_t c = 0;
        for (; c + 1 < n_new; c += 2) {
          float v = src[c >> 1];
          dst[c] = v;
          dst[c + 1] = v;
        }
        if (c < n_new) dst[c] = src[c >> 1];
      }
    }
    values.swap(values_tmp);
    // known: known2[2i, 2j, 2k] = known[i, j, k], else false
    bytes_tmp.assign((size_t)(n_new * n_new * n_new), 0);
    for (int64_t a = 0; a < n_old; ++a)
      for (int64_t b = 0; b < n_old; ++b) {
        const uint8_t* src = &known[(a * n_old + b) * n_old];
        uint8_t* dst = &bytes_tmp[((2 * a) * n_new + 2 * b) * n_new];
        for (int64_t c = 0; c < n_old; ++c) dst[2 * c] = src[c];
      }
    known.swap(bytes_tmp);
    // voxel_active: nearest upsample R_old^3 -> R_new^3
    bytes_tmp.resize_discard((size_t)(R_new * R_new * R_new));
    for (int64_t a = 0; a < R_new; ++a) {
      const uint8_t* plane = &voxel_active[(a >> 1) * R_old * R_old];
      for (int64_t b = 0; b < R_new; ++b) {
        const uint8_t* src = plane + (b >> 1) * R_old;
        uint8_t* dst = &bytes_tmp[(a * R_new + b) * R_new];
        for (int64_t c = 0; c < R_new; c += 2) {
          uint8_t v = src[c >> 1];
          dst[c] = v;
          dst[c + 1] = v;
        }
      }
    }
    voxel_active.swap(bytes_tmp);
    q_valid = false;
  }
};

}  // namespace

extern "C" {

void* vtaco_mise_new(int64_t reso0, float threshold, int invert) {
  Mise* m = new Mise;
  m->reso = reso0;
  m->threshold = threshold;
  m->invert = invert != 0;
  const int64_t n = reso0 + 1;
  m->values.assign((size_t)(n * n * n), 0.0f);
  m->known.assign((size_t)(n * n * n), 0);
  m->voxel_active.assign((size_t)(reso0 * reso0 * reso0), 1);
  return m;
}

void vtaco_mise_free(void* h) { delete (Mise*)h; }

int64_t vtaco_mise_resolution(void* h) { return ((Mise*)h)->reso; }

int64_t vtaco_mise_query_count(void* h) {
  Mise* m = (Mise*)h;
  m->compute_query();
  return (int64_t)(m->qpts.size() / 3);
}

// out: (n, 3) int32, n from vtaco_mise_query_count
void vtaco_mise_query_copy(void* h, int32_t* out) {
  Mise* m = (Mise*)h;
  m->compute_query();
  std::memcpy(out, m->qpts.data(), m->qpts.size() * sizeof(int32_t));
}

// out: (3, npad) int16 channels-first layout for the scattered decoder;
// pad columns repeat the last real point (int8-quantization-safe padding,
// generator.decode_points_batched contract). Returns the real count.
int64_t vtaco_mise_query_copy_cn(void* h, int16_t* out, int64_t npad) {
  Mise* m = (Mise*)h;
  m->compute_query();
  const int64_t n = (int64_t)(m->qpts.size() / 3);
  const int64_t k = n < npad ? n : npad;
  for (int ax = 0; ax < 3; ++ax) {
    int16_t* dst = out + ax * npad;
    const int32_t* src = m->qpts.data() + ax;
    for (int64_t i = 0; i < k; ++i) dst[i] = (int16_t)src[3 * i];
    const int16_t last = k ? dst[k - 1] : 0;
    for (int64_t i = k; i < npad; ++i) dst[i] = last;
  }
  return n;
}

void vtaco_mise_update(void* h, const int32_t* pts, const float* vals,
                       int64_t n) {
  ((Mise*)h)->update(pts, vals, n);
}

void vtaco_mise_update_queried(void* h, const float* vals) {
  ((Mise*)h)->update_queried(vals);
}

void vtaco_mise_increase(void* h) { ((Mise*)h)->increase_resolution(); }

// out: (R+1)^3 float32
void vtaco_mise_values(void* h, float* out) {
  Mise* m = (Mise*)h;
  std::memcpy(out, m->values.data(), m->values.size() * sizeof(float));
}

// Zero-copy view of the engine's value grid ((R+1)^3 f32, C-order).
// Valid until the next increase_resolution()/free on this handle; the
// Python wrapper pins the extractor alive for the view's lifetime.
const float* vtaco_mise_values_ptr(void* h) {
  return ((Mise*)h)->values.data();
}

// out: (R+1)^3 uint8 (0/1)
void vtaco_mise_known(void* h, uint8_t* out) {
  Mise* m = (Mise*)h;
  std::memcpy(out, m->known.data(), m->known.size());
}

}  // extern "C"
