// Host geometry extension: KD-tree nearest neighbor, exact generalized
// winding numbers, OFF/OBJ mesh reading, lattice encoding. A copy of
// vtaco_tpu/native/geom.cpp for the PyTorch port, built by
// vtaco_tpu_torch/native/__init__.py.
//
// Replacements for the reference's native host dependencies: pykdtree
// (chamfer KD-tree, src/common.py:94-140), libigl
// fast_winding_number_for_meshes (occupancy labels,
// src/conv_onet/training.py:723) and igl.read_triangle_mesh
// (train.py:170). The hot-path winding numbers run on the device
// (ops/winding.py); this host version serves input-pipeline precompute and
// host-side verification. C ABI for ctypes.
//
// The window sort (vtaco_window_keys_sort, vtaco_window_permute) is kept
// with the copy but not bound: the port sorts on the card.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// KD-tree (3D), median-split over an index permutation.

struct KDTree {
  std::vector<float> pts;   // n*3 (caller order)
  std::vector<int32_t> id;  // permutation arranged as an implicit tree
  int64_t n = 0;
};

void kd_build(KDTree& kd, int64_t lo, int64_t hi, int depth) {
  if (hi - lo <= 1) return;
  int64_t mid = (lo + hi) / 2;
  int ax = depth % 3;
  std::nth_element(
      kd.id.begin() + lo, kd.id.begin() + mid, kd.id.begin() + hi,
      [&](int32_t a, int32_t b) { return kd.pts[3 * a + ax] < kd.pts[3 * b + ax]; });
  kd_build(kd, lo, mid, depth + 1);
  kd_build(kd, mid + 1, hi, depth + 1);
}

inline float dist2(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

void kd_query(const KDTree& kd, const float* q, int64_t lo, int64_t hi,
              int depth, float& best_d2, int32_t& best_i) {
  if (lo >= hi) return;
  int64_t mid = (lo + hi) / 2;
  const float* p = &kd.pts[3 * kd.id[mid]];
  float d2 = dist2(p, q);
  if (d2 < best_d2) {
    best_d2 = d2;
    best_i = kd.id[mid];
  }
  int ax = depth % 3;
  float diff = q[ax] - p[ax];
  if (diff < 0) {
    kd_query(kd, q, lo, mid, depth + 1, best_d2, best_i);
    if (diff * diff < best_d2)
      kd_query(kd, q, mid + 1, hi, depth + 1, best_d2, best_i);
  } else {
    kd_query(kd, q, mid + 1, hi, depth + 1, best_d2, best_i);
    if (diff * diff < best_d2)
      kd_query(kd, q, lo, mid, depth + 1, best_d2, best_i);
  }
}

// ---------------------------------------------------------------------------
// Mesh container for the reader.

struct Mesh {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

}  // namespace

extern "C" {

// --- KD-tree ---------------------------------------------------------------

void* vtaco_kdtree_build(const float* pts, int64_t n) {
  auto* kd = new KDTree();
  kd->n = n;
  kd->pts.assign(pts, pts + 3 * n);
  kd->id.resize(n);
  for (int64_t i = 0; i < n; ++i) kd->id[i] = static_cast<int32_t>(i);
  kd_build(*kd, 0, n, 0);
  return kd;
}

// Nearest neighbor for each of m queries: squared distance + index.
void vtaco_kdtree_query(void* handle, const float* q, int64_t m,
                        float* out_d2, int32_t* out_idx) {
  auto* kd = static_cast<KDTree*>(handle);
  for (int64_t i = 0; i < m; ++i) {
    float best_d2 = INFINITY;
    int32_t best_i = -1;
    kd_query(*kd, q + 3 * i, 0, kd->n, 0, best_d2, best_i);
    out_d2[i] = best_d2;
    out_idx[i] = best_i;
  }
}

void vtaco_kdtree_free(void* handle) { delete static_cast<KDTree*>(handle); }

// --- Exact generalized winding numbers --------------------------------------
// Van Oosterom & Strackee triangle solid angles, double accumulation.
// Matches ops/winding.py (≈1 inside, ≈0 outside; igl convention).

void vtaco_winding(const float* verts, int64_t nv, const int32_t* faces,
                   int64_t nf, const float* q, int64_t nq, float* out) {
  for (int64_t p = 0; p < nq; ++p) {
    const double qx = q[3 * p], qy = q[3 * p + 1], qz = q[3 * p + 2];
    double acc = 0.0;
    for (int64_t f = 0; f < nf; ++f) {
      const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                    i2 = faces[3 * f + 2];
      // malformed meshes must not read out of bounds; a skipped face
      // contributes zero solid angle (same as padding triangles)
      if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= nv || i1 >= nv || i2 >= nv)
        continue;
      const float* v0 = verts + 3 * i0;
      const float* v1 = verts + 3 * i1;
      const float* v2 = verts + 3 * i2;
      const double ax = v0[0] - qx, ay = v0[1] - qy, az = v0[2] - qz;
      const double bx = v1[0] - qx, by = v1[1] - qy, bz = v1[2] - qz;
      const double cx = v2[0] - qx, cy = v2[1] - qy, cz = v2[2] - qz;
      const double la = std::sqrt(ax * ax + ay * ay + az * az);
      const double lb = std::sqrt(bx * bx + by * by + bz * bz);
      const double lc = std::sqrt(cx * cx + cy * cy + cz * cz);
      const double det = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz) +
                         az * (bx * cy - by * cx);
      const double denom = la * lb * lc + (ax * bx + ay * by + az * bz) * lc +
                           (bx * cx + by * cy + bz * cz) * la +
                           (cx * ax + cy * ay + cz * az) * lb;
      acc += 2.0 * std::atan2(det, denom);
    }
    out[p] = static_cast<float>(acc / (4.0 * M_PI));
  }
}

// --- OFF/OBJ triangle-mesh reader -------------------------------------------

void* vtaco_read_mesh(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (std::fread(&buf[0], 1, size, fp) != static_cast<size_t>(size)) {
    std::fclose(fp);
    return nullptr;
  }
  std::fclose(fp);

  auto* mesh = new Mesh();
  const char* s = buf.c_str();
  const char* end = s + buf.size();

  auto skip_ws_comments = [&](const char* p) {
    for (;;) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
        ++p;
      if (p < end && *p == '#') {
        while (p < end && *p != '\n') ++p;
        continue;
      }
      return p;
    }
  };

  const char* p = skip_ws_comments(s);
  bool is_off = (end - p >= 3 && std::strncmp(p, "OFF", 3) == 0);

  if (is_off) {
    p += 3;
    char* next = nullptr;
    p = skip_ws_comments(p);
    long nv = std::strtol(p, &next, 10);
    p = skip_ws_comments(next);
    long nf = std::strtol(p, &next, 10);
    p = skip_ws_comments(next);
    std::strtol(p, &next, 10);  // edge count, ignored
    p = next;
    mesh->verts.reserve(3 * nv);
    for (long i = 0; i < 3 * nv; ++i) {
      // comments are legal anywhere in an OFF body; a raw strtof on a '#'
      // would return 0 without advancing and desync the whole parse
      p = skip_ws_comments(p);
      mesh->verts.push_back(std::strtof(p, &next));
      p = next;
    }
    mesh->faces.reserve(3 * nf);
    for (long i = 0; i < nf; ++i) {
      p = skip_ws_comments(p);
      long k = std::strtol(p, &next, 10);  // verts per face
      p = next;
      std::vector<long> poly(k);
      for (long j = 0; j < k; ++j) {
        p = skip_ws_comments(p);
        poly[j] = std::strtol(p, &next, 10);
        p = next;
      }
      for (long j = 2; j < k; ++j) {  // fan-triangulate
        mesh->faces.push_back(static_cast<int32_t>(poly[0]));
        mesh->faces.push_back(static_cast<int32_t>(poly[j - 1]));
        mesh->faces.push_back(static_cast<int32_t>(poly[j]));
      }
    }
  } else {
    // OBJ: v / f lines; f indices may be v, v/t, v/t/n, v//n and negative.
    while (p < end) {
      const char* line_end = p;
      while (line_end < end && *line_end != '\n') ++line_end;
      if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
        char* next = nullptr;
        const char* c = p + 1;
        for (int i = 0; i < 3; ++i) {
          mesh->verts.push_back(std::strtof(c, &next));
          c = next;
        }
      } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
        std::vector<long> poly;
        const char* c = p + 1;
        while (c < line_end) {
          while (c < line_end && (*c == ' ' || *c == '\t')) ++c;
          if (c >= line_end) break;
          char* next = nullptr;
          long v = std::strtol(c, &next, 10);
          if (next == c) break;
          c = next;
          while (c < line_end && *c != ' ' && *c != '\t') ++c;  // skip /t/n
          long nvs = static_cast<long>(mesh->verts.size() / 3);
          poly.push_back(v > 0 ? v - 1 : nvs + v);  // 1-based / negative
        }
        for (size_t j = 2; j < poly.size(); ++j) {
          mesh->faces.push_back(static_cast<int32_t>(poly[0]));
          mesh->faces.push_back(static_cast<int32_t>(poly[j - 1]));
          mesh->faces.push_back(static_cast<int32_t>(poly[j]));
        }
      }
      p = line_end + 1;
    }
  }
  return mesh;
}

int64_t vtaco_mesh_num_verts(void* handle) {
  return static_cast<Mesh*>(handle)->verts.size() / 3;
}
int64_t vtaco_mesh_num_faces(void* handle) {
  return static_cast<Mesh*>(handle)->faces.size() / 3;
}
void vtaco_mesh_copy(void* handle, float* verts_out, int32_t* faces_out) {
  auto* m = static_cast<Mesh*>(handle);
  std::memcpy(verts_out, m->verts.data(), m->verts.size() * sizeof(float));
  std::memcpy(faces_out, m->faces.data(), m->faces.size() * sizeof(int32_t));
}
void vtaco_mesh_free(void* handle) { delete static_cast<Mesh*>(handle); }

// ---------------------------------------------------------------------------
// Lattice encoding for the scattered decode's compact coordinate upload
// (generator.eval_points_fast): one fused pass turning (n, 3) f32 world
// coords into the decode program's transposed (3, npad) integer lattice
// layout, w = rint((p/box + 0.5) * R). Writes uint8 when is8 (R <= 255)
// else int16. Returns the max |w - rint(w)| residual in lattice units —
// the caller rejects the encoding (and falls back to f32 coords) above
// its tolerance; coords outside [0, R] poison the residual. Fused
// convert+verify+transpose keeps the host cost one memory pass where the
// equivalent numpy takes four 25 MB passes.
float vtaco_lattice_encode(const float* p, int64_t n, float box, float R,
                           void* out, int64_t npad, int is8) {
  const float inv = R / box;
  const float half = 0.5f * R;
  float maxr = 0.0f;
  uint8_t* o8 = static_cast<uint8_t*>(out);
  int16_t* o16 = static_cast<int16_t*>(out);
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      float w = p[3 * i + d] * inv + half;
      float r = std::nearbyint(w);
      float res = std::fabs(w - r);
      // negated in-range form: NaN/inf coords fail the comparison and
      // poison the residual instead of slipping through (NaN > x is
      // false for every x, so the plain res>tol check alone would pass)
      if (!(r >= 0.0f && r <= R)) {
        res = 1e9f;
        r = 0.0f;  // keep the int cast defined; caller discards on reject
      }
      if (res > maxr) maxr = res;
      if (is8) {
        o8[d * npad + i] = static_cast<uint8_t>(r);
      } else {
        o16[d * npad + i] = static_cast<int16_t>(r);
      }
    }
  }
  return maxr;
}

// ---------------------------------------------------------------------------
// Sorted windowed scatter decode, host side (generator._try_window_scatter):
// counting-sort (n, 3) f32 world coords by super-cell key so each kernel
// tile's points span one VMEM window of the packed feature volume. The
// key math replicates ops.dense_decode.supercell_keys in f32 EXACTLY —
// div/add/mul/floor/min/max only, no mul+add chains, so -ffp-contract
// cannot alter results and host keys == device keys bit-for-bit. numpy's
// argsort(kind='stable') + fancy-index permutes cost ~330 ms at 2.1M
// points on one core; these two passes run in ~40 ms.

// keys_sorted/order out: (n,). Returns n1, or -1 when any key falls
// outside [0, n1^3) (non-finite coords — caller falls back).
// box / box_eps arrive PRE-FOLDED from the caller (numpy f64 → f32):
// composing 1.0f + padding + 1e-3f in f32 here lands 1 ulp away from
// the f64-folded constant numpy/XLA use, which flips borderline floors
// (~9 points in 2.1M observed) and breaks the host==device key contract.
int vtaco_window_keys_sort(const float* p, int64_t n, int reso, int L,
                           float box, float box_eps, int quant,
                           int32_t* keys_sorted, int32_t* order) {
  const int n1 = (reso - 2 + L) / L;  // ceil((reso-1)/L)
  const int64_t nsup = (int64_t)n1 * n1 * n1;
  const float wmax = (float)(reso - 1);
  std::vector<int32_t> keys(n);
  std::vector<int64_t> cnt(nsup + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t s[3];
    for (int d = 0; d < 3; ++d) {
      float v = p[3 * i + d];
      if (quant) {
        float u = v / box + 0.5f;
        u = std::min(std::max(u, 0.0f), 1.0f);
        float qf = std::nearbyint(u * 65535.0f);
        v = box * (qf / 65535.0f - 0.5f);
      }
      float u = v / box_eps + 0.5f;
      u = (u >= 1.0f) ? (1.0f - 10e-4f) : std::max(u, 0.0f);
      float x = std::min(std::max(u * wmax, 0.0f), wmax);
      float x0f = std::floor(x);
      if (!(x0f >= 0.0f && x0f <= wmax)) return -1;  // NaN/inf coord
      int32_t x0 = std::min((int32_t)x0f, reso - 2);
      s[d] = x0 / L;
    }
    keys[i] = s[0] + n1 * (s[1] + n1 * s[2]);
    ++cnt[keys[i] + 1];
  }
  for (int64_t k = 0; k < nsup; ++k) cnt[k + 1] += cnt[k];
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = cnt[keys[i]]++;
    order[pos] = (int32_t)i;
    keys_sorted[pos] = keys[i];
  }
  return n1;
}

// Permute (n, 3) f32 coords into the decode dispatch's (3, npad) sorted
// channels-first layout (f32, or uint16 quantized when quant); pad
// columns repeat the last real point (keeps padding inside the last
// tile's window and the int8 logit scale honest).
void vtaco_window_permute(const float* p, int64_t n, const int32_t* order,
                          int64_t npad, int quant, float box,
                          void* out) {
  float* of = static_cast<float*>(out);
  uint16_t* oq = static_cast<uint16_t*>(out);
  for (int64_t i = 0; i < n; ++i) {
    const float* src = p + 3 * (int64_t)order[i];
    for (int d = 0; d < 3; ++d) {
      if (quant) {
        float u = src[d] / box + 0.5f;
        u = std::min(std::max(u, 0.0f), 1.0f);
        oq[d * npad + i] = (uint16_t)std::nearbyint(u * 65535.0f);
      } else {
        of[d * npad + i] = src[d];
      }
    }
  }
  for (int64_t i = n; i < npad; ++i) {
    for (int d = 0; d < 3; ++d) {
      if (quant) {
        oq[d * npad + i] = oq[d * npad + n - 1];
      } else {
        of[d * npad + i] = of[d * npad + n - 1];
      }
    }
  }
}

}  // extern "C"
