// Marching cubes host extension: a copy of vtaco_tpu/native/mc.cpp for
// the PyTorch port, built by vtaco_tpu_torch/native/__init__.py.
//
// Consumes a device-computed occupancy grid and extracts the isosurface
// with shared edge vertices (watertight on closed surfaces). Same cube
// numbering and tables as vtaco_tpu_torch/generate/mc_tables.py (the build
// step generates mc_tables.h from that module so the two implementations
// cannot diverge). C ABI for ctypes.
//
// Performance design (the 513³ MISE grids made the naive scan the
// pipeline bottleneck):
//   * occupancy is packed to 1 bit/vertex in z-major 64-bit words; the
//     cell scan ORs/ANDs four neighboring columns per word and skips 63
//     uniform cells per comparison — the common case for a closed
//     surface in a mostly-empty volume;
//   * shared-edge vertex dedup uses an open-addressing hash (int64 edge
//     key → vertex index) instead of std::unordered_map;
//   * the x-axis can be split into slabs extracted on worker threads;
//     vertices on slab-boundary planes (axis-y/z edges with origin
//     x == slab start) are welded to the previous slab's so the merged
//     mesh has no duplicates. threads=1 reproduces the serial output
//     bit-for-bit.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include "mc_tables.h"  // generated: MC_TRI_TABLE[256][16]

namespace {

constexpr int kEdgeCorners[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0}, {4, 5}, {5, 6},
    {6, 7}, {7, 4}, {0, 4}, {1, 5}, {2, 6}, {3, 7},
};
constexpr int kCornerOffsets[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

struct Result {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

// Open-addressing int64→int32 hash map (linear probing, pow2 capacity).
class EdgeMap {
 public:
  explicit EdgeMap(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    keys_.assign(cap, -1);
    vals_.resize(cap);
    mask_ = cap - 1;
  }
  // Returns the slot's value; if absent, inserts `fresh` and returns -1's
  // complement convention via `found`.
  int32_t* find_or_insert(int64_t key, bool* found) {
    if (size_ * 10 >= keys_.size() * 7) grow();
    size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ULL) & mask_;
    while (true) {
      if (keys_[h] == key) {
        *found = true;
        return &vals_[h];
      }
      if (keys_[h] == -1) {
        keys_[h] = key;
        ++size_;
        *found = false;
        return &vals_[h];
      }
      h = (h + 1) & mask_;
    }
  }
  const int32_t* find(int64_t key) const {
    size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ULL) & mask_;
    while (true) {
      if (keys_[h] == key) return &vals_[h];
      if (keys_[h] == -1) return nullptr;
      h = (h + 1) & mask_;
    }
  }

 private:
  void grow() {
    std::vector<int64_t> ok(std::move(keys_));
    std::vector<int32_t> ov(std::move(vals_));
    keys_.assign(ok.size() * 2, -1);
    vals_.resize(ov.size() * 2);
    mask_ = keys_.size() - 1;
    size_ = 0;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] != -1) {
        bool f;
        *find_or_insert(ok[i], &f) = ov[i];
      }
    }
  }
  std::vector<int64_t> keys_;
  std::vector<int32_t> vals_;
  size_t mask_ = 0;
  size_t size_ = 0;
};

struct SlabOut {
  std::vector<float> verts;
  std::vector<int32_t> faces;                       // local indices
  std::vector<std::pair<int64_t, int32_t>> start_b; // plane x==sx, axis!=0
  std::vector<std::pair<int64_t, int32_t>> end_b;   // plane x==ex, axis!=0
};

struct Ctx {
  const float* vol;  // nullptr in band mode (values come from the band)
  int nx, ny, nz;
  float level;
  const uint64_t* bits;  // (nx * ny) columns × words_z 64-bit words
  int64_t wz;            // words per z-column
  // band mode: flat (C-order) active-vertex bit words + per-word prefix
  // popcounts; vals holds the active vertices' exact f32 in rank order
  const uint64_t* act = nullptr;
  const int64_t* act_rank = nullptr;
  const float* band_vals = nullptr;
};

inline int bit_at(const Ctx& c, int x, int y, int z) {
  const uint64_t* col = c.bits + (static_cast<int64_t>(x) * c.ny + y) * c.wz;
  return (col[z >> 6] >> (z & 63)) & 1;
}

// Extract cells with origin x in [sx, ex).
void extract_slab(const Ctx& c, int sx, int ex, SlabOut* out) {
  const int nx = c.nx, ny = c.ny, nz = c.nz;
  auto val = [&](int x, int y, int z) -> float {
    const int64_t i = (static_cast<int64_t>(x) * ny + y) * nz + z;
    if (c.vol) return c.vol[i];
    // band mode: exact f32 for active vertices (rank/select into the
    // compacted value buffer), sign-correct filler otherwise — only
    // non-crossing cells ever read the filler
    const uint64_t w = c.act[i >> 6];
    if ((w >> (i & 63)) & 1) {
      const int64_t r = c.act_rank[i >> 6] +
          __builtin_popcountll(w & ((1ULL << (i & 63)) - 1));
      return c.band_vals[r];
    }
    return bit_at(c, x, y, z) ? c.level + 1.0f : c.level - 1.0f;
  };

  int edge_axis[12];
  int edge_origin[12][3];
  for (int e = 0; e < 12; ++e) {
    const int* a = kCornerOffsets[kEdgeCorners[e][0]];
    const int* b = kCornerOffsets[kEdgeCorners[e][1]];
    for (int d = 0; d < 3; ++d) {
      edge_origin[e][d] = a[d] < b[d] ? a[d] : b[d];
      if (a[d] != b[d]) edge_axis[e] = d;
    }
  }

  EdgeMap edges(1 << 12);

  auto vertex_for_edge = [&](int cx, int cy, int cz, int e) -> int32_t {
    int ox = cx + edge_origin[e][0];
    int oy = cy + edge_origin[e][1];
    int oz = cz + edge_origin[e][2];
    int axis = edge_axis[e];
    int64_t key = ((static_cast<int64_t>(ox) * ny + oy) * nz + oz) * 3 + axis;
    bool found;
    int32_t* slot = edges.find_or_insert(key, &found);
    if (found) return *slot;

    float p0[3] = {static_cast<float>(ox), static_cast<float>(oy),
                   static_cast<float>(oz)};
    int px = ox + (axis == 0), py = oy + (axis == 1), pz = oz + (axis == 2);
    float v0 = val(ox, oy, oz);
    float v1 = val(px, py, pz);
    float denom = v1 - v0;
    float t = (denom > 1e-12f || denom < -1e-12f)
                  ? (c.level - v0) / denom : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    p0[axis] += t;

    int32_t idx = static_cast<int32_t>(out->verts.size() / 3);
    out->verts.push_back(p0[0]);
    out->verts.push_back(p0[1]);
    out->verts.push_back(p0[2]);
    *slot = idx;
    if (axis != 0) {
      if (ox == sx && sx > 0) out->start_b.emplace_back(key, idx);
      if (ox == ex && ex < nx - 1 + 1) out->end_b.emplace_back(key, idx);
    }
    return idx;
  };

  const int64_t wz = c.wz;
  for (int x = sx; x < ex; ++x) {
    const uint64_t* cx0 = c.bits + (static_cast<int64_t>(x) * ny) * wz;
    const uint64_t* cx1 = c.bits + (static_cast<int64_t>(x + 1) * ny) * wz;
    for (int y = 0; y + 1 < ny; ++y) {
      const uint64_t* c00 = cx0 + static_cast<int64_t>(y) * wz;
      const uint64_t* c01 = cx0 + static_cast<int64_t>(y + 1) * wz;
      const uint64_t* c10 = cx1 + static_cast<int64_t>(y) * wz;
      const uint64_t* c11 = cx1 + static_cast<int64_t>(y + 1) * wz;
      for (int64_t w = 0; w < wz; ++w) {
        uint64_t any = c00[w] | c01[w] | c10[w] | c11[w];
        uint64_t all = c00[w] & c01[w] & c10[w] & c11[w];
        uint64_t any_hi = (w + 1 < wz)
            ? (c00[w + 1] | c01[w + 1] | c10[w + 1] | c11[w + 1]) : 0;
        uint64_t all_hi = (w + 1 < wz)
            ? (c00[w + 1] & c01[w + 1] & c10[w + 1] & c11[w + 1]) : 0;
        // cell at bit b uses corner bits b and b+1
        uint64_t any2 = any | (any >> 1) | (any_hi << 63);
        uint64_t all2 = all & ((all >> 1) | (all_hi << 63));
        uint64_t active = any2 & ~all2;
        if (!active) continue;
        int64_t zbase = w << 6;
        int zmax = static_cast<int>(
            (nz - 1) - zbase < 64 ? (nz - 1) - zbase : 64);
        if (zmax < 64) active &= (1ULL << zmax) - 1;
        while (active) {
          int b = __builtin_ctzll(active);
          active &= active - 1;
          int z = static_cast<int>(zbase) + b;
          int cube = bit_at(c, x, y, z) | (bit_at(c, x + 1, y, z) << 1) |
                     (bit_at(c, x + 1, y + 1, z) << 2) |
                     (bit_at(c, x, y + 1, z) << 3) |
                     (bit_at(c, x, y, z + 1) << 4) |
                     (bit_at(c, x + 1, y, z + 1) << 5) |
                     (bit_at(c, x + 1, y + 1, z + 1) << 6) |
                     (bit_at(c, x, y + 1, z + 1) << 7);
          if (cube == 0 || cube == 255) continue;
          const int16_t* tri = MC_TRI_TABLE[cube];
          for (int t = 0; t < 16 && tri[t] >= 0; t += 3) {
            int32_t i0 = vertex_for_edge(x, y, z, tri[t]);
            int32_t i1 = vertex_for_edge(x, y, z, tri[t + 1]);
            int32_t i2 = vertex_for_edge(x, y, z, tri[t + 2]);
            if (i0 == i1 || i1 == i2 || i0 == i2) continue;
            out->faces.push_back(i0);
            out->faces.push_back(i1);
            out->faces.push_back(i2);
          }
        }
      }
    }
  }
}

// Slab extraction + boundary weld, shared by the volume and band modes.
void run_slabs(const Ctx& ctx, int threads, Result* res) {
  const int ncells_x = ctx.nx - 1;
  std::vector<SlabOut> slabs(threads);
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      int sx = static_cast<int>(static_cast<int64_t>(ncells_x) * t / threads);
      int ex = static_cast<int>(
          static_cast<int64_t>(ncells_x) * (t + 1) / threads);
      if (threads == 1) {
        extract_slab(ctx, sx, ex, &slabs[t]);
      } else {
        pool.emplace_back(extract_slab, std::cref(ctx), sx, ex, &slabs[t]);
      }
    }
    for (auto& th : pool) th.join();
  }

  if (threads == 1) {
    res->verts = std::move(slabs[0].verts);
    res->faces = std::move(slabs[0].faces);
    return;
  }

  // weld: slab s's plane-sx vertices that the previous slab already
  // emitted (its plane-ex list) collapse to the earlier index.
  std::vector<std::pair<int64_t, int32_t>> prev_end;  // key → GLOBAL idx
  for (int s = 0; s < threads; ++s) {
    SlabOut& sl = slabs[s];
    size_t nv = sl.verts.size() / 3;
    std::vector<int32_t> remap(nv, -1);
    if (s > 0 && !prev_end.empty()) {
      EdgeMap prev(prev_end.size());
      for (auto& kv : prev_end) {
        bool f;
        *prev.find_or_insert(kv.first, &f) = kv.second;
      }
      for (auto& kv : sl.start_b) {
        const int32_t* g = prev.find(kv.first);
        if (g) remap[kv.second] = *g;
      }
    }
    for (size_t v = 0; v < nv; ++v) {
      if (remap[v] == -1) {
        remap[v] = static_cast<int32_t>(res->verts.size() / 3);
        res->verts.push_back(sl.verts[3 * v]);
        res->verts.push_back(sl.verts[3 * v + 1]);
        res->verts.push_back(sl.verts[3 * v + 2]);
      }
    }
    for (int32_t f : sl.faces) res->faces.push_back(remap[f]);
    prev_end.clear();
    for (auto& kv : sl.end_b) prev_end.emplace_back(kv.first, remap[kv.second]);
  }
}

Result* mc_run(const float* vol, int nx, int ny, int nz, float level,
               int threads) {
  auto* res = new Result();
  if (nx < 2 || ny < 2 || nz < 2) return res;

  // 1. packed occupancy bits, z-major words per (x, y) column
  const int64_t wz = (nz + 63) >> 6;
  std::vector<uint64_t> bits(static_cast<int64_t>(nx) * ny * wz, 0);
  auto build_bits = [&](int x0, int x1) {
    // the packing pass touches every voxel once; vectorized compare +
    // movemask packs 8 floats/iteration (the scalar shift-or loop was
    // ~6x slower and dominated extraction on big uniform volumes)
    for (int x = x0; x < x1; ++x) {
      for (int y = 0; y < ny; ++y) {
        const float* col = vol + (static_cast<int64_t>(x) * ny + y) * nz;
        uint64_t* w = bits.data() + (static_cast<int64_t>(x) * ny + y) * wz;
        int z = 0;
#ifdef __AVX2__
        const __m256 lv = _mm256_set1_ps(level);
        for (; z + 8 <= nz; z += 8) {
          __m256 v = _mm256_loadu_ps(col + z);
          unsigned m = static_cast<unsigned>(
              _mm256_movemask_ps(_mm256_cmp_ps(v, lv, _CMP_GT_OQ)));
          w[z >> 6] |= static_cast<uint64_t>(m) << (z & 63);
        }
#endif
        for (; z < nz; ++z) {
          w[z >> 6] |= static_cast<uint64_t>(col[z] > level) << (z & 63);
        }
      }
    }
  };

  int ncells_x = nx - 1;
  if (threads < 1) threads = 1;
  if (threads > ncells_x) threads = ncells_x;

  {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      int bx0 = static_cast<int>(static_cast<int64_t>(nx) * t / threads);
      int bx1 = static_cast<int>(static_cast<int64_t>(nx) * (t + 1) / threads);
      if (threads == 1) {
        build_bits(bx0, bx1);
      } else {
        pool.emplace_back(build_bits, bx0, bx1);
      }
    }
    for (auto& th : pool) th.join();
  }
  Ctx ctx{vol, nx, ny, nz, level, bits.data(), wz};
  run_slabs(ctx, threads, res);
  return res;
}

// Marching cubes DIRECTLY on a device band payload (generate/band.py):
// packed occupancy bits + compacted active-vertex values — no (nx³,) f32
// grid reconstruction in between (the 8 MB grid write + re-read was the
// single-object mesh path's largest remaining host cost). Returns
// nullptr on a mask/count mismatch (caller falls back to the
// reconstruct-then-scan path).
Result* mc_run_band(const uint8_t* packed, const float* vals, int64_t count,
                    int nx, int ny, int nz, float level, int threads) {
  if (nx < 2 || ny < 2 || nz < 2) return new Result();
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;

  // flat little-endian bitstream, padded for unaligned 64-bit loads
  std::vector<uint8_t> pad(packed, packed + ((n + 7) >> 3));
  pad.resize(pad.size() + 16, 0);
  auto flat_bits64 = [&](int64_t bitpos) -> uint64_t {
    const int64_t byte = bitpos >> 3;
    const int sh = static_cast<int>(bitpos & 7);
    uint64_t lo;
    std::memcpy(&lo, pad.data() + byte, 8);
    if (!sh) return lo;
    const uint64_t hi = pad[byte + 8];
    return (lo >> sh) | (hi << (64 - sh));
  };

  // occupancy in the scan's column (z-major word) layout
  const int64_t wz = (nz + 63) >> 6;
  std::vector<uint64_t> bits(static_cast<int64_t>(nx) * ny * wz, 0);
  for (int64_t col = 0; col < static_cast<int64_t>(nx) * ny; ++col) {
    uint64_t* w = bits.data() + col * wz;
    const int64_t b0 = col * nz;
    for (int64_t j = 0; j < wz; ++j) {
      uint64_t v = flat_bits64(b0 + (j << 6));
      const int64_t rem = nz - (j << 6);
      if (rem < 64) v &= (1ULL << rem) - 1;
      w[j] = v;
    }
  }

  // active vertices (corners of iso-crossing cells), flat C-order, with
  // per-word prefix popcounts for rank/select into `vals`
  std::vector<uint8_t> occ(n), act8(n, 0);
  for (int64_t i = 0; i < n; ++i) occ[i] = (pad[i >> 3] >> (i & 7)) & 1;
  const int64_t sx_ = static_cast<int64_t>(ny) * nz, sy_ = nz;
  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      const int64_t row = x * sx_ + y * sy_;
      for (int z = 0; z + 1 < nz; ++z) {
        const int64_t o = row + z;
        const uint8_t c0 = occ[o];
        if ((occ[o + 1] ^ c0) | (occ[o + sy_] ^ c0) |
            (occ[o + sy_ + 1] ^ c0) | (occ[o + sx_] ^ c0) |
            (occ[o + sx_ + 1] ^ c0) | (occ[o + sx_ + sy_] ^ c0) |
            (occ[o + sx_ + sy_ + 1] ^ c0)) {
          act8[o] = act8[o + 1] = act8[o + sy_] = act8[o + sy_ + 1] = 1;
          act8[o + sx_] = act8[o + sx_ + 1] = act8[o + sx_ + sy_] =
              act8[o + sx_ + sy_ + 1] = 1;
        }
      }
    }
  }
  const int64_t nw = (n + 63) >> 6;
  std::vector<uint64_t> act(nw, 0);
  std::vector<int64_t> rank(nw, 0);
  int64_t running = 0;
  for (int64_t j = 0; j < nw; ++j) {
    uint64_t w = 0;
    const int64_t base = j << 6;
    const int m = static_cast<int>(n - base < 64 ? n - base : 64);
    for (int b = 0; b < m; ++b) {
      w |= static_cast<uint64_t>(act8[base + b]) << b;
    }
    act[j] = w;
    rank[j] = running;
    running += __builtin_popcountll(w);
  }
  if (running != count) return nullptr;  // payload inconsistent

  int ncells_x = nx - 1;
  if (threads < 1) threads = 1;
  if (threads > ncells_x) threads = ncells_x;
  auto* res = new Result();
  Ctx ctx{nullptr, nx, ny, nz, level, bits.data(), wz,
          act.data(), rank.data(), vals};
  run_slabs(ctx, threads, res);
  return res;
}

}  // namespace

extern "C" {

// Returns an opaque handle; query sizes and copy out, then free.
void* vtaco_mc_run(const float* vol, int nx, int ny, int nz, float level) {
  return mc_run(vol, nx, ny, nz, level, 1);
}

void* vtaco_mc_run_t(const float* vol, int nx, int ny, int nz, float level,
                     int threads) {
  return mc_run(vol, nx, ny, nz, level, threads);
}

// Marching cubes on a band payload; nullptr on mask/count mismatch.
void* vtaco_mc_run_band(const uint8_t* packed, const float* vals,
                        int64_t count, int nx, int ny, int nz, float level,
                        int threads) {
  return mc_run_band(packed, vals, count, nx, ny, nz, level, threads);
}

int64_t vtaco_mc_num_verts(void* handle) {
  return static_cast<Result*>(handle)->verts.size() / 3;
}
int64_t vtaco_mc_num_faces(void* handle) {
  return static_cast<Result*>(handle)->faces.size() / 3;
}
void vtaco_mc_copy(void* handle, float* verts_out, int32_t* faces_out) {
  auto* res = static_cast<Result*>(handle);
  std::memcpy(verts_out, res->verts.data(), res->verts.size() * sizeof(float));
  std::memcpy(faces_out, res->faces.data(), res->faces.size() * sizeof(int32_t));
}
void vtaco_mc_free(void* handle) { delete static_cast<Result*>(handle); }

// Iso-band grid reconstruction (the JAX package's generate/band.py): rebuild
// the full f32 grid from packed occupancy bits (little-endian within each
// byte, C-order flat) plus exact f32 values for "active" vertices (corners
// of iso-crossing cells) in flat scan order. Non-active vertices get
// level ± 1 — marching cubes only reads their sign. Returns the number of
// active vertices implied by the mask (caller checks it equals `count`).
int64_t vtaco_band_reconstruct(const uint8_t* packed, const float* vals,
                               int64_t count, int nx, int ny, int nz,
                               float level, float* out) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  std::vector<uint8_t> occ(n);
  for (int64_t i = 0; i < n; ++i) occ[i] = (packed[i >> 3] >> (i & 7)) & 1;

  std::vector<uint8_t> act(n, 0);
  const int64_t sx = static_cast<int64_t>(ny) * nz, sy = nz, sz = 1;
  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      const int64_t row = x * sx + y * sy;
      for (int z = 0; z + 1 < nz; ++z) {
        const int64_t o = row + z;
        const uint8_t c0 = occ[o];
        // crossing iff any of the other 7 corners differs from corner 0
        if ((occ[o + sz] ^ c0) | (occ[o + sy] ^ c0) |
            (occ[o + sy + sz] ^ c0) | (occ[o + sx] ^ c0) |
            (occ[o + sx + sz] ^ c0) | (occ[o + sx + sy] ^ c0) |
            (occ[o + sx + sy + sz] ^ c0)) {
          act[o] = act[o + sz] = act[o + sy] = act[o + sy + sz] = 1;
          act[o + sx] = act[o + sx + sz] = act[o + sx + sy] =
              act[o + sx + sy + sz] = 1;
        }
      }
    }
  }

  const float hi = level + 1.0f, lo = level - 1.0f;
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (act[i]) {
      out[i] = (k < count) ? vals[k] : (occ[i] ? hi : lo);
      ++k;
    } else {
      out[i] = occ[i] ? hi : lo;
    }
  }
  return k;
}

}  // extern "C"