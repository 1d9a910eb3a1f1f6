// Scattered-point occupancy decode for Hopper (sm_90a): trilinear
// interpolation of the feature grid AND the decoder trunk in one kernel,
// replacing the two branches of fused_trunk_window_cn in
// vtaco_tpu/ops/pallas/decode.py:
//   MODE_COORDS  _trunk_window_kernel (K3), input projection of the coords
//   MODE_CIMG    _trunk_window_kernel (K3) with precomputed c_img rows
//   MODE_GATED   _trunk_window_gated_kernel (K4), contact gating fused in
//
// What it computes, per query point n of the (3, N) coords: the trilinear
// feature of the (R, R, R, C) channels-last grid at the point, with the
// coordinate math of ops/dense_decode.py supercell_base_coords
// (normalization with the 3-D epsilon and outlier-only remap,
// align-corners, border clamp, base corner clamped to R-2), then the chain
// of tile_chain.cuh. It also writes each point's super-cell key
// x0/L + n1 (y0/L + n1 z0/L) when `keys` is given: the wrapper counts the
// points outside their tile's window from these keys, as the JAX wrapper
// counts them from its own. The key math is IEEE f32, one rounding per
// step (__fdiv_rn, __fadd_rn, __fmul_rn: no reciprocal, no FMA), with the
// constants 1 + padding + 1e-3 and 1 - 1e-3 rounded to f32 by the caller
// from the same doubles as the plain version, so kernel keys equal the
// plain version's bit for bit.
//
// What bounds it on this card: the chain's 30.7 kFLOP per point of 32 x 32
// products (2^21 points: 64 GFLOP), which run on the tensor cores in
// 3xTF32 at a third of the 495 TFLOP/s TF32 rate; the coordinates,
// lerps, input projection, head and contact tests (about 1 kFLOP per
// point) on the CUDA cores; 16 B per point streamed and the 33.5 MB grid,
// which fits the 50 MB L2. The corner gather is 8 x 128 B per point from
// L1/L2, and an unculled gate tests every valid contact per point. Of
// these the products are the largest term.
//
// What the design does about it:
// - Tiles. A warpgroup (four warps) owns a tile of kTile consecutive
//   points (WINDOW_TILE in ops/cuda/decode.py); a block of three
//   warpgroups stages the split weights (123 KB) once and strides over
//   tiles, each warpgroup on its own named barrier, so one warpgroup's
//   gather and epilogues overlap the others' products. Without gating,
//   the warpgroups never wait for each other.
// - Coordinates and keys, one lane per point, with the exact math above.
// - Coalesced gather. A warp takes its 32 points in turn, one lane per
//   channel (C = 32 = the warp), so each corner is one 128 B row, with
//   eight points (64 rows) in flight; points sorted by super-cell share
//   cells, so the rows hit L1. The corners combine x first, then y, then
//   z, as the plain version, into the warp's (32 x 32) feature tile in
//   shared memory, the A operand of the wc products.
// - Per-tile contact culling (K4). The wrapper passes every contact, finger
//   by finger, in global memory (an invalid row carries |q|^2 = -1 and is
//   never kept). The tile's box (a reduction over its valid points) keeps
//   only the contacts q with dist(q, box)^2 <= r^2 + m. A point p gates on
//   q when the expanded distance d = (|q|^2 + |p|^2) - 2 q.p, rounded step
//   by step, is below r^2. Each of its roundings is at most u = 2^-24
//   relative, so |d - |q - p|^2| <= 8u (|q|^2 + |p|^2 + r^2) (three for
//   each squared norm and the dot product, one for each of the sum and
//   the difference, which is near r^2 where it matters). Every hit thus
//   has |q - p|^2 < r^2 + 8u (...), and dist(q, box) <= |q - p|. The
//   kernel takes m = 2^-19 (|q|^2 + P^2 + r^2), P^2 the largest |p|^2 of
//   the box: four times that bound, which also covers the rounding of the
//   box distance itself. With |q|^2, |p|^2 <= 1 and r = 0.015,
//   m <= 3.8e-6, a margin of about m / 2r = 1.3e-4 in distance, well below
//   r. So no point loses a hit. The warpgroup culls kChunk rows at a time,
//   from the last chunk back, each warp publishing one ballot mask per 32
//   rows (shared memory does not grow with the contact count), and each
//   point without a finger yet tests the kept rows from the last with
//   contact_finger's arithmetic: its first hit is in the last finger that
//   has one, the same decision as the unculled loop. Points sorted by
//   super-cell make a tile a short run of cells, so it keeps about one of
//   the ~450 valid contacts of a spread set. (A box per warp of 32 points, with no barriers, was slower
//   on the H100: each warp then tests every contact against its box.)
// - The chain on the tensor cores (tile_chain.cuh): 3xTF32 wgmma with
//   net and h in accumulator registers; the coordinates' projection
//   (3 -> 32), the gated finger's row W_img g_f and the biases are added
//   on the CUDA cores.

#include "tile_chain.cuh"

namespace {

using namespace tile;

constexpr int kTile = 128;                // points per tile, WINDOW_TILE
constexpr int kWarps = kTile / 32;        // warps per group
constexpr int kGroups = 3;                // tiles in flight per block
constexpr int kThreads = kTile * kGroups;
constexpr int kGatherPts = 8;   // points in flight in the gather, 8 rows each
constexpr int kRowsPerThread = 2;                  // contact rows culled per
constexpr int kChunk = kRowsPerThread * kTile;     // thread and chunk

// Per-group scratch after the blob, in floats:
//   f    [kWarps][32][kRowStride]   features (c_img rows first in MODE_CIMG)
//   pts  [kWarps][3][32]            coordinates
//   sel  [kWarps][32] (int)         gated finger per point, or -1
//   part [kWarps][8]                box partials (lo xyz, hi xyz)
//   mask [2][kRowsPerThread kWarps] (unsigned)  kept rows of a chunk, one
//                                   bit per row, double-buffered
constexpr int kF = 0;
constexpr int kPts = kF + kWarps * 32 * kRowStride;
constexpr int kSel = kPts + kWarps * 3 * 32;
constexpr int kPart = kSel + kWarps * 32;
constexpr int kMask = kPart + kWarps * 8;
constexpr int kGroupFloats = (kMask + 2 * kRowsPerThread * kWarps + 3) / 4 * 4;

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(kTile) : "memory");
}

// Base corner and fractional position along one axis of an R-node grid.
__device__ __forceinline__ int axis_base(float v, float box_eps, float u_hi,
                                         int R, float* w) {
  const float wmax = (float)(R - 1);
  float u = __fadd_rn(__fdiv_rn(v, box_eps), 0.5f);
  u = (u >= 1.f) ? u_hi : fmaxf(u, 0.f);
  const float x = fminf(fmaxf(__fmul_rn(u, wmax), 0.f), wmax);
  const int x0 = min((int)floorf(x), R - 2);
  *w = __fsub_rn(x, (float)x0);
  return x0;
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return a * (1.f - w) + b * w;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K4's gate for the group's tile: the finger whose feature lane `gi`'s
// point takes, or -1. Culls the rows (q, |q|^2) of q against the tile's box
// kChunk rows at a time, from the last chunk back (see the header).
__device__ __forceinline__ int tile_gate(const float4* __restrict__ q, int rows,
                                         int K, float* scratch, int group,
                                         float r2, bool valid, float px,
                                         float py, float pz) {
  const int gi = threadIdx.x % kTile, warp = gi / 32, lane = threadIdx.x & 31;
  float* part = scratch + kPart;
  unsigned* masks = reinterpret_cast<unsigned*>(scratch + kMask);

  // this thread's rows c0 + 32 s + lane, s = j kWarps + warp, of the last
  // chunk, loaded before the box is known; later chunks a chunk ahead
  int c0 = (rows - 1) / kChunk * kChunk;
  const float4 none = make_float4(0.f, 0.f, 0.f, -1.f);
  float4 c[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    c[j] = c0 + j * kTile + gi < rows ? __ldg(q + c0 + j * kTile + gi) : none;

  const float inf = __int_as_float(0x7f800000);
  const float b[6] = {warp_min(valid ? px : inf), warp_min(valid ? py : inf),
                      warp_min(valid ? pz : inf), warp_max(valid ? px : -inf),
                      warp_max(valid ? py : -inf), warp_max(valid ? pz : -inf)};
  if (lane == 0)
    for (int i = 0; i < 6; ++i) part[warp * 8 + i] = b[i];
  group_sync(group);
  float lo[3], hi[3];
  for (int i = 0; i < 3; ++i) {
    lo[i] = part[i];
    hi[i] = part[3 + i];
    for (int w = 1; w < kWarps; ++w) {
      lo[i] = fminf(lo[i], part[w * 8 + i]);
      hi[i] = fmaxf(hi[i], part[w * 8 + 3 + i]);
    }
  }
  float big[3];
  for (int i = 0; i < 3; ++i)
    big[i] = fmaxf(__fmul_rn(lo[i], lo[i]), __fmul_rn(hi[i], hi[i]));
  const float P2 = __fadd_rn(__fadd_rn(big[0], big[1]), big[2]);
  const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                             __fmul_rn(pz, pz));

  // Each chunk: one ballot mask per 32 rows (barrier), then every point
  // without a finger yet tests the kept rows from the last. The masks are
  // double-buffered, so one barrier per chunk orders them.
  int sel = -1;
  for (int buf = 0; c0 >= 0; c0 -= kChunk, buf ^= 1) {
    unsigned* mk = masks + buf * kRowsPerThread * kWarps;
    float4 next[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      next[j] = c0 >= kChunk ? __ldg(q + c0 - kChunk + j * kTile + gi) : none;
      // rounded step by step, as window_gate_candidates computes it
      const float4 e = c[j];
      const float dx = __fsub_rn(e.x, fminf(fmaxf(e.x, lo[0]), hi[0]));
      const float dy = __fsub_rn(e.y, fminf(fmaxf(e.y, lo[1]), hi[1]));
      const float dz = __fsub_rn(e.z, fminf(fmaxf(e.z, lo[2]), hi[2]));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float mg = __fmul_rn(0x1p-19f, __fadd_rn(__fadd_rn(e.w, P2), r2));
      // e.w < 0: an invalid row
      const unsigned m =
          __ballot_sync(0xffffffffu, e.w >= 0.f && d2 <= __fadd_rn(r2, mg));
      if (lane == 0) mk[j * kWarps + warp] = m;
    }
    group_sync(group);
    for (int s = kRowsPerThread * kWarps - 1; s >= 0 && valid && sel < 0; --s) {
      for (unsigned m = mk[s]; m != 0u;) {
        const int bit = 31 - __clz(m);
        m ^= 1u << bit;
        const int r = c0 + 32 * s + bit;
        const float4 e = __ldg(q + r);
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(e.x, px), __fmul_rn(e.y, py)), __fmul_rn(e.z, pz));
        if (__fsub_rn(__fadd_rn(e.w, p2), __fmul_rn(2.f, dot)) < r2) {
          sel = r / K;
          break;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) c[j] = next[j];
  }
  return sel;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
window_kernel(const float* __restrict__ blob, int n_floats, int NB, int F, int K,
              float r2, const float4* __restrict__ contacts,
              const float* __restrict__ p, const float* __restrict__ grid,
              int R, float box_eps, float u_hi, int L, int n1,
              const float* __restrict__ c_img, float* __restrict__ out,
              int32_t* __restrict__ keys, long long N) {
  extern __shared__ float4 smem4[];
  const float4* blob4 = reinterpret_cast<const float4*>(blob);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x) smem4[i] = blob4[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma
  __syncthreads();
  const float* sm = reinterpret_cast<const float*>(smem4);

  const Layout Lw = make_layout(NB);
  const int group = threadIdx.x / kTile, warp = (threadIdx.x % kTile) / 32;
  const int lane = threadIdx.x & 31;
  float* scratch = reinterpret_cast<float*>(smem4) + n_floats + group * kGroupFloats;
  float* f = scratch + kF + warp * 32 * kRowStride;
  float* pts = scratch + kPts + warp * 96;
  int* sel = reinterpret_cast<int*>(scratch + kSel) + warp * 32;

  constexpr int C = kWidth;
  const long long dx = C, dy = (long long)R * C, dz = (long long)R * R * C;
  const long long n_tiles = (N + kTile - 1) / kTile;
  for (long long ti = (long long)blockIdx.x * kGroups + group; ti < n_tiles;
       ti += (long long)gridDim.x * kGroups) {
    const long long n0 = ti * kTile + warp * 32;   // the warp's first point
    const long long n = n0 + lane;
    const bool valid = n < N;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (valid) {
      px = __ldg(p + n);
      py = __ldg(p + N + n);
      pz = __ldg(p + 2 * N + n);
    }
    float wx, wy, wz;
    const int x0 = axis_base(px, box_eps, u_hi, R, &wx);
    const int y0 = axis_base(py, box_eps, u_hi, R, &wy);
    const int z0 = axis_base(pz, box_eps, u_hi, R, &wz);
    if (valid && keys != nullptr) keys[n] = x0 / L + n1 * (y0 / L + n1 * (z0 / L));
    const int cell = (z0 * R + y0) * R + x0;

    __syncwarp();   // the previous tile's reads of f, pts, sel are done
    pts[lane] = px;
    pts[32 + lane] = py;
    pts[64 + lane] = pz;
    if (MODE == MODE_CIMG) {
      for (int c = 0; c < C; ++c)
        f[lane * kRowStride + c] = valid ? __ldg(c_img + (long long)c * N + n) : 0.f;
    }
    Acc img = {};
    if (MODE == MODE_CIMG) {
      __syncwarp();
      product(sm + Lw.tail, img,
              [&](int mi, int jk, float (&a)[4]) { tile_a(f, mi, jk, a); });
    }
    int my_sel = -1;
    if (MODE == MODE_GATED)
      my_sel = tile_gate(contacts, F * K, K, scratch, group, r2, valid, px, py, pz);
    sel[lane] = my_sel;
    __syncwarp();

    // corner gather, one lane per channel, kGatherPts points in flight
#pragma unroll 1
    for (int j0 = 0; j0 < 32; j0 += kGatherPts) {
      float v[kGatherPts][8], w[kGatherPts][3];
#pragma unroll
      for (int u = 0; u < kGatherPts; ++u) {
        const int j = j0 + u;
        const long long base = (long long)__shfl_sync(0xffffffffu, cell, j) * C + lane;
        w[u][0] = __shfl_sync(0xffffffffu, wx, j);
        w[u][1] = __shfl_sync(0xffffffffu, wy, j);
        w[u][2] = __shfl_sync(0xffffffffu, wz, j);
        const float* g = grid + base;
        v[u][0] = __ldg(g);
        v[u][1] = __ldg(g + dx);
        v[u][2] = __ldg(g + dy);
        v[u][3] = __ldg(g + dy + dx);
        v[u][4] = __ldg(g + dz);
        v[u][5] = __ldg(g + dz + dx);
        v[u][6] = __ldg(g + dz + dy);
        v[u][7] = __ldg(g + dz + dy + dx);
      }
#pragma unroll
      for (int u = 0; u < kGatherPts; ++u) {
        const float c00 = lerp(v[u][0], v[u][1], w[u][0]);
        const float c01 = lerp(v[u][2], v[u][3], w[u][0]);
        const float c10 = lerp(v[u][4], v[u][5], w[u][0]);
        const float c11 = lerp(v[u][6], v[u][7], w[u][0]);
        const float c0 = lerp(c00, c01, w[u][1]);
        const float c1 = lerp(c10, c11, w[u][1]);
        f[(j0 + u) * kRowStride + lane] = lerp(c0, c1, w[u][2]);
      }
    }
    __syncwarp();

    // input projection: W_in p + b_in (+ W_img g_f of the gated finger, or
    // + W_img c_img)
    Acc net;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = acc_row(mi, e);
        const float rx = pts[row], ry = pts[32 + row], rz = pts[64 + row];
        const int s = MODE == MODE_GATED ? sel[row] : -1;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int col = acc_col(jn, e);
          const float4 w = reinterpret_cast<const float4*>(sm + Lw.wp)[col];
          float v = fmaf(w.z, rz, fmaf(w.y, ry, w.x * rx)) + w.w;
          if (s >= 0) v += sm[Lw.tail + s * kWidth + col];
          net[mi][jn][e] = v;
        }
      }
    }
    if (MODE == MODE_CIMG) add(net, img);

    float o[4];
    chain(sm, Lw, NB, net, f, o);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long m = n0 + acc_row(k >> 1, 2 * (k & 1));
        if (m < N) out[m] = o[k];
      }
    }
  }
}

int smem_bytes(int n_floats) {
  return (n_floats + kGroups * kGroupFloats) * (int)sizeof(float);
}

template <int MODE>
int launch(const float* blob, int n_floats, int H, int C, int NB, int F, int K,
           float r2, const float* contacts, const float* p, const float* grid, int R, float box_eps,
           float u_hi, int L, int n1, const float* c_img, float* out,
           int32_t* keys, long long N, cudaStream_t stream) {
  if (H != kWidth || C != kWidth || R < 2 || L < 1 || n_floats % 4)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  auto kernel = window_kernel<MODE>;
  const int smem = smem_bytes(n_floats);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = ((N + kTile - 1) / kTile + kGroups - 1) / kGroups;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(
      blob, n_floats, NB, F, K, r2, reinterpret_cast<const float4*>(contacts), p,
      grid, R, box_eps, u_hi, L, n1, c_img, out, keys, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Points per tile: the wrapper's WINDOW_TILE must equal it.
int window_tile() { return kTile; }

// Dynamic shared memory of a launch: the blob and kGroups tiles' scratch.
int window_smem_bytes(int n_floats) { return smem_bytes(n_floats); }

// K3 (mode 0: coords only; mode 1: c_img rows) and K4 (mode 2: gated).
// blob: pack_window_params's layout (tile_chain.cuh); contacts (mode 2):
// (F*K, 4) f32 rows (qx, qy, qz, |q|^2, or -1 for an invalid row) in finger
// order, 16-byte aligned; grid: (R, R, R, C) f32 channels-last; p, c_img:
// (3, N), (C, N) f32; keys: (N,) int32 or null.
int window_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                     int F, int K, float r2, int mode, const float* contacts,
                     const float* p,
                     const float* grid, int R, float box_eps, float u_hi, int L,
                     int n1, const float* c_img, float* out, int32_t* keys,
                     long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_COORDS:
      return launch<MODE_COORDS>(blob, n_floats, H, C, NB, 0, 0, 0.f, nullptr, p, grid, R,
                                 box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    case MODE_CIMG:
      return launch<MODE_CIMG>(blob, n_floats, H, C, NB, 0, 0, 0.f, nullptr, p, grid, R,
                               box_eps, u_hi, L, n1, c_img, out, keys, N, s);
    case MODE_GATED:
      if (F < 1 || K < 1 || contacts == nullptr) return (int)cudaErrorInvalidValue;
      return launch<MODE_GATED>(blob, n_floats, H, C, NB, F, K, r2, contacts, p, grid, R,
                                box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
