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
// - Per-tile contact culling (K4), tile_chain.cuh's tile_gate: the wrapper
//   passes every contact, finger by finger, in global memory, and each
//   tile tests only those near its box, with a margin that keeps every
//   hit. Points sorted by super-cell make a tile a short run of cells, so
//   it keeps about one of the ~450 valid contacts of a spread set. (A box
//   per warp of 32 points, with no barriers, was slower on the H100: each
//   warp then tests every contact against its box.)
// - The chain on the tensor cores (tile_chain.cuh): 3xTF32 wgmma with
//   net and h in accumulator registers; the coordinates' projection
//   (3 -> 32), the gated finger's row W_img g_f and the biases are added
//   on the CUDA cores.

#include "tile_chain.cuh"

namespace {

using namespace tile;

constexpr int kGatherPts = 8;   // points in flight in the gather, 8 rows each

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

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
window_kernel(const float* __restrict__ blob, int n_floats, int NB, int K,
              float r2, const float4* __restrict__ contacts, int rows,
              const float* __restrict__ p, const float* __restrict__ grid,
              int R, float box_eps, float u_hi, int L, int n1,
              const float* __restrict__ c_img, float* __restrict__ out,
              int32_t* __restrict__ keys, long long N) {
  const float* sm = stage_blob(blob, n_floats);
  const Layout Lw = make_layout(NB);
  const WarpScratch ws = warp_scratch(sm, n_floats);
  const int lane = threadIdx.x & 31;

  constexpr int C = kWidth;
  const long long dx = C, dy = (long long)R * C, dz = (long long)R * R * C;
  for_each_tile(N, [&](long long n0) {
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
    ws.pts[lane] = px;
    ws.pts[32 + lane] = py;
    ws.pts[64 + lane] = pz;
    Acc img = {};
    if (MODE == MODE_CIMG) {
      load_cols(c_img, n0, N, ws.f);
      __syncwarp();
      product(sm + Lw.tail, img,
              [&](int mi, int jk, float (&a)[4]) { col_a(ws.f, mi, jk, a); });
    }
    ws.sel[lane] = MODE == MODE_GATED
        ? tile_gate(contacts, rows, K, ws.group, r2, valid, px, py, pz) : -1;
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
        ws.f[(j0 + u) * kRowStride + lane] = lerp(c0, c1, w[u][2]);
      }
    }
    __syncwarp();
    finish_tile<MODE>(sm, Lw, NB, ws, img,
                      [&](int mi, int jk, float (&a)[4]) { tile_a(ws.f, mi, jk, a); },
                      n0, N, out);
  });
}

template <int MODE>
int launch(const float* blob, int n_floats, int H, int C, int NB, int K,
           float r2, const float* contacts, int rows, const float* p,
           const float* grid, int R, float box_eps, float u_hi, int L, int n1,
           const float* c_img, float* out, int32_t* keys, long long N,
           cudaStream_t stream) {
  if (H != kWidth || C != kWidth || R < 2 || L < 1) return (int)cudaErrorInvalidValue;
  return launch_tiles(window_kernel<MODE>, n_floats, N, stream, blob, n_floats, NB,
                      K, r2, reinterpret_cast<const float4*>(contacts), rows, p,
                      grid, R, box_eps, u_hi, L, n1, c_img, out, keys, N);
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
      return launch<MODE_COORDS>(blob, n_floats, H, C, NB, 0, 0.f, nullptr, 0, p,
                                 grid, R, box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    case MODE_CIMG:
      return launch<MODE_CIMG>(blob, n_floats, H, C, NB, 0, 0.f, nullptr, 0, p,
                               grid, R, box_eps, u_hi, L, n1, c_img, out, keys, N, s);
    case MODE_GATED:
      if (F < 1 || K < 1 || contacts == nullptr) return (int)cudaErrorInvalidValue;
      return launch<MODE_GATED>(blob, n_floats, H, C, NB, K, r2, contacts, F * K, p,
                                grid, R, box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
