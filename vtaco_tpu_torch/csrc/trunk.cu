// Fused occupancy-decoder trunk for Hopper (sm_90a) at precomputed
// features: one tile kernel, three modes, replacing the Pallas kernels of
// vtaco_tpu/ops/pallas/decode.py:
//   MODE_COORDS  fused_trunk_cn (K2), input projection of the coords only;
//                also over B objects at once (fused_trunk_cn_batched, K2
//                under the JAX package's vmap in decode_dense_batched and
//                decode_points_batched)
//   MODE_CIMG    fused_trunk_cn (K2) with precomputed per-point c_img rows
//   MODE_GATED   fused_trunk_gated_cn (K1), contact gating fused in
//
// What it computes, per query point n of the (3, N) coords and (C, N)
// channels-first features (and c_img rows): the chain of tile_chain.cuh,
// with the input projection W_in [p; c_img] + b_in, where in MODE_GATED
// c_img is the feature g_f of the last finger with a valid contact q at
// (|q|^2 + |p|^2) - 2 q.p < r^2, rounded step by step, or zero. Streamed
// operands may be stored as bf16 (T = uint16_t, the bf16 bits); the math is
// f32 either way, as in the TPU kernel's store_dtype mode.
//
// What bounds it on this card: the chain's 30.7 kFLOP per point of 32 x 32
// products (the 128^3 mesh grid: 64 GFLOP), run on the tensor cores in
// 3xTF32 at a third of the 495 TFLOP/s TF32 rate: 0.39 ms. The streamed
// 144 B per point (272 B with c_img rows; half in bf16) take 0.09 ms at the
// memory rate; the input projection, head and contact tests run on the
// CUDA cores. An unculled gate would test every valid contact at every
// point, as many operations as the products on a spread contact set.
//
// What the design does about it (the kernel is window.cu's K3/K4 with the
// corner gather replaced by a streamed load):
// - Tiles. A warpgroup owns kTile = 128 consecutive points, three
//   warpgroups per block share the split weights (123 KB, staged once) and
//   stride over tiles, each on its own named barrier (tile_chain.cuh).
// - Features. Each lane loads its point's 32 channels, so each channel is
//   one coalesced 128 B row of the warp's 32 points (64 B in bf16), all 32
//   in flight, into a channel-major A tile whose columns pair rows g and
//   g + 8 (col_a): the stores and the fragments' float2 loads are free of
//   bank conflicts. bf16 values are exact in TF32 (their lo part is 0), so
//   the bf16 mode loses nothing in the split.
// - The chain on the tensor cores: 3xTF32 wgmma with net and h in
//   accumulator registers; the coordinates' projection (3 -> 32), the gated
//   finger's row W_img g_f and the biases on the CUDA cores.
// - Per-tile contact culling (K1): tile_gate. The mesh path's points come
//   in lattice order, z slowest, so a tile is one x-row at fixed (y, z), a
//   thin segment, and keeps only the few contacts within r of it; the
//   contacts stay in global memory, so any number fits. On points spread
//   over the box (the gather route of eval_points) a tile keeps every valid
//   contact; the gate then stages each chunk of rows in shared memory and
//   each point tests them from the last, four per step, stopping at its
//   first hit.
// - Objects (K2 batched). B objects' points are B (C, N) feature slabs,
//   B coordinate slabs (or one shared by all: the dense grid, stride 0)
//   and B output rows. The persistent blocks stride over all B ceil(N /
//   kTile) tiles of the flight, a tile never spanning two objects, and
//   stage the weights once per block as for one object: one launch for
//   the flight, no per-object tail of half-empty waves.

#include "tile_chain.cuh"

namespace {

using namespace tile;

// body(b, n0) for each tile of this warp's group over B objects of N
// points: object b's tile ti holds its points ti kTile + [0, kTile), n0
// the first of the warp's 32 points in it. Tiles blockIdx.x kGroups +
// group of the flight, strided by the grid, as for_each_tile.
template <class Body>
__device__ __forceinline__ void for_each_object_tile(int B, long long N, Body body) {
  const int group = threadIdx.x / kTile, warp = (threadIdx.x % kTile) / 32;
  const long long per_object = (N + kTile - 1) / kTile;
  const long long n_tiles = per_object * B;
  for (long long ti = (long long)blockIdx.x * kGroups + group; ti < n_tiles;
       ti += (long long)gridDim.x * kGroups) {
    const long long b = ti / per_object;
    body(b, (ti - b * per_object) * kTile + warp * 32);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
trunk_kernel(const float* __restrict__ blob, int n_floats, int NB, int K, float r2,
             const float4* __restrict__ contacts, int rows, const T* __restrict__ p_b,
             const T* __restrict__ feats_b, const T* __restrict__ c_img,
             float* __restrict__ out_b, long long N, int B, long long p_stride,
             long long f_stride) {
  const float* sm = stage_blob(blob, n_floats);
  const Layout Lw = make_layout(NB);
  const WarpScratch ws = warp_scratch(sm, n_floats);
  const int lane = threadIdx.x & 31;
  const auto feature_a = [&](int mi, int jk, float (&a)[4]) { col_a(ws.f, mi, jk, a); };

  for_each_object_tile(B, N, [&](long long b, long long n0) {
    const T* p = p_b + b * p_stride;
    const T* feats = feats_b + b * f_stride;
    float* out = out_b + b * N;
    const long long n = n0 + lane;
    const bool valid = n < N;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (valid) {
      px = load_f32(p + n);
      py = load_f32(p + N + n);
      pz = load_f32(p + 2 * N + n);
    }
    __syncwarp();   // the previous tile's reads of f, pts, sel are done
    ws.pts[lane] = px;
    ws.pts[32 + lane] = py;
    ws.pts[64 + lane] = pz;
    Acc img = {};
    if (MODE == MODE_CIMG) {
      load_cols(c_img, n0, N, ws.f);
      __syncwarp();
      product(sm + Lw.tail, img, feature_a);
    }
    ws.sel[lane] = MODE == MODE_GATED
        ? tile_gate(contacts, rows, K, ws.group, r2, valid, px, py, pz) : -1;
    __syncwarp();
    load_cols(feats, n0, N, ws.f);
    __syncwarp();
    finish_tile<MODE>(sm, Lw, NB, ws, img, feature_a, n0, N, out);
  });
}

// launch_tiles sizes the grid from a point count: B objects' tiles are
// those of B ceil(N / kTile) kTile points.
template <typename T, int MODE>
int launch(const float* blob, int n_floats, int H, int C, int NB, int K, float r2,
           const float* contacts, int rows, const void* p, const void* feats,
           const void* c_img, float* out, long long N, int B, long long p_stride,
           long long f_stride, cudaStream_t stream) {
  if (H != kWidth || C != kWidth || B < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  const long long flight = (long long)B * ((N + kTile - 1) / kTile) * kTile;
  return launch_tiles(trunk_kernel<T, MODE>, n_floats, flight, stream, blob, n_floats,
                      NB, K, r2, reinterpret_cast<const float4*>(contacts), rows,
                      static_cast<const T*>(p), static_cast<const T*>(feats),
                      static_cast<const T*>(c_img), out, N, B, p_stride, f_stride);
}

template <int MODE>
int launch_stored(int bf16, const float* blob, int n_floats, int H, int C, int NB,
                  int K, float r2, const float* contacts, int rows, const void* p,
                  const void* feats, const void* c_img, float* out, long long N,
                  int B, long long p_stride, long long f_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t, MODE>(blob, n_floats, H, C, NB, K, r2, contacts,
                                       rows, p, feats, c_img, out, N, B, p_stride,
                                       f_stride, s)
              : launch<float, MODE>(blob, n_floats, H, C, NB, K, r2, contacts, rows,
                                    p, feats, c_img, out, N, B, p_stride, f_stride, s);
}

}  // namespace

extern "C" {

// Points per tile: the wrapper's WINDOW_TILE must equal it.
int trunk_tile() { return kTile; }

// Dynamic shared memory of a launch: the blob and kGroups tiles' scratch.
int trunk_smem_bytes(int n_floats) { return smem_bytes(n_floats); }

// K2: fused_trunk_cn. blob: pack_window_params's layout (tile_chain.cuh),
// with the c_img product when c_img is given (mode 1), else mode 0; p,
// feats, c_img: (3, N), (C, N), (C, N), f32 or (bf16 != 0) bf16.
int trunk_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                    const void* p, const void* feats, const void* c_img,
                    int bf16, float* out, long long N, void* stream) {
  if (c_img == nullptr)
    return launch_stored<MODE_COORDS>(bf16, blob, n_floats, H, C, NB, 0, 0.f, nullptr,
                                      0, p, feats, nullptr, out, N, 1, 0, 0, stream);
  return launch_stored<MODE_CIMG>(bf16, blob, n_floats, H, C, NB, 0, 0.f, nullptr, 0,
                                  p, feats, c_img, out, N, 1, 0, 0, stream);
}

// K2 over B objects of N points each: fused_trunk_cn_batched. Mode 0's
// blob; feats (B, C, N) and out (B, N) contiguous; p (B, 3, N), or (3, N)
// shared by every object with p_stride 0 (elements between objects).
int trunk_cn_batched_launch(const float* blob, int n_floats, int H, int C, int NB,
                            int B, const void* p, long long p_stride,
                            const void* feats, int bf16, float* out, long long N,
                            void* stream) {
  return launch_stored<MODE_COORDS>(bf16, blob, n_floats, H, C, NB, 0, 0.f, nullptr, 0,
                                    p, feats, nullptr, out, N, B, p_stride,
                                    (long long)C * N, stream);
}

// K1: fused_trunk_gated_cn. blob: mode 2's, W_img g_f per finger after it;
// contacts: (F*K, 4) f32 rows (qx, qy, qz, |q|^2, or -1 for an invalid
// row) in finger order, 16-byte aligned.
int trunk_gated_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                          int F, int K, float r2, const float* contacts,
                          const void* p, const void* feats, int bf16, float* out,
                          long long N, void* stream) {
  if (F < 1 || K < 1 || contacts == nullptr) return (int)cudaErrorInvalidValue;
  return launch_stored<MODE_GATED>(bf16, blob, n_floats, H, C, NB, K, r2, contacts,
                                   F * K, p, feats, nullptr, out, N, 1, 0, 0, stream);
}

}  // extern "C"
