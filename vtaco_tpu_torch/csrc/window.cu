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
// of trunk_chain.cuh. It also writes each point's super-cell key
// x0/L + n1 (y0/L + n1 z0/L) when `keys` is given: the wrapper counts the
// points outside their tile's window from these keys, as the JAX wrapper
// counts them from its own. The key math is IEEE f32, one rounding per
// step (__fdiv_rn, __fadd_rn, __fmul_rn: no reciprocal, no FMA), with the
// constants 1 + padding + 1e-3 and 1 - 1e-3 rounded to f32 by the caller
// from the same doubles as the plain version, so kernel keys equal the
// plain version's bit for bit.
//
// What bounds it on this card: the trunk's ~31 kFLOP of f32 work per point
// (K2's) plus ~0.7 kFLOP of interpolation and coordinates, against 16 B
// per point streamed and the 33.5 MB grid read once: bound by the CUDA
// cores' f32 rate. The gather is 8 corners x C floats = 1 KB per point,
// but the 64^3 x 32 grid fits the 50 MB L2.
//
// What the design does about it: the TPU kernel sorts points by super-cell
// so each tile selects its features from a window of a packed volume with
// one-hot MXU dots, because a TPU gather pays for every row. None of that
// is needed here. One thread per point, as in trunk.cu: the thread reads
// its 8 corners directly from the channels-last grid as 16-byte __ldg
// loads (C contiguous floats per corner) and interpolates in registers.
// The caller's sort by super-cell still pays: neighbouring threads read
// the same cells, so the loads hit L1 and coalesce. The window size S and
// super-cell size L then only shape the plan and the overflow count; the
// interpolation is the same for any L, since only the nodes x0 and x0 + 1
// of each axis carry a nonzero hat weight. Weights live in shared memory
// as in trunk.cu; the features, net and h stay in registers.

#include "trunk_chain.cuh"

namespace {

using namespace trunk;

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

__device__ __forceinline__ float4 lerp4(const float4& a, const float4& b, float w) {
  return make_float4(lerp(a.x, b.x, w), lerp(a.y, b.y, w), lerp(a.z, b.z, w),
                     lerp(a.w, b.w, w));
}

template <int H, int C, int MODE>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float* __restrict__ blob, int n_floats, int NB, int F, int K,
              float r2, const float* __restrict__ p, const float* __restrict__ grid,
              int R, float box_eps, float u_hi, int L, int n1,
              const float* __restrict__ c_img, float* __restrict__ out,
              int32_t* __restrict__ keys, long long N) {
  extern __shared__ float4 smem4[];
  stage_weights(smem4, blob, n_floats);
  const float* sm = reinterpret_cast<const float*>(smem4);

  const Layout Lw = make_layout(H, C, NB);
  const float4* g4 = reinterpret_cast<const float4*>(grid);
  const long long dx = C / 4, dy = (long long)R * C / 4, dz = (long long)R * R * C / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const float px = __ldg(p + n);
    const float py = __ldg(p + N + n);
    const float pz = __ldg(p + 2 * N + n);
    float wx, wy, wz;
    const int x0 = axis_base(px, box_eps, u_hi, R, &wx);
    const int y0 = axis_base(py, box_eps, u_hi, R, &wy);
    const int z0 = axis_base(pz, box_eps, u_hi, R, &wz);
    if (keys != nullptr) keys[n] = x0 / L + n1 * (y0 / L + n1 * (z0 / L));

    float net[H];
    input_projection<float, H, C, MODE>(sm, Lw, F, K, r2, px, py, pz, c_img, n, N,
                                        net);

    // corners combined x first, then y, then z, as the plain version
    float f[C];
    const long long base = (((long long)z0 * R + y0) * R + x0) * (C / 4);
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4* c = g4 + base + j;
      const float4 c00 = lerp4(__ldg(c), __ldg(c + dx), wx);
      const float4 c01 = lerp4(__ldg(c + dy), __ldg(c + dy + dx), wx);
      const float4 c10 = lerp4(__ldg(c + dz), __ldg(c + dz + dx), wx);
      const float4 c11 = lerp4(__ldg(c + dz + dy), __ldg(c + dz + dy + dx), wx);
      const float4 v = lerp4(lerp4(c00, c01, wy), lerp4(c10, c11, wy), wz);
      f[4 * j + 0] = v.x;
      f[4 * j + 1] = v.y;
      f[4 * j + 2] = v.z;
      f[4 * j + 3] = v.w;
    }
    out[n] = chain<H, C>(sm, Lw, NB, net, f);
  }
}

template <int MODE>
int launch(const float* blob, int n_floats, int H, int C, int NB, int F, int K,
           float r2, const float* p, const float* grid, int R, float box_eps,
           float u_hi, int L, int n1, const float* c_img, float* out,
           int32_t* keys, long long N, cudaStream_t stream) {
  if (H != 32 || C != 32 || R < 2 || L < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  auto kernel = window_kernel<32, 32, MODE>;
  const int smem = n_floats * (int)sizeof(float);
  int blocks = 0;
  cudaError_t err = grid_blocks(kernel, smem, N, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(blob, n_floats, NB, F, K, r2, p, grid,
                                             R, box_eps, u_hi, L, n1, c_img, out,
                                             keys, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 (mode 0: coords only; mode 1: c_img rows) and K4 (mode 2: gated).
// grid: (R, R, R, C) f32 channels-last; p, c_img: (3, N), (C, N) f32;
// keys: (N,) int32 or null.
int window_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                     int F, int K, float r2, int mode, const float* p,
                     const float* grid, int R, float box_eps, float u_hi, int L,
                     int n1, const float* c_img, float* out, int32_t* keys,
                     long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_COORDS:
      return launch<MODE_COORDS>(blob, n_floats, H, C, NB, 0, 0, 0.f, p, grid, R,
                                 box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    case MODE_CIMG:
      return launch<MODE_CIMG>(blob, n_floats, H, C, NB, 0, 0, 0.f, p, grid, R,
                               box_eps, u_hi, L, n1, c_img, out, keys, N, s);
    case MODE_GATED:
      return launch<MODE_GATED>(blob, n_floats, H, C, NB, F, K, r2, p, grid, R,
                                box_eps, u_hi, L, n1, nullptr, out, keys, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
