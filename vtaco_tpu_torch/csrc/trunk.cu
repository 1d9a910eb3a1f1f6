// Fused occupancy-decoder trunk for Hopper (sm_90a): one CUDA kernel, three
// modes, replacing the Pallas kernels of vtaco_tpu/ops/pallas/decode.py:
//   MODE_COORDS  fused_trunk_cn (K2), input projection of the coords only
//   MODE_CIMG    fused_trunk_cn (K2) with precomputed per-point c_img rows
//   MODE_GATED   fused_trunk_gated_cn (K1), contact gating fused in
//
// What it computes, per query point n (columns of channels-first inputs),
// is the chain of trunk_chain.cuh on the point's coords and its
// precomputed (C, N) features. With gating, invalid contacts carry
// |q|^2 = 1e30; the wrapper puts each finger's valid contacts first and
// passes their count, so the kernel tests only those: an invalid row never
// passes the test, so skipping it is exact.
//
// What bounds it on this card: about 31 kFLOP of f32 FMA work per point at
// hidden = C = 32 and 5 blocks, against 144 B of streamed inputs (coords
// and features read once, one logit written), so the trunk is bound by the
// CUDA cores' f32 rate, not by memory (IEEE f32 on purpose: the JAX
// reference runs at "highest" precision, so no TF32 tensor cores).
//
// What the design does about it: one thread per point, points on
// threadIdx.x so the (C, N) reads coalesce; the activation vectors net, h
// and the features stay in registers (widths are template parameters so
// the arrays are register-resident); all weights (~64 KB) sit in shared
// memory and every warp reads them as broadcast float4 loads, so the inner
// loops are FMAs fed from registers and broadcast shared loads. A
// grid-stride loop over points keeps the number of blocks at what the
// SMs hold at once, so each block fills shared memory once. For K1 the
// five per-finger input projections W_img g_f are precomputed by the
// wrapper (they do not depend on the point), so gating costs only the
// distance tests against each finger's valid contacts, which stop at the
// finger's first hit. There are no padded
// tiles (each thread checks n < N), so the TPU kernel's far-away padding
// sentinel has no counterpart here.
//
// Streamed inputs may be stored as bf16 (T = __nv_bfloat16); the math is
// f32 either way, as in the TPU kernel's store_dtype mode.

#include "trunk_chain.cuh"

namespace {

using namespace trunk;

template <typename T, int H, int C, int MODE>
__global__ void __launch_bounds__(kThreads)
trunk_kernel(const float* __restrict__ blob, int n_floats, int NB, int F, int K,
             float r2, const T* __restrict__ p, const T* __restrict__ feats,
             const T* __restrict__ c_img, float* __restrict__ out, long long N) {
  extern __shared__ float4 smem4[];
  stage_weights(smem4, blob, n_floats);
  const float* sm = reinterpret_cast<const float*>(smem4);

  const Layout L = make_layout(H, C, NB);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const float px = load_f32(p + n);
    const float py = load_f32(p + N + n);
    const float pz = load_f32(p + 2 * N + n);

    float net[H];
    input_projection<T, H, C, MODE>(sm, L, F, K, r2, px, py, pz, c_img, n, N, net);

    float f[C];
#pragma unroll
    for (int k = 0; k < C; ++k) f[k] = load_f32(feats + (long long)k * N + n);
    out[n] = chain<H, C>(sm, L, NB, net, f);
  }
}

template <typename T, int MODE>
int launch(const float* blob, int n_floats, int H, int C, int NB, int F, int K,
           float r2, const void* p, const void* feats, const void* c_img,
           float* out, long long N, cudaStream_t stream) {
  if (H != 32 || C != 32) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  auto kernel = trunk_kernel<T, 32, 32, MODE>;
  const int smem = n_floats * (int)sizeof(float);
  int blocks = 0;
  cudaError_t err = grid_blocks(kernel, smem, N, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      blob, n_floats, NB, F, K, r2, static_cast<const T*>(p),
      static_cast<const T*>(feats), static_cast<const T*>(c_img), out, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: fused_trunk_cn. c_img may be null (coords-only input projection).
int trunk_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                    const void* p, const void* feats, const void* c_img,
                    int bf16, float* out, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_img == nullptr) {
    return bf16 ? launch<__nv_bfloat16, MODE_COORDS>(blob, n_floats, H, C, NB, 0, 0,
                                                     0.f, p, feats, c_img, out, N, s)
                : launch<float, MODE_COORDS>(blob, n_floats, H, C, NB, 0, 0, 0.f, p,
                                             feats, c_img, out, N, s);
  }
  return bf16 ? launch<__nv_bfloat16, MODE_CIMG>(blob, n_floats, H, C, NB, 0, 0, 0.f,
                                                 p, feats, c_img, out, N, s)
              : launch<float, MODE_CIMG>(blob, n_floats, H, C, NB, 0, 0, 0.f, p,
                                         feats, c_img, out, N, s);
}

// K1: fused_trunk_gated_cn.
int trunk_gated_cn_launch(const float* blob, int n_floats, int H, int C, int NB,
                          int F, int K, float r2, const void* p, const void* feats,
                          int bf16, float* out, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, MODE_GATED>(blob, n_floats, H, C, NB, F, K, r2,
                                                  p, feats, nullptr, out, N, s)
              : launch<float, MODE_GATED>(blob, n_floats, H, C, NB, F, K, r2, p,
                                          feats, nullptr, out, N, s);
}

}  // extern "C"
