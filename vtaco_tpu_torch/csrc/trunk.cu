// Fused occupancy-decoder trunk for Hopper (sm_90a): one CUDA kernel, three
// modes, replacing the Pallas kernels of vtaco_tpu/ops/pallas/decode.py:
//   MODE_COORDS  fused_trunk_cn (K2), input projection of the coords only
//   MODE_CIMG    fused_trunk_cn (K2) with precomputed per-point c_img rows
//   MODE_GATED   fused_trunk_gated_cn (K1), contact gating fused in
//
// What it computes, per query point n (columns of channels-first inputs):
//   net = W_in [p; c_img] + b_in
//   for each block i: net += Wc_i f + bc_i
//                     h    = W0_i relu(net) + b0_i
//                     net += W1_i relu(h) + b1_i
//   out[n] = w_out . relu(net) + b_out
// With gating, c_img is the feature of the last finger that has a valid
// contact q with |q|^2 + |p|^2 - 2 q.p < r^2 (invalid contacts carry
// |q|^2 = 1e30), or zero when none has. The wrapper puts each finger's
// valid contacts first and passes their count, so the kernel tests only
// those: an invalid row never passes the test, so skipping it is exact.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_COORDS = 0, MODE_CIMG = 1, MODE_GATED = 2 };

constexpr int kThreads = 128;

// Packed weight blob, in floats (the wrapper's pack order, ops/cuda/decode.py):
//   wc [NB][H][C] | w0 [NB][H][H] | w1 [NB][H][H] | wp [H][4] (x, y, z, b_in)
//   | bc [NB][H] | b0 [NB][H] | b1 [NB][H] | w_out [H] | b_out [4]
// then a mode-dependent tail:
//   MODE_CIMG:  w_img [H][C]
//   MODE_GATED: gproj [F][H] (W_img g_f per finger) | count [F, padded to 4]
//               (valid contacts per finger, as floats) | contacts [F*K][4]
//               (qx, qy, qz, |q|^2 or 1e30; each finger's valid rows first)
struct Layout {
  int wc, w0, w1, wp, bc, b0, b1, wout, bout, tail;
};

__host__ __device__ inline Layout make_layout(int H, int C, int NB) {
  Layout L;
  L.wc = 0;
  L.w0 = L.wc + NB * H * C;
  L.w1 = L.w0 + NB * H * H;
  L.wp = L.w1 + NB * H * H;
  L.bc = L.wp + 4 * H;
  L.b0 = L.bc + NB * H;
  L.b1 = L.b0 + NB * H;
  L.wout = L.b1 + NB * H;
  L.bout = L.wout + H;
  L.tail = L.bout + 4;
  return L;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// y[o] = sum_k W[o][k] x[k], W row-major (NO x NK) in shared memory.
template <int NO, int NK>
__device__ __forceinline__ void matvec(const float* __restrict__ W,
                                       const float (&x)[NK], float (&y)[NO]) {
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const float4* row = reinterpret_cast<const float4*>(W + o * NK);
    float s = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < NK / 4; ++k4) {
      const float4 w = row[k4];
      s = fmaf(w.x, x[4 * k4 + 0], s);
      s = fmaf(w.y, x[4 * k4 + 1], s);
      s = fmaf(w.z, x[4 * k4 + 2], s);
      s = fmaf(w.w, x[4 * k4 + 3], s);
    }
    y[o] = s;
  }
}

// Index of the last finger with a valid contact within the radius, or -1.
// Finger f's count[f] valid contacts are its first rows. The expanded
// distance is rounded step by step (no FMA contraction), as the plain
// version computes it.
__device__ __forceinline__ int contact_finger(const float4* __restrict__ q,
                                              const float* __restrict__ count,
                                              int F, int K, float r2,
                                              float px, float py, float pz) {
  const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                             __fmul_rn(pz, pz));
  int sel = -1;
  for (int f = 0; f < F; ++f) {
    const int n_valid = (int)count[f];
    for (int k = 0; k < n_valid; ++k) {
      const float4 c = q[f * K + k];
      const float dot = __fadd_rn(
          __fadd_rn(__fmul_rn(c.x, px), __fmul_rn(c.y, py)), __fmul_rn(c.z, pz));
      const float d2 = __fsub_rn(__fadd_rn(c.w, p2), __fmul_rn(2.f, dot));
      if (d2 < r2) {
        sel = f;
        break;
      }
    }
  }
  return sel;
}

template <typename T, int H, int C, int MODE>
__global__ void __launch_bounds__(kThreads)
trunk_kernel(const float* __restrict__ blob, int n_floats, int NB, int F, int K,
             float r2, const T* __restrict__ p, const T* __restrict__ feats,
             const T* __restrict__ c_img, float* __restrict__ out, long long N) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float4* blob4 = reinterpret_cast<const float4*>(blob);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x) smem4[i] = blob4[i];
  __syncthreads();

  const Layout L = make_layout(H, C, NB);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const float px = load_f32(p + n);
    const float py = load_f32(p + N + n);
    const float pz = load_f32(p + 2 * N + n);

    float net[H];
#pragma unroll
    for (int o = 0; o < H; ++o) {
      const float4 w = reinterpret_cast<const float4*>(sm + L.wp)[o];
      net[o] = fmaf(w.z, pz, fmaf(w.y, py, w.x * px));
    }
    if (MODE == MODE_CIMG) {
      float ci[C], y[H];
#pragma unroll
      for (int k = 0; k < C; ++k) ci[k] = load_f32(c_img + (long long)k * N + n);
      matvec<H, C>(sm + L.tail, ci, y);
#pragma unroll
      for (int o = 0; o < H; ++o) net[o] += y[o];
    }
    if (MODE == MODE_GATED) {
      const float* count = sm + L.tail + F * H;
      const float4* q = reinterpret_cast<const float4*>(count + (F + 3) / 4 * 4);
      const int sel = contact_finger(q, count, F, K, r2, px, py, pz);
      if (sel >= 0) {
        const float* g = sm + L.tail + sel * H;
#pragma unroll
        for (int o = 0; o < H; ++o) net[o] += g[o];
      }
    }
#pragma unroll
    for (int o = 0; o < H; ++o) net[o] += sm[L.wp + 4 * o + 3];

    float f[C];
#pragma unroll
    for (int k = 0; k < C; ++k) f[k] = load_f32(feats + (long long)k * N + n);

    for (int b = 0; b < NB; ++b) {
      float a[H], h[H];
      matvec<H, C>(sm + L.wc + b * H * C, f, h);
#pragma unroll
      for (int o = 0; o < H; ++o) {
        net[o] += h[o] + sm[L.bc + b * H + o];
        a[o] = fmaxf(net[o], 0.f);
      }
      matvec<H, H>(sm + L.w0 + b * H * H, a, h);
#pragma unroll
      for (int o = 0; o < H; ++o) a[o] = fmaxf(h[o] + sm[L.b0 + b * H + o], 0.f);
      matvec<H, H>(sm + L.w1 + b * H * H, a, h);
#pragma unroll
      for (int o = 0; o < H; ++o) net[o] += h[o] + sm[L.b1 + b * H + o];
    }
    float s = sm[L.bout];
#pragma unroll
    for (int k = 0; k < H; ++k) s = fmaf(sm[L.wout + k], fmaxf(net[k], 0.f), s);
    out[n] = s;
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (N + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(want < cap ? want : cap);
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
