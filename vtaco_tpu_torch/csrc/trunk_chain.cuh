// The pieces of the one-thread-per-point decoder trunk of trunk.cu (K1,
// K2; window.cu runs the tile chain of tile_chain.cuh): the packed weight layout,
// the input projection with its three modes, contact gating, and the
// conditioned ResNet-FC chain. A kernel includes this header, stages the
// weight blob in shared memory, brings each point's features into registers
// by its own means, and calls input_projection and chain.
//
// Per query point n:
//   net = W_in [p; c_img] + b_in
//   for each block i: net += Wc_i f + bc_i
//                     h    = W0_i relu(net) + b0_i
//                     net += W1_i relu(h) + b1_i
//   out[n] = w_out . relu(net) + b_out
// With gating, c_img is the feature of the last finger that has a valid
// contact q with |q|^2 + |p|^2 - 2 q.p < r^2, or zero when none has (the
// wrapper puts each finger's valid contacts first and passes their count,
// and projects W_img g_f once per finger).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trunk {

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

// Copy the weight blob into the block's dynamic shared memory.
__device__ __forceinline__ void stage_weights(float4* smem4, const float* blob,
                                              int n_floats) {
  const float4* blob4 = reinterpret_cast<const float4*>(blob);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x) smem4[i] = blob4[i];
  __syncthreads();
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

// net = W_in [p; c_img] + b_in for point n: coords only, c_img rows read
// from (C, N) channels-first memory, or the gated finger's projection.
template <typename T, int H, int C, int MODE>
__device__ __forceinline__ void input_projection(
    const float* __restrict__ sm, const Layout& L, int F, int K, float r2,
    float px, float py, float pz, const T* __restrict__ c_img, long long n,
    long long N, float (&net)[H]) {
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
}

// The conditioned ResNet-FC chain and the output head: the logit of a
// point whose input projection is `net` and whose features are `f`.
template <int H, int C>
__device__ __forceinline__ float chain(const float* __restrict__ sm,
                                       const Layout& L, int NB, float (&net)[H],
                                       const float (&f)[C]) {
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
  return s;
}

// Blocks for a grid-stride launch over N points: as many as the SMs hold
// at once (each block stages the weights once), after raising the kernel's
// dynamic shared-memory limit to `smem` bytes.
template <typename Kernel>
static inline cudaError_t grid_blocks(Kernel kernel, int smem, long long N,
                                      int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (N + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace trunk
