// The decoder trunk's conditioned ResNet-FC chain on Hopper's tensor cores,
// for a warpgroup's 128 points at once (32 per warp): the pieces of the
// window kernels (window.cu: K3, K4) that a later redesign of trunk.cu can
// share.
//
// Per point (rows), with hidden = C = 32 (columns):
//   net = W_in [p; c_img] + b_in
//   for each block i: net += Wc_i f + bc_i
//                     h    = W0_i relu(net) + b0_i
//                     net += W1_i relu(h) + b1_i
//   out = w_out . relu(net) + b_out
//
// Each 32 x 32 product runs as wgmma.mma_async m64n32k8 .tf32 with the A
// operand in registers and B (the weights) in shared memory: points are
// the M axis (each warp's two m16 tiles: two m64 warpgroup tiles), output
// channels the N axis, input channels the K axis (four k8 steps). TF32
// keeps 10 mantissa bits, too few for the 1e-4 parity with the IEEE f32
// reference, so every operand x is split as hi = rna(x), lo = rna(x - hi)
// (round to nearest, ties away, on the 13 low mantissa bits, as
// cvt.rna.tf32.f32; x - hi is exact) and each product accumulates
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b in f32 ("3xTF32"): only lo_a.lo_b,
// about 2^-22 of the product, is lost.
//
// Why wgmma: the chain is bound by its tensor-core products, and wgmma
// issues a warpgroup's 64 x 32 x 8 product as one instruction where
// mma.sync needs sixteen. The same kernel with mma.sync m16n8k8 (and two
// warpgroups, which its 198-210 registers allowed) ran about a fifth
// slower on the H100 (PERF.md). Each product waits for its wgmma
// group, since the next one reads it; three warpgroups per SM overlap
// those waits. (A pipeline of the two m64 halves inside a warpgroup was
// serialized by ptxas and ran slower.)
//
// The layout trick that keeps net and h in registers: an m16n8 accumulator
// chunk holds (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1) for lane
// 4g + t, while an m16k8 A fragment wants (row g, k = t and t+4), (row
// g+8, same). Reading a k8 block's input channel 2t as logical k = t and
// channel 2t+1 as k = t + 4, the accumulator of output n8 chunk j is
// exactly the A fragment of input k8 step j: (c0, c2, c1, c3), no
// shuffles. The weights are packed with the same permutation of their
// input axis (ops/cuda/decode.py pack_window_params): for product P, part
// (hi, lo), k8 step jk, core matrix (nb along N, kb along K), row r and
// element e, the float at P*2048 + (((part*4 + jk)*4 + nb)*2 + kb)*32 + 4r
// + e is part(W[8nb + r][8jk + 2e + kb]): no-swizzle K-major core matrices,
// 128 B apart along K and 256 B along N. The weights are split on the
// host: 15 products x 8 KB = 123 KB of shared memory, which leaves room for
// three 128-point tiles per block (window.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

enum Mode { MODE_COORDS = 0, MODE_CIMG = 1, MODE_GATED = 2 };

constexpr int kWidth = 32;              // hidden = C
constexpr int kFragFloats = 2048;       // one packed 32 x 32 product
constexpr int kRowStride = 40;          // floats per point row of an A tile:
                                        // float2 loads of 8 rows x 4 lanes
                                        // hit 32 distinct banks

// The window blob, in floats (pack_window_params):
//   frag [3 NB][2048]         the packed products wc_i, w0_i, w1_i of
//                             each block i (the order above)
//   wp [H][4] (x, y, z, b_in) | bc [NB][H] | b0 [NB][H] | b1 [NB][H]
//   | w_out [H] | b_out [4]   natural channel order
// then a mode-dependent tail:
//   MODE_CIMG:  w_img packed as one more product [2048]
//   MODE_GATED: gproj [F][H] (W_img g_f per finger); the contacts
//               themselves stay in global memory (window.cu)
struct Layout {
  int frag, wp, bc, b0, b1, wout, bout, tail;
};

__host__ __device__ inline Layout make_layout(int NB) {
  const int H = kWidth;
  Layout L;
  L.frag = 0;
  L.wp = 3 * NB * kFragFloats;
  L.bc = L.wp + 4 * H;
  L.b0 = L.bc + NB * H;
  L.b1 = L.b0 + NB * H;
  L.wout = L.b1 + NB * H;
  L.bout = L.wout + H;
  L.tail = L.bout + 4;
  return L;
}

// x rounded to TF32 to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, as two integer operations, which
// issue at four times the rate of a conversion on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a no-swizzle K-major B operand: 8-row
// core matrices of 16 B per row, `lbo` bytes apart along K, `sbo` bytes
// apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma window.
__device__ __forceinline__ void pin(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (this warp's 16 rows of a 64 x 32 warpgroup tile) += A B, A the
// warp's m16k8 fragment a, B the k8 x 32 tile at descriptor b.
__device__ __forceinline__ void wgmma(float (&d)[4][4], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// A warp's activations: [m16 tile][n8 tile][accumulator element].
using Acc = float[2][4][4];

// acc += X W^T for the warpgroup's 128 points (each warp's 32), W one
// packed product in shared memory, X given by load_a(mi, jk, a) as the
// four f32 values of the A fragment of m16 tile mi at k8 step jk. All four
// warps of the warpgroup must call it together.
template <class LoadA>
__device__ __forceinline__ void product(const float* __restrict__ w, Acc& acc,
                                        LoadA load_a) {
  uint32_t hi[2][4][4], lo[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) {
      float a[4];
      load_a(mi, jk, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], hi[mi][jk][e], lo[mi][jk][e]);
    }
  const uint64_t b_hi = smem_desc(w, 128, 256);
  const uint64_t b_lo = b_hi + (4096 >> 4);      // the lo part, 4 KB on
  pin(acc[0]);
  pin(acc[1]);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const uint64_t step = (uint64_t)(jk * 1024 >> 4);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {      // small terms first
      wgmma(acc[mi], lo[mi][jk], b_hi + step);
      wgmma(acc[mi], hi[mi][jk], b_lo + step);
      wgmma(acc[mi], hi[mi][jk], b_hi + step);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  pin(acc[0]);
  pin(acc[1]);
}

// A fragments read from a (32 x kRowStride) row-major tile in shared memory
// whose columns are the natural input channels.
__device__ __forceinline__ void tile_a(const float* __restrict__ x, int mi,
                                       int jk, float (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r = x + (16 * mi + g) * kRowStride + 8 * jk + 2 * t;
  const float2 top = *reinterpret_cast<const float2*>(r);
  const float2 bot = *reinterpret_cast<const float2*>(r + 8 * kRowStride);
  a[0] = top.x;
  a[1] = bot.x;
  a[2] = top.y;
  a[3] = bot.y;
}

// A fragments of relu(src), src the accumulator of the previous product.
__device__ __forceinline__ void relu_a(const Acc& src, int mi, int jk,
                                       float (&a)[4]) {
  a[0] = fmaxf(src[mi][jk][0], 0.f);
  a[1] = fmaxf(src[mi][jk][2], 0.f);
  a[2] = fmaxf(src[mi][jk][1], 0.f);
  a[3] = fmaxf(src[mi][jk][3], 0.f);
}

// acc[.][jn][e] = v[channel of (jn, e)] for a natural-order vector v.
__device__ __forceinline__ void set_cols(Acc& acc, const float* __restrict__ v) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    const float2 b = *reinterpret_cast<const float2*>(v + 8 * jn + 2 * t);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      acc[mi][jn][0] = b.x;
      acc[mi][jn][1] = b.y;
      acc[mi][jn][2] = b.x;
      acc[mi][jn][3] = b.y;
    }
  }
}

__device__ __forceinline__ void add(Acc& acc, const Acc& x) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][jn][e] += x[mi][jn][e];
}

// The warp-local row (0..31) and channel of accumulator element (mi, jn, e).
__device__ __forceinline__ int acc_row(int mi, int e) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int jn, int e) {
  return 8 * jn + 2 * (threadIdx.x & 3) + (e & 1);
}

// The chain from `net` (the input projection) with the warp's features f
// (a 32 x kRowStride tile in shared memory), then the output head. Returns,
// for the lanes with t == 0, the logits of rows g, g + 8, 16 + g, 24 + g in
// out[0..3] (other lanes hold partial sums).
//
// Each product accumulates from its bias in an accumulator of its own and
// is then added to net in f32: the tensor cores round each mma's sum at
// the scale of its accumulator, and net grows along the chain (logits of
// order 10), so accumulating into net itself loses the products' low bits
// twelve times per product.
__device__ __forceinline__ void chain(const float* __restrict__ sm,
                                      const Layout& L, int NB, Acc& net,
                                      const float* __restrict__ f,
                                      float (&out)[4]) {
  const float* frag = sm + L.frag;
  for (int b = 0; b < NB; ++b) {
    Acc h, d;
    set_cols(d, sm + L.bc + b * kWidth);
    product(frag + (3 * b + 0) * kFragFloats, d,
            [&](int mi, int jk, float (&a)[4]) { tile_a(f, mi, jk, a); });
    add(net, d);
    set_cols(h, sm + L.b0 + b * kWidth);
    product(frag + (3 * b + 1) * kFragFloats, h,
            [&](int mi, int jk, float (&a)[4]) { relu_a(net, mi, jk, a); });
    set_cols(d, sm + L.b1 + b * kWidth);
    product(frag + (3 * b + 2) * kFragFloats, d,
            [&](int mi, int jk, float (&a)[4]) { relu_a(h, mi, jk, a); });
    add(net, d);
  }
  // head: w_out . relu(net) per row, summed over the quad's 8 channels each
  const float b_out = sm[L.bout];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const float2 w =
            *reinterpret_cast<const float2*>(sm + L.wout + acc_col(jn, 0));
        s = fmaf(w.x, fmaxf(net[mi][jn][2 * half], 0.f), s);
        s = fmaf(w.y, fmaxf(net[mi][jn][2 * half + 1], 0.f), s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      out[2 * mi + half] = s + b_out;
    }
  }
}

}  // namespace tile
