// The decoder trunk's conditioned ResNet-FC chain on Hopper's tensor cores,
// for a warpgroup's 128 points at once (32 per warp), and the tile loop
// around it: the one chain of all four trunk kernels (trunk.cu: K1, K2;
// window.cu: K3, K4), which differ only in where a tile's features come
// from (streamed (C, N) rows or the trilinear gather).
//
// What bounds a kernel built on it: the chain's 15 products of 32 x 32
// (30.7 kFLOP per point) at the 3xTF32 rate, a third of the TF32 tensor-core
// rate; the input projection, head and contact tests run on the CUDA cores,
// and the streamed bytes (at most 272 B per point) take a fifth of the
// products' time at the memory rate. The design keeps the tensor cores fed:
// net and h never leave the accumulator registers, three warpgroups per SM
// overlap one another's waits, loads and epilogues, and a tile's contact
// gate tests only the contacts near its points (tile_gate).
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
// three 128-point tiles per block.

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
constexpr int kChanStride = 36;         // floats per channel row of a
                                        // channel-major A tile (col_a): 36
                                        // = 4 (mod 16), so its float2 loads
                                        // hit 32 distinct banks

constexpr int kTile = 128;              // points per tile (WINDOW_TILE in
                                        // ops/cuda/decode.py): a warpgroup's
constexpr int kWarps = kTile / 32;      // warps per group
constexpr int kGroups = 3;              // tiles in flight per block
constexpr int kThreads = kTile * kGroups;
constexpr int kRowsPerThread = 2;                  // contact rows culled per
constexpr int kChunk = kRowsPerThread * kTile;     // thread and chunk
constexpr int kWalk = 4;                // kept rows a point tests per step

// Per-group scratch after the blob, in floats:
//   f    [kWarps][32 kRowStride]    the warp's A tile of features (or c_img
//                                   rows): point-major rows of kRowStride
//                                   (tile_a) or channel-major rows of
//                                   kChanStride (col_a)
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
static_assert(kWidth * kChanStride <= 32 * kRowStride, "col_a tile too large");
static_assert(2 * kChunk * 4 <= kPts - kF, "tile_gate's stage exceeds the f tiles");

// Dynamic shared memory of a launch: the blob and kGroups tiles' scratch.
inline int smem_bytes(int n_floats) {
  return (n_floats + kGroups * kGroupFloats) * (int)sizeof(float);
}

// The blob, in floats (pack_window_params):
//   frag [3 NB][2048]         the packed products wc_i, w0_i, w1_i of
//                             each block i (the order above)
//   wp [H][4] (x, y, z, b_in) | bc [NB][H] | b0 [NB][H] | b1 [NB][H]
//   | w_out [H] | b_out [4]   natural channel order
// then a mode-dependent tail:
//   MODE_CIMG:  w_img packed as one more product [2048]
//   MODE_GATED: gproj [F][H] (W_img g_f per finger); the contacts
//               themselves stay in global memory (tile_gate)
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

// The column of the warp's point r (0..31) in a channel-major A tile: rows
// g and g + 8 of each m16 tile side by side, so that col_a reads both with
// one float2 load.
__device__ __forceinline__ int a_col(int r) {
  return (r & 16) | ((r & 7) << 1) | ((r >> 3) & 1);
}

// A fragments read from a channel-major tile (kWidth rows of kChanStride,
// point r at column a_col(r)), as load_cols writes it.
__device__ __forceinline__ void col_a(const float* __restrict__ x, int mi,
                                      int jk, float (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r = x + (8 * jk + 2 * t) * kChanStride + 16 * mi + 2 * g;
  const float2 k0 = *reinterpret_cast<const float2*>(r);
  const float2 k1 = *reinterpret_cast<const float2*>(r + kChanStride);
  a[0] = k0.x;
  a[1] = k0.y;
  a[2] = k1.x;
  a[3] = k1.y;
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

// The chain from `net` (the input projection) with the warp's features,
// whose A fragments load_f(mi, jk, a) reads (tile_a or col_a), then the
// output head. Returns, for the lanes with t == 0, the logits of rows g,
// g + 8, 16 + g, 24 + g in out[0..3] (other lanes hold partial sums).
//
// Each product accumulates from its bias in an accumulator of its own and
// is then added to net in f32: the tensor cores round each mma's sum at
// the scale of its accumulator, and net grows along the chain (logits of
// order 10), so accumulating into net itself loses the products' low bits
// twelve times per product.
template <class LoadF>
__device__ __forceinline__ void chain(const float* __restrict__ sm,
                                      const Layout& L, int NB, Acc& net,
                                      LoadF load_f, float (&out)[4]) {
  const float* frag = sm + L.frag;
  for (int b = 0; b < NB; ++b) {
    Acc h, d;
    set_cols(d, sm + L.bc + b * kWidth);
    product(frag + (3 * b + 0) * kFragFloats, d, load_f);
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

// ---- The tile loop ---------------------------------------------------------

// f32 values of streamed operands, stored as f32 or as bf16 bits (uint16_t:
// a bf16 value is the high half of its f32).
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// The warp's 32 points n0 + r of the (kWidth, N) channels-first rows `src`
// into the channel-major A tile x (col_a), zero past N. Lane r loads point
// n0 + r of every channel: each channel is one coalesced 128 B row (64 B in
// bf16), all 32 in flight, and the stores hit distinct banks.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ src, long long n0,
                                          long long N, float* __restrict__ x) {
  const int lane = threadIdx.x & 31;
  const long long n = n0 + lane;
  float v[kWidth];
#pragma unroll
  for (int c = 0; c < kWidth; ++c) v[c] = n < N ? load_f32(src + c * N + n) : 0.f;
  const int col = a_col(lane);
#pragma unroll
  for (int c = 0; c < kWidth; ++c) x[c * kChanStride + col] = v[c];
}

__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / kTile), "r"(kTile)
               : "memory");
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

// The contact gate of the group's tile (K1, K4): the finger whose feature
// this lane's point (px, py, pz) takes into its input projection, or -1.
// The rows
// q[0 .. rows) are (qx, qy, qz, |q|^2) in finger order, K per finger, in
// global memory; an invalid row carries |q|^2 = -1 and is never kept.
//
// A point gates on q when the expanded distance d = (|q|^2 + |p|^2) - 2 q.p,
// rounded step by step, is below r^2; the decision is that of the last
// finger with such a contact. The tile's box (a reduction over its valid
// points) keeps only the contacts with dist(q, box)^2 <= r^2 + m. Each
// rounding of d is at most u = 2^-24 relative, so |d - |q - p|^2| <=
// 8u (|q|^2 + |p|^2 + r^2) (three for each squared norm and the dot
// product, one for each of the sum and the difference, which is near r^2
// where it matters). Every hit thus has |q - p|^2 < r^2 + 8u (...), and
// dist(q, box) <= |q - p|. The gate takes m = 2^-19 (|q|^2 + P^2 + r^2),
// P^2 the largest |p|^2 of the box: four times that bound, which also
// covers the rounding of the box distance itself. With |q|^2, |p|^2 <= 1
// and r = 0.015, m <= 3.8e-6, a margin of about m / 2r = 1.3e-4 in
// distance. So no point loses a hit.
//
// The warpgroup culls kChunk rows at a time, from the last chunk back, each
// warp publishing one ballot mask per 32 rows and staging the chunk's rows
// in the group's f tiles, which are free until the gate returns (shared
// memory does not grow with the contact count). Each point without a
// finger yet tests the kept rows from the last, kWalk per step so that
// their loads overlap: its first hit is in the last finger that has one,
// the decision of the unculled loop. A tile of points close together
// (sorted by super-cell, or one x-row of the mesh lattice) keeps few of the
// valid contacts; a tile spread over the box keeps them all, and then the
// walk is most of the gate's time. Every barrier is taken by all threads:
// on the H100, versions that staged or closed only when rows were kept
// (a barrier behind a branch) ran the sparse tiles 0.05-0.2 ms slower.
__device__ __forceinline__ int tile_gate(const float4* __restrict__ q, int rows,
                                         int K, float* scratch, float r2,
                                         bool valid, float px, float py,
                                         float pz) {
  const int gi = threadIdx.x % kTile, warp = gi / 32, lane = threadIdx.x & 31;
  float* part = scratch + kPart;
  unsigned* masks = reinterpret_cast<unsigned*>(scratch + kMask);
  float4* stage = reinterpret_cast<float4*>(scratch + kF);   // [2][kChunk]

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
  group_sync();
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

  // the expanded distance test of a point, rounded step by step
  const auto hits = [&](float4 e) {
    const float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(e.x, px), __fmul_rn(e.y, py)), __fmul_rn(e.z, pz));
    return __fsub_rn(__fadd_rn(e.w, p2), __fmul_rn(2.f, dot)) < r2;
  };

  // Each chunk: its rows staged and one ballot mask per 32 rows (barrier),
  // then every point without a finger yet tests the kept rows from the
  // last. Masks and rows are double-buffered, so one barrier per chunk
  // orders them.
  int sel = -1;
  for (int buf = 0; c0 >= 0; c0 -= kChunk, buf ^= 1) {
    unsigned* mk = masks + buf * kRowsPerThread * kWarps;
    float4* st = stage + buf * kChunk;
    float4 next[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      next[j] = c0 >= kChunk ? __ldg(q + c0 - kChunk + j * kTile + gi) : none;
      st[j * kTile + gi] = c[j];
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
    group_sync();
    for (int s = kRowsPerThread * kWarps - 1; s >= 0 && valid && sel < 0; --s) {
      for (unsigned m = mk[s]; m != 0u;) {
        int bit[kWalk];   // the next kWalk kept rows, last first (repeated
        bool hit[kWalk];  // when fewer remain)
        bit[0] = 31 - __clz(m);
        m ^= 1u << bit[0];
#pragma unroll
        for (int i = 1; i < kWalk; ++i) {
          bit[i] = m != 0u ? 31 - __clz(m) : bit[i - 1];
          m &= ~(1u << bit[i]);
        }
#pragma unroll
        for (int i = 0; i < kWalk; ++i) hit[i] = hits(st[32 * s + bit[i]]);
        int first = -1;
#pragma unroll
        for (int i = kWalk - 1; i >= 0; --i) first = hit[i] ? bit[i] : first;
        if (first >= 0) {
          sel = (c0 + 32 * s + first) / K;
          break;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) c[j] = next[j];
  }
  group_sync();   // the stage is the f tiles the caller writes next
  return sel;
}

// The blob staged in the block's dynamic shared memory (all threads call
// this once), and each warp's scratch after it.
__device__ __forceinline__ const float* stage_blob(const float* __restrict__ blob,
                                                   int n_floats) {
  extern __shared__ float4 smem4[];
  const float4* blob4 = reinterpret_cast<const float4*>(blob);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x) smem4[i] = blob4[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma
  __syncthreads();
  return reinterpret_cast<const float*>(smem4);
}

struct WarpScratch {
  float* group;   // the group's scratch (tile_gate)
  float* f;       // the warp's A tile
  float* pts;     // its points' coordinates [3][32]
  int* sel;       // their gated fingers [32]
};

__device__ __forceinline__ WarpScratch warp_scratch(const float* sm, int n_floats) {
  const int group = threadIdx.x / kTile, warp = (threadIdx.x % kTile) / 32;
  float* s = const_cast<float*>(sm) + n_floats + group * kGroupFloats;
  return {s, s + kF + warp * 32 * kRowStride, s + kPts + warp * 96,
          reinterpret_cast<int*>(s + kSel) + warp * 32};
}

// body(n0) for each tile of this warp's group, n0 the first of the warp's
// 32 points in it: tiles blockIdx.x kGroups + group, strided by the grid.
template <class Body>
__device__ __forceinline__ void for_each_tile(long long N, Body body) {
  const int group = threadIdx.x / kTile, warp = (threadIdx.x % kTile) / 32;
  const long long n_tiles = (N + kTile - 1) / kTile;
  for (long long ti = (long long)blockIdx.x * kGroups + group; ti < n_tiles;
       ti += (long long)gridDim.x * kGroups)
    body(ti * kTile + warp * 32);
}

// The rest of a tile once the warp's pts, sel (MODE_GATED) and features are
// in place: the input projection W_in p + b_in on the CUDA cores, plus the
// gated finger's row W_img g_f (MODE_GATED) or the c_img product `img`
// (MODE_CIMG); the chain; the logits of the warp's points n0 + r < N.
template <int MODE, class LoadF>
__device__ __forceinline__ void finish_tile(const float* __restrict__ sm,
                                            const Layout& L, int NB,
                                            const WarpScratch& ws, const Acc& img,
                                            LoadF load_f, long long n0, long long N,
                                            float* __restrict__ out) {
  Acc net;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = acc_row(mi, e);
      const float rx = ws.pts[row], ry = ws.pts[32 + row], rz = ws.pts[64 + row];
      const int s = MODE == MODE_GATED ? ws.sel[row] : -1;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = acc_col(jn, e);
        const float4 w = reinterpret_cast<const float4*>(sm + L.wp)[col];
        float v = fmaf(w.z, rz, fmaf(w.y, ry, w.x * rx)) + w.w;
        if (s >= 0) v += sm[L.tail + s * kWidth + col];
        net[mi][jn][e] = v;
      }
    }
  }
  if (MODE == MODE_CIMG) add(net, img);

  float o[4];
  chain(sm, L, NB, net, load_f, o);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long m = n0 + acc_row(k >> 1, 2 * (k & 1));
      if (m < N) out[m] = o[k];
    }
  }
}

// Launches a tile kernel of kThreads threads and smem_bytes(n_floats) of
// dynamic shared memory on as many blocks as the SMs hold at once (fewer
// for small N): each block stages the blob once and strides over tiles.
// Returns a cudaError_t.
template <class Kernel, class... Args>
int launch_tiles(Kernel kernel, int n_floats, long long N, cudaStream_t stream,
                 Args... args) {
  if (n_floats % 4) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
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
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tile
