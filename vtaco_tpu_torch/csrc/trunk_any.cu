// Fused occupancy-decoder trunk for Hopper (sm_90a) at any decoder width:
// the width-generic form of the four trunk kernels, for every (hidden, C,
// Ci, n_blocks) that the tile chain of tile_chain.cuh (hidden = C = 32)
// does not take. It replaces the same Pallas kernels of
// vtaco_tpu/ops/pallas/decode.py, which read their widths from the
// operands (fused_trunk_cn :457, fused_trunk_gated_cn :538 and both
// branches of fused_trunk_window_cn :294):
//   MODE_COORDS  K2, input projection of the coords only; also over B
//                objects at once (K2 under the JAX package's vmap)
//   MODE_CIMG    K2 with precomputed (Ci, N) c_img rows, Ci any width
//   MODE_GATED   K1, contact gating fused in
// and, with the trilinear gather of the (R, R, R, C) grid in place of the
// streamed features (WINDOW), K3 (coords, c_img) and K4 (gated).
//
// What it computes, per query point n: the trunk of ops/fast_trunk.py
// trunk_cn,
//   net = W_p p + b_in [+ W_img c_img | + W_img g_f of the gated finger]
//   for each block i: net += Wc_i f + bc_i
//                     h    = W0_i relu(net) + b0_i
//                     net += W1_i relu(h) + b1_i
//   out = w_out . relu(net) + b_out
// with the gate of trunk.cu (the last finger with a valid contact q at
// (|q|^2 + |p|^2) - 2 q.p < r^2, rounded step by step) and the coordinates,
// keys and corner lerps of window.cu, so the gates and super-cell keys are
// those of the tile kernels bit for bit.
//
// What bounds it on this card: the chain's products, 2 (C H + 2 H^2) n_blocks
// operations per point (2.6 MFLOP at hidden 256, C 512, 5 blocks), on the
// tensor cores in 3xTF32 at a third of the TF32 rate, 495/3 TFLOP/s (and
// mma.sync, unlike wgmma, does not reach the full TF32 rate); the
// streamed operands (4 (3 + C [+ Ci]) B per point) are small beside them
// at every width above 16. At large hidden a second bound appears: each
// tile reads every weight of the chain from L2 once (5.3 MB at 256 x 512
// x 5, 42 MB at hidden 1,024), and the tile shrinks as hidden grows (net
// and h must stay resident: T = 64 at hidden 256, 16 at 1,024), so the
// L2 reads of the weights take about as long as the products at hidden
// 256 and longer from there on.
//
// What the design does about each:
// - The products run on the tensor cores: mma.sync m16n8k8 .tf32, points
//   along M, output channels along N, input channels along K. TF32 keeps
//   10 mantissa bits, too few for 1e-4 against the IEEE f32 plain trunk, so
//   every operand x is split as hi = rna(x), lo = rna(x - hi) (as
//   tile_chain.cuh; lo's rounding is left to the tensor cores' truncation,
//   see split) and each k8 step accumulates lo.hi + hi.lo + hi.hi, small
//   terms first. The tensor cores truncate each mma's f32 sum at the scale
//   of its accumulator (about 2^-23 of it per mma, 384 mma per accumulator
//   at K = 1,024), so each k-slice of KS input channels accumulates from
//   zero in registers and is then added to the product's accumulator in
//   IEEE f32; each product accumulates from its bias in an accumulator of
//   its own and is then added to net (or stored as h).
// - A block owns a tile of T points; shared memory holds net and h (T x
//   hidden, point-major rows of hidden + 4 floats: conflict-free A
//   fragments) for the whole chain, since net is the residual, and
//   nothing else that grows with a width: the weights and the streamed
//   feature or c_img rows pass through double-buffered k-slices of KS
//   input channels, loaded with cp.async one slice ahead of the products.
//   So the tile depends on hidden alone (ops/cuda/decode.py any_plan
//   chooses it and passes it to the launch), and C and Ci may be any size.
// - The weights of a slice are staged once per block and shared by all
//   its warps (rows XOR-swizzled in 16-byte chunks: conflict-free B
//   fragments without padding). Eight warps tile the T x hidden output, 32
//   points x 64 channels each (16 x 128 from hidden 520 on, where T = 16):
//   the largest T that net and h allow buys the most reuse of each
//   weight slice read from L2.
// - KS is a compile-time constant (32 or 16, 8 from hidden 520 on), so a
//   slice's k8 steps unroll into one branch-free block: a warp whose n8
//   tiles reach past hidden reads a valid row for them and drops their
//   sums, and a short last slice reads zero-filled weights. The scheduler
//   then overlaps one step's loads and splits with the last step's mma,
//   which runtime guards around each n8 tile had serialized. Each
//   thread's staging addresses are fixed within a product and only
//   advance from slice to slice.
// - Widths: pack_any_params pads hidden, C and Ci to multiples of 8 with
//   zero weights and biases; the kernel zero-fills the streamed rows past C
//   or Ci (and the points past N) as it stages them. A padded hidden
//   channel stays 0 through every ReLU and meets zero columns and a zero
//   w_out, so every width takes this one route, exactly.
// - The hi/lo split happens here, on each fragment as it is read from a
//   staged slice, so the per-call packing on the host side stays a pad and
//   a concatenation.
// - The window modes gather once per call: a first kernel interpolates
//   the grid at every point into a (C, N) scratch (channels-fast reads of
//   the grid, transposed through shared memory into coalesced rows) and
//   writes the keys; the trunk kernel then streams that scratch as K2
//   streams its features. A per-slice gather inside the trunk kernel would
//   repeat the eight corner reads of every channel for each block's fc_c
//   and stall on them (they cannot use cp.async); the scratch costs one
//   write and n_blocks reads of 4 C B per point. K3 against K2 at the same
//   widths in chip_smoke.py's widths phase measures what the gather and
//   the scratch cost (PERF.md); a per-slice gather was not built.
// - The gate: the contact rows are staged in shared memory (the weight
//   and streamed buffers, free before the chain) in chunks from the last
//   row down; every thread of the block scans its share of a chunk's rows
//   from the last back, kGateRows rows a step, and stops at the step of
//   its first hit; the largest hit row of the point (a shared atomicMax)
//   names its finger, and the tile stops at the chunk that leaves no
//   point searching.
// - Objects (K2 batched): block b ceil(N / T) + i is object b's tile i.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_COORDS = 0, MODE_CIMG = 1, MODE_GATED = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGatherPts = 32;       // points per block of the window's gather
constexpr int kGateRows = 8;         // contact rows a gate step tests at once

inline int pad8(int x) { return (x + 7) & ~7; }

// Shared memory of a tile, in floats: net, h [T][Hp + 4] | weight slices
// 2 x [wch][KS] | streamed slices 2 x [KS][T + 8] | pts [3][T] | sel [T].
inline long long smem_floats(int Hp, int T, int wch, int KS) {
  return 2LL * T * (Hp + 4) + 2LL * wch * KS + 2LL * KS * (T + 8) + 4LL * T;
}

// The blob, in floats (ops/cuda/decode.py pack_any_params), natural order,
// every width padded to a multiple of 8 (Hp, Cp) with zeros:
//   wp [Hp][3] | b_in [Hp] | per block i: wc [Hp][Cp] | bc [Hp] | w0 [Hp][Hp]
//   | b0 [Hp] | w1 [Hp][Hp] | b1 [Hp] | w_out [Hp] | b_out [8]
// then a mode-dependent tail: MODE_CIMG w_img [Hp][Cip]; MODE_GATED gproj
// [F][Hp] (W_img g_f per finger). Every section starts at a multiple of 8
// floats, so weight rows load as 16-byte chunks.
struct Layout {
  long long wp, bin, block, stride, wout, bout, tail;
};

__host__ __device__ inline Layout make_layout(int Hp, int Cp, int NB) {
  Layout L;
  L.wp = 0;
  L.bin = 3LL * Hp;
  L.block = 4LL * Hp;
  L.stride = (long long)Hp * Cp + Hp + 2 * ((long long)Hp * Hp + Hp);
  L.wout = L.block + NB * L.stride;
  L.bout = L.wout + Hp;
  L.tail = L.bout + 8;
  return L;
}

struct Args {
  const float* blob;
  int H, C, Ci, NB;         // widths; Ci the c_img rows (MODE_CIMG)
  int Hp, Cp, Cip;          // padded to multiples of 8
  int T, WO, chunk;         // the tile (launch)
  const float4* contacts;   // (F K) rows (q, |q|^2 or -1), finger order
  int F, K;
  float r2;
  const void* p;            // (3, N) [per object, p_stride apart]
  long long p_stride;
  const void* feats;        // (C, N) [per object, f_stride apart]
  long long f_stride;
  const void* c_img;        // (Ci, N)
  float* out;               // (B, N)
  long long N;
  int B;
  int vec;                  // f32 rows stage as 16-byte chunks (N % 4 == 0)
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32), as
// two integer operations (tile_chain.cuh tf32_rna).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = rna(x) and lo = rna(x - hi) as the tensor cores read them: an mma
// takes the top 19 bits of a .tf32 operand, so lo is passed with half an
// ulp added and its low bits left in place (CUTLASS's
// round_half_ulp_truncate), the same value as tf32_rna in one operation
// fewer. hi is masked: x - hi must be exact.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += A B for one m16n8k8 tile: a the A fragment (rows g, g + 8; k t,
// t + 4 of lane 4g + t), b0, b1 the B fragment (k t, t + 4; column g).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage ks streamed rows k0.. of `src` ((rows, N), row stride N) for the
// tile's points n0.. into ab ([KS][T + 8]), rows past `rows` and points
// past N as zeros: f32 by cp.async (16-byte chunks when a.vec), bf16
// through registers. tq_shift is log2(T / 4). A thread keeps one column
// and walks down the rows.
__device__ __forceinline__ void stage_rows(const Args& a, float* ab, const float* src,
                                           int rows, int k0, int ks, long long n0,
                                           int tq_shift) {
  const int SB = a.T + 8;
  const int sh = a.vec ? tq_shift : tq_shift + 2;  // log2 of the columns a row
  const int w = a.vec ? 4 : 1;                     // floats a column
  const int kstep = kThreads >> sh;
  const int k = threadIdx.x >> sh, c = threadIdx.x & ((1 << sh) - 1);
  const long long n = n0 + w * c;
  float* d = ab + k * SB + w * c;
  const float* f = src + (long long)(k0 + k) * a.N + n;
  for (int kk = k; kk < ks; kk += kstep, d += kstep * SB, f += kstep * a.N) {
    const bool ok = k0 + kk < rows && n < a.N;
    if (a.vec)
      cp_async16(d, ok ? f : src, ok);
    else
      cp_async4(d, ok ? f : src, ok);
  }
}

__device__ __forceinline__ void stage_rows(const Args& a, float* ab, const uint16_t* src,
                                           int rows, int k0, int ks, long long n0,
                                           int tq_shift) {
  const int SB = a.T + 8, sh = tq_shift + 2, kstep = kThreads >> sh;
  const int k = threadIdx.x >> sh, c = threadIdx.x & ((1 << sh) - 1);
  const long long n = n0 + c;
  for (int kk = k; kk < ks; kk += kstep)
    ab[kk * SB + c] =
        (k0 + kk < rows && n < a.N) ? load_f32(src + (long long)(k0 + kk) * a.N + n) : 0.f;
}

// Stage k-slice s of a product's output chunk o0 into buffer buf: the
// weight rows of the chunk (W (Hp, Kp)), 16-byte chunks XOR-swizzled by
// row, chunks past Kp zero-filled (so a short last slice adds nothing),
// and the streamed rows of src (null for none).
template <typename TS, int KS>
__device__ __forceinline__ void stage(const Args& a, float* wbuf, float* abuf,
                                      const float* W, int Kp, const TS* src,
                                      int src_rows, int o0, int s, int buf,
                                      long long n0) {
  constexpr int QS = KS / 4;                       // 16-byte chunks a weight row
  constexpr int SWS = KS == 32 ? 0 : KS == 16 ? 1 : 2;   // rows a swizzle step
  constexpr int RSTEP = kThreads / QS;             // rows between a thread's chunks
  // a thread copies chunk c of rows r, r + RSTEP, ..., whose swizzle is the
  // same ((r >> SWS) & (QS - 1) does not change by RSTEP)
  const int r = threadIdx.x / QS, c = threadIdx.x % QS;
  const int rows_w = min(a.chunk, a.Hp - o0);
  const int k0 = s * KS, qv = (Kp - k0) >> 2;
  const bool valid = c < qv;
  float* dst = wbuf + buf * min(a.Hp, a.chunk) * KS + r * KS +
               ((c ^ ((r >> SWS) & (QS - 1))) << 2);
  const float* from = W + (long long)(o0 + r) * Kp + k0 + 4 * min(c, qv - 1);
  const long long step = (long long)RSTEP * Kp;
  for (int rr = r; rr < rows_w; rr += RSTEP, dst += RSTEP * KS, from += step)
    cp_async16(dst, from, valid);
  if (src != nullptr)
    stage_rows(a, abuf + buf * KS * (a.T + 8), src, src_rows, k0, KS, n0,
               __ffs(a.T >> 2) - 1);
}

// One product of the chain: dst[t][o] = (add ? dst[t][o] : 0) + (bias[o] +
// sum_k W[o][k] x[t][k]) for the tile's T points and every o < Hp, bias
// null for a zero bias. W is (Hp, Kp) in device memory; x is relu(act)
// (STREAM false: net or h, [T][Hp + 4] in shared memory, Kp = Hp) or the
// streamed rows of src (STREAM true: (src_rows, N) rows, zero past
// src_rows). Each k8 step has no branch: a warp whose n8 tiles
// reach past hidden reads a valid weight row for them (its last) and never
// stores their sums, so its loads, splits and mma interleave freely. All
// threads call it.
template <typename TS, int MT, int KS, bool STREAM>
__device__ __forceinline__ void product(const Args& a, float* wbuf, float* abuf,
                                        const float* __restrict__ W, int Kp,
                                        const float* __restrict__ bias, const float* act,
                                        const TS* src, int src_rows, float* dst, bool add,
                                        long long n0) {
  constexpr int NT = 16 / MT;
  constexpr int QS = KS / 4;
  constexpr int SWS = KS == 32 ? 0 : KS == 16 ? 1 : 2;
  const int T = a.T, SA = a.Hp + 4, SB = T + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp / a.WO) * MT * 16;          // the warp's first point
  const int nl = (warp % a.WO) * NT * 8;           // its first channel in a chunk
  const int sw = (g >> SWS) & (QS - 1);            // the lane's row swizzle
  const int wch = min(a.Hp, a.chunk);
  const int ns = (Kp + KS - 1) / KS;
  for (int o0 = 0; o0 < a.Hp; o0 += a.chunk) {
    const int rows_w = min(a.chunk, a.Hp - o0);   // weight rows of this chunk
    float acc[MT][NT][4];
    int wrow[NT];                                  // the lane's B row of each n8 tile
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      wrow[jn] = min(nl + 8 * jn + g, rows_w - 1) * KS + t;
      float2 b = make_float2(0.f, 0.f);
      if (bias != nullptr && nl + 8 * jn < rows_w)
        b = __ldg(reinterpret_cast<const float2*>(bias + o0 + nl + 8 * jn + 2 * t));
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        acc[mi][jn][0] = b.x;
        acc[mi][jn][1] = b.y;
        acc[mi][jn][2] = b.x;
        acc[mi][jn][3] = b.y;
      }
    }
    stage<TS, KS>(a, wbuf, abuf, W, Kp, src, src_rows, o0, 0, 0, n0);
    cp_commit();
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) {
        stage<TS, KS>(a, wbuf, abuf, W, Kp, src, src_rows, o0, s + 1, (s + 1) & 1, n0);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* wb = wbuf + (s & 1) * wch * KS;
      const float* ab = STREAM ? abuf + (s & 1) * KS * SB + t * SB + m0 + g
                               : act + (m0 + g) * SA + s * KS + t;
      float part[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 8) {
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float v[4];
          if (STREAM) {
            const float* x = ab + kk * SB + 16 * mi;
            v[0] = x[0];
            v[1] = x[8];
            v[2] = x[4 * SB];
            v[3] = x[4 * SB + 8];
          } else {
            const float* x = ab + 16 * mi * SA + kk;
            v[0] = fmaxf(x[0], 0.f);
            v[1] = fmaxf(x[8 * SA], 0.f);
            v[2] = fmaxf(x[4], 0.f);
            v[3] = fmaxf(x[8 * SA + 4], 0.f);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], ahi[mi][e], alo[mi][e]);
        }
        // every B fragment of the k8 step, then three passes over the MT x
        // NT tiles (small terms first), so that 16 independent mma
        // separate two that share an accumulator
        const int c0 = kk >> 2;
        const int col0 = (c0 ^ sw) << 2, col1 = ((c0 + 1) ^ sw) << 2;
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          split(wb[wrow[jn] + col0], bhi[jn][0], blo[jn][0]);
          split(wb[wrow[jn] + col1], bhi[jn][1], blo[jn][1]);
        }
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma(part[mi][jn], alo[mi], bhi[jn][0], bhi[jn][1]);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma(part[mi][jn], ahi[mi], blo[jn][0], blo[jn][1]);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma(part[mi][jn], ahi[mi], bhi[jn][0], bhi[jn][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][jn][e] += part[mi][jn][e];
      __syncthreads();
    }
    // accumulator element e of (mi, jn): point m0 + 16 mi + g + 8 (e >> 1),
    // channel o0 + nl + 8 jn + 2 t + (e & 1)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      if (nl + 8 * jn < rows_w) {
        const int ch = o0 + nl + 8 * jn + 2 * t;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int pt = m0 + 16 * mi + g;
          float2* top = reinterpret_cast<float2*>(dst + pt * SA + ch);
          float2* bot = reinterpret_cast<float2*>(dst + (pt + 8) * SA + ch);
          float2 v0 = make_float2(acc[mi][jn][0], acc[mi][jn][1]);
          float2 v1 = make_float2(acc[mi][jn][2], acc[mi][jn][3]);
          if (add) {
            const float2 x0 = *top, x1 = *bot;
            v0.x += x0.x;
            v0.y += x0.y;
            v1.x += x1.x;
            v1.y += x1.y;
          }
          *top = v0;
          *bot = v1;
        }
      }
    }
  }
}

// window.cu's base corner and fractional position along one axis.
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

template <typename TS, int MODE, int MT, int KS>
__global__ void __launch_bounds__(kThreads, 1) trunk_any_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int T = a.T, Hp = a.Hp, SA = Hp + 4;
  const int wch = Hp < a.chunk ? Hp : a.chunk;
  float* net = sm;
  float* hb = net + T * SA;
  float* wbuf = hb + T * SA;
  float* abuf = wbuf + 2 * wch * KS;
  float* pts = abuf + 2 * KS * (T + 8);
  int* sel = reinterpret_cast<int*>(pts + 3 * T);
  const Layout Lw = make_layout(Hp, a.Cp, a.NB);
  const float* blob = a.blob;

  const long long per_object = (a.N + T - 1) / T;
  const long long ob = blockIdx.x / per_object;
  const long long n0 = (blockIdx.x - ob * per_object) * T;
  const TS* p = static_cast<const TS*>(a.p) + ob * a.p_stride;
  const TS* feats = static_cast<const TS*>(a.feats) + ob * a.f_stride;
  float* out = a.out + ob * a.N;
  const int tid = threadIdx.x;

  for (int t = tid; t < T; t += kThreads) {
    const long long n = n0 + t;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (n < a.N) {
      px = load_f32(p + n);
      py = load_f32(p + a.N + n);
      pz = load_f32(p + 2 * a.N + n);
    }
    pts[t] = px;
    pts[T + t] = py;
    pts[2 * T + t] = pz;
    sel[t] = -1;
    net[t * SA + Hp] = net[t * SA + Hp + 1] = net[t * SA + Hp + 2] = net[t * SA + Hp + 3] = 0.f;
  }
  // a slice reaching past hidden reads on into the next row (zero weights
  // meet it there), so h starts finite
  for (int i = tid; i < T * SA / 4; i += kThreads)
    reinterpret_cast<float4*>(hb)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the contact gate: the last hit row of each point, then its finger. The
  // rows pass through the weight and streamed buffers (free until the
  // chain) in chunks from the last row down; a point is done at its
  // first hit, and the tile at the chunk that leaves none searching.
  if (MODE == MODE_GATED) {
    const int rows = kThreads / T;
    const int t = tid % T, r = tid / T;
    const float px = pts[t], py = pts[T + t], pz = pts[2 * T + t];
    const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                               __fmul_rn(pz, pz));
    float4* stage4 = reinterpret_cast<float4*>(wbuf);
    const int cap = (2 * wch * KS + 2 * KS * (T + 8)) / 4;
    for (int top = a.F * a.K; top > 0; top -= cap) {
      const int lo = max(top - cap, 0);
      // read before the barrier: past it, the point's other threads (other
      // warps when T < kThreads) may already record their hits in sel
      const bool searching = n0 + t < a.N && sel[t] < 0;
      for (int i = tid; i < top - lo; i += kThreads) stage4[i] = __ldg(a.contacts + lo + i);
      __syncthreads();
      if (searching) {
        // kGateRows rows a step; the first hit in the step (the largest
        // row) ends the point's scan
        for (int j = top - 1 - r; j >= lo; j -= kGateRows * rows) {
          int hit = -1;
#pragma unroll
          for (int u = 0; u < kGateRows; ++u) {
            const int jj = j - u * rows;
            if (jj >= lo) {
              const float4 e = stage4[jj - lo];
              const float dot = __fadd_rn(__fadd_rn(__fmul_rn(e.x, px), __fmul_rn(e.y, py)),
                                          __fmul_rn(e.z, pz));
              // e.w < 0: an invalid row
              if (hit < 0 && e.w >= 0.f &&
                  __fsub_rn(__fadd_rn(e.w, p2), __fmul_rn(2.f, dot)) < a.r2)
                hit = jj;
            }
          }
          if (hit >= 0) {
            atomicMax(sel + t, hit);
            break;
          }
        }
      }
      if (!__syncthreads_or(n0 + t < a.N && sel[t] < 0)) break;
    }
  }

  // the input projection on the coords, plus the gated finger's row (the
  // first product's barriers order it before any read of net)
  for (int idx = tid; idx < T * Hp; idx += kThreads) {
    const int t = idx / Hp, o = idx - t * Hp;
    const float* w = blob + Lw.wp + 3 * o;
    float v = fmaf(w[2], pts[2 * T + t], fmaf(w[1], pts[T + t], w[0] * pts[t])) +
              blob[Lw.bin + o];
    if (MODE == MODE_GATED && sel[t] >= 0)
      v += blob[Lw.tail + (long long)(sel[t] / a.K) * Hp + o];
    net[t * SA + o] = v;
  }
  // the c_img rows through W_img
  const TS* none = nullptr;
  if (MODE == MODE_CIMG)
    product<TS, MT, KS, true>(a, wbuf, abuf, blob + Lw.tail, a.Cip, nullptr, nullptr,
                              static_cast<const TS*>(a.c_img), a.Ci, net, true, n0);

  // the chain
  for (int i = 0; i < a.NB; ++i) {
    const float* wc = blob + Lw.block + i * Lw.stride;
    const float* bc = wc + (long long)Hp * a.Cp;
    const float* w0 = bc + Hp;
    const float* b0 = w0 + (long long)Hp * Hp;
    const float* w1 = b0 + Hp;
    const float* b1 = w1 + (long long)Hp * Hp;
    product<TS, MT, KS, true>(a, wbuf, abuf, wc, a.Cp, bc, nullptr, feats, a.C, net, true,
                              n0);
    product<TS, MT, KS, false>(a, wbuf, abuf, w0, Hp, b0, net, none, 0, hb, false, n0);
    product<TS, MT, KS, false>(a, wbuf, abuf, w1, Hp, b1, hb, none, 0, net, true, n0);
  }
  __syncthreads();

  // the head: the rows of the block share each point's sum
  const int rows = kThreads / T;
  const int t = tid % T, r = tid / T;
  float s = 0.f;
  for (int o = r; o < Hp; o += rows)
    s = fmaf(blob[Lw.wout + o], fmaxf(net[t * SA + o], 0.f), s);
  hb[r * T + t] = s;        // h is free now
  __syncthreads();
  if (r == 0 && n0 + t < a.N) {
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += hb[k * T + t];
    out[n0 + t] = sum + blob[Lw.bout];
  }
}

// The window modes' gather: the trilinear interpolation of the (R, R, R,
// C) channels-last grid at kGatherPts points into the (C, N) scratch, and
// the super-cell keys. Grid rows read channels-fast (coalesced), written
// through a shared transpose as point-fast (coalesced) scratch rows.
struct GatherArgs {
  const float* p;           // (3, N)
  const float* grid;
  float* scratch;           // (C, N)
  int32_t* keys;            // (N,) or null
  long long N;
  int C, R, L, n1;
  float box_eps, u_hi;
};

__global__ void __launch_bounds__(kThreads) gather_kernel(const GatherArgs g) {
  __shared__ float tile[32][kGatherPts + 1];
  __shared__ int cell[kGatherPts];
  __shared__ float wts[3][kGatherPts];
  const long long n0 = (long long)blockIdx.x * kGatherPts;
  const int tid = threadIdx.x;
  if (tid < kGatherPts) {
    const long long n = n0 + tid;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (n < g.N) {
      px = __ldg(g.p + n);
      py = __ldg(g.p + g.N + n);
      pz = __ldg(g.p + 2 * g.N + n);
    }
    float wx, wy, wz;
    const int x0 = axis_base(px, g.box_eps, g.u_hi, g.R, &wx);
    const int y0 = axis_base(py, g.box_eps, g.u_hi, g.R, &wy);
    const int z0 = axis_base(pz, g.box_eps, g.u_hi, g.R, &wz);
    if (n < g.N && g.keys != nullptr)
      g.keys[n] = x0 / g.L + g.n1 * (y0 / g.L + g.n1 * (z0 / g.L));
    cell[tid] = (z0 * g.R + y0) * g.R + x0;
    wts[0][tid] = wx;
    wts[1][tid] = wy;
    wts[2][tid] = wz;
  }
  __syncthreads();
  const int tx = tid & 31, ty = tid >> 5;
  const long long C = g.C;
  const long long dx = C, dy = (long long)g.R * C, dz = (long long)g.R * g.R * C;
  for (int c0 = 0; c0 < g.C; c0 += 32) {
    const int c = c0 + tx;
    if (c < g.C) {
      for (int j = ty; j < kGatherPts; j += kWarps) {
        const float* q = g.grid + (long long)cell[j] * C + c;
        const float wx = wts[0][j], wy = wts[1][j], wz = wts[2][j];
        const float c00 = lerp(__ldg(q), __ldg(q + dx), wx);
        const float c01 = lerp(__ldg(q + dy), __ldg(q + dy + dx), wx);
        const float c10 = lerp(__ldg(q + dz), __ldg(q + dz + dx), wx);
        const float c11 = lerp(__ldg(q + dz + dy), __ldg(q + dz + dy + dx), wx);
        tile[tx][j] = lerp(lerp(c00, c01, wy), lerp(c10, c11, wy), wz);
      }
    }
    __syncthreads();
    for (int j = ty; j < 32; j += kWarps) {
      const long long n = n0 + tx;
      if (c0 + j < g.C && n < g.N) g.scratch[(c0 + j) * g.N + n] = tile[j][tx];
    }
    __syncthreads();
  }
}

template <typename TS, int MODE, int MT, int KS>
int run(const Args& a, int smem, cudaStream_t stream) {
  auto kernel = trunk_any_kernel<TS, MODE, MT, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.B * ((a.N + a.T - 1) / a.T);
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename TS, int MODE>
int run_tile(int MT, int KS, int smem, const Args& a, cudaStream_t s) {
  if (MT == 1 && KS == 8) return run<TS, MODE, 1, 8>(a, smem, s);
  if (MT == 2 && KS == 32) return run<TS, MODE, 2, 32>(a, smem, s);
  if (MT == 2 && KS == 16) return run<TS, MODE, 2, 16>(a, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The tile, as ops/cuda/decode.py any_plan chooses it from hidden: MT m16
// tiles per warp (NT = 16 / MT n8 tiles), WO warps along the output
// channels (kWarps / WO along the points), k-slices of KS input channels
// (an instance's compile-time constant: 32 or 16 with MT = 2, 8 with MT =
// 1). T points and `chunk` output channels at once follow; a tile too
// large for a block's shared memory fails at cudaFuncSetAttribute.
template <typename TS>
int launch(int mode, Args a, int MT, int KS, int WO, cudaStream_t s) {
  if (a.H < 1 || a.C < 1 || a.NB < 0 || a.B < 1 || (MT != 1 && MT != 2) ||
      (WO != 1 && WO != 2 && WO != 4 && WO != kWarps) || !aligned16(a.blob) ||
      (mode == MODE_CIMG && (a.Ci < 1 || a.c_img == nullptr)) ||
      (mode == MODE_GATED && (a.F < 1 || a.K < 1 || a.contacts == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.N <= 0) return (int)cudaSuccess;
  a.Hp = pad8(a.H);
  a.Cp = pad8(a.C);
  a.Cip = mode == MODE_CIMG ? pad8(a.Ci) : 0;
  a.T = (kWarps / WO) * MT * 16;
  a.WO = WO;
  a.chunk = WO * (16 / MT) * 8;
  const long long smem =
      smem_floats(a.Hp, a.T, a.Hp < a.chunk ? a.Hp : a.chunk, KS) * 4;
  a.vec = a.N % 4 == 0 && aligned16(a.feats) &&
          (mode != MODE_CIMG || aligned16(a.c_img));
  if ((long long)a.B * ((a.N + a.T - 1) / a.T) > 0x7fffffffLL || smem > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case MODE_COORDS: return run_tile<TS, MODE_COORDS>(MT, KS, (int)smem, a, s);
    case MODE_CIMG: return run_tile<TS, MODE_CIMG>(MT, KS, (int)smem, a, s);
    case MODE_GATED: return run_tile<TS, MODE_GATED>(MT, KS, (int)smem, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args base_args(const float* blob, int H, int C, int Ci, int NB, const float* contacts,
               int F, int K, float r2) {
  Args a = {};
  a.blob = blob;
  a.H = H;
  a.C = C;
  a.Ci = Ci;
  a.NB = NB;
  a.contacts = reinterpret_cast<const float4*>(contacts);
  a.F = F;
  a.K = K;
  a.r2 = r2;
  a.B = 1;
  return a;
}

}  // namespace

extern "C" {

// K1, K2 and K2 over B objects at any width. blob: pack_any_params's layout
// (16-byte aligned); mode 0 (coords), 1 (c_img rows (Ci, N)) or 2 (gated:
// contacts (F K, 4) f32 rows, 16-byte aligned); MT, KS, WO the tile (see
// launch); p (B, 3, N) with p_stride elements between objects (0: one (3,
// N) shared by all), feats (B, C, N) with f_stride, c_img and out (B, N);
// p, feats and c_img f32 or (bf16 != 0) bf16.
int trunk_any_launch(const float* blob, int H, int C, int Ci, int NB, int mode,
                     const float* contacts, int F, int K, float r2, int MT, int KS,
                     int WO, const void* p, long long p_stride, const void* feats,
                     long long f_stride,
                     const void* c_img, int bf16, float* out, long long N, int B,
                     void* stream) {
  Args a = base_args(blob, H, C, Ci, NB, contacts, F, K, r2);
  a.p = p;
  a.p_stride = p_stride;
  a.feats = feats;
  a.f_stride = f_stride;
  a.c_img = c_img;
  a.out = out;
  a.N = N;
  a.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(mode, a, MT, KS, WO, s)
              : launch<float>(mode, a, MT, KS, WO, s);
}

// K3 (mode 0, 1) and K4 (mode 2) at any width: grid (R, R, R, C) f32
// channels-last, p (3, N) and c_img (Ci, N) f32, scratch (C, N) f32 (the
// gathered features), keys (N,) int32 or null; box_eps, u_hi, L and n1 as
// window.cu's window_cn_launch.
int trunk_any_window_launch(const float* blob, int H, int C, int Ci, int NB, int mode,
                            const float* contacts, int F, int K, float r2, int MT,
                            int KS, int WO, const float* p, const float* grid, int R,
                            float box_eps, float u_hi, int L, int n1, const float* c_img,
                            float* scratch,
                            float* out, int32_t* keys, long long N, void* stream) {
  if (R < 2 || L < 1 || C < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GatherArgs g = {p, grid, scratch, keys, N, C, R, L, n1, box_eps, u_hi};
  const long long blocks = (N + kGatherPts - 1) / kGatherPts;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a = base_args(blob, H, C, Ci, NB, contacts, F, K, r2);
  a.p = p;
  a.feats = scratch;
  a.c_img = c_img;
  a.out = out;
  a.N = N;
  return launch<float>(mode, a, MT, KS, WO, s);
}

}  // extern "C"
