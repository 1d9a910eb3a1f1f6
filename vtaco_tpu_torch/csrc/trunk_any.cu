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
// CUDA cores in IEEE f32 FMA at 67 TFLOP/s; the streamed operands
// (4 (3 + C [+ Ci]) B per point) are small beside them at every width
// above 16.
//
// What the design does about it, simply (a right kernel first):
// - A block owns a tile of T consecutive points (T = 128, 64 or 32, the
//   largest whose activations fit shared memory, chosen by the wrapper from
//   the widths): net and h (hidden x T) and the features or c_img rows
//   (max(C, Ci) x T) stay in shared memory for the whole chain; nothing but
//   the logits goes back to device memory.
// - Each product: thread (t, r) of the block takes point t of the tile and
//   kRO consecutive output channels per pass, rows r strided over the
//   output channels. A warp's 32 lanes hold 32 points of one channel group,
//   so its activations load conflict-free from shared memory and its weight
//   loads are one broadcast address; the weights (at most 5.3 MB at hidden
//   256, C 512) stay resident in the 50 MB L2.
// - Sums are sequential IEEE FMAs from the bias, so the logits agree with
//   the plain trunk at 'highest' far inside 1e-4.
// - The gate: every thread of the block scans its share of the contact
//   rows from the last back and stops at its first hit; the largest hit
//   row of the point (a shared atomicMax) names its finger.
// - Objects (K2 batched): block b ceil(N / T) + i is object b's tile i.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { MODE_COORDS = 0, MODE_CIMG = 1, MODE_GATED = 2 };

constexpr int kThreads = 256;
constexpr int kRO = 4;       // output channels per thread and pass

// The blob, in floats (ops/cuda/decode.py pack_any_params), natural order:
//   wp [H][3] | b_in [H] | per block i: wc [H][C] | bc [H] | w0 [H][H] | b0 [H]
//   | w1 [H][H] | b1 [H] | w_out [H] | b_out [1]
// then a mode-dependent tail: MODE_CIMG w_img [H][Ci]; MODE_GATED gproj
// [F][H] (W_img g_f per finger).
struct Layout {
  int wp, bin, block, stride, wout, bout, tail;
};

__host__ __device__ inline Layout make_layout(int H, int C, int NB) {
  Layout L;
  L.wp = 0;
  L.bin = 3 * H;
  L.block = 4 * H;
  L.stride = H * C + H + 2 * (H * H + H);
  L.wout = L.block + NB * L.stride;
  L.bout = L.wout + H;
  L.tail = L.bout + 1;
  return L;
}

// Shared memory of a tile of T points, in floats: net, h [H][T] | f
// [max(C, Ci)][T] | pts [3][T] | sel [T] (int) | cell [T] (int) | w [3][T].
// ops/cuda/decode.py any_smem_bytes mirrors it to choose T; a T too large
// fails the launch at cudaFuncSetAttribute.
inline long long smem_floats(int H, int C, int Ci, int T) {
  const int cf = C > Ci ? C : Ci;
  return (long long)T * (2 * H + cf + 8);
}

struct Args {
  const float* blob;
  int H, C, Ci, NB, T;
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
  const float* grid;        // WINDOW: (R, R, R, C) channels-last
  int R;
  float box_eps, u_hi;
  int L, n1;
  int32_t* keys;            // WINDOW: (N,) super-cell keys, or null
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// y[o][t] = (ACCUM ? y[o][t] : 0) + (b[o] + sum_i W[o][i] act(x[i][t])) for
// o < out, t < T; b may be null (a zero bias). All threads call it.
template <bool RELU, bool ACCUM>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ b, int out, int in,
                                      const float* x, float* y, int T) {
  const int rows = blockDim.x / T;
  const int t = threadIdx.x % T, r = threadIdx.x / T;
  for (int o0 = r * kRO; o0 < out; o0 += rows * kRO) {
    float acc[kRO];
#pragma unroll
    for (int j = 0; j < kRO; ++j)
      acc[j] = (b != nullptr && o0 + j < out) ? __ldg(b + o0 + j) : 0.f;
    const float* w = W + (long long)o0 * in;
    if (o0 + kRO <= out) {
      for (int i = 0; i < in; ++i) {
        float v = x[i * T + t];
        if (RELU) v = fmaxf(v, 0.f);
#pragma unroll
        for (int j = 0; j < kRO; ++j) acc[j] = fmaf(__ldg(w + j * in + i), v, acc[j]);
      }
    } else {
      for (int i = 0; i < in; ++i) {
        float v = x[i * T + t];
        if (RELU) v = fmaxf(v, 0.f);
#pragma unroll
        for (int j = 0; j < kRO; ++j)
          if (o0 + j < out) acc[j] = fmaf(__ldg(w + j * in + i), v, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRO; ++j) {
      if (o0 + j < out) {
        float* dst = y + (o0 + j) * T + t;
        *dst = ACCUM ? *dst + acc[j] : acc[j];
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

template <typename T, int MODE, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
trunk_any_kernel(const Args a) {
  extern __shared__ float sm[];
  const int H = a.H, C = a.C, TT = a.T;
  const int cf = a.C > a.Ci ? a.C : a.Ci;
  float* net = sm;
  float* h = net + H * TT;
  float* f = h + H * TT;
  float* pts = f + cf * TT;
  int* sel = reinterpret_cast<int*>(pts + 3 * TT);
  int* cell = sel + TT;
  float* wts = reinterpret_cast<float*>(cell + TT);
  const Layout Lw = make_layout(H, C, a.NB);
  const float* blob = a.blob;

  const long long per_object = (a.N + TT - 1) / TT;
  const long long ob = blockIdx.x / per_object;
  const long long n0 = (blockIdx.x - ob * per_object) * TT;
  const T* p = static_cast<const T*>(a.p) + ob * a.p_stride;
  const T* feats = static_cast<const T*>(a.feats) + ob * a.f_stride;
  float* out = a.out + ob * a.N;
  const int tid = threadIdx.x;

  // coordinates (and the window's corners, weights and keys)
  for (int t = tid; t < TT; t += blockDim.x) {
    const long long n = n0 + t;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (n < a.N) {
      px = load_f32(p + n);
      py = load_f32(p + a.N + n);
      pz = load_f32(p + 2 * a.N + n);
    }
    pts[t] = px;
    pts[TT + t] = py;
    pts[2 * TT + t] = pz;
    sel[t] = -1;
    if (WINDOW) {
      float wx, wy, wz;
      const int x0 = axis_base(px, a.box_eps, a.u_hi, a.R, &wx);
      const int y0 = axis_base(py, a.box_eps, a.u_hi, a.R, &wy);
      const int z0 = axis_base(pz, a.box_eps, a.u_hi, a.R, &wz);
      if (n < a.N && a.keys != nullptr)
        a.keys[n] = x0 / a.L + a.n1 * (y0 / a.L + a.n1 * (z0 / a.L));
      cell[t] = (z0 * a.R + y0) * a.R + x0;
      wts[t] = wx;
      wts[TT + t] = wy;
      wts[2 * TT + t] = wz;
    }
  }
  __syncthreads();

  // the contact gate: the last hit row of each point, then its finger
  if (MODE == MODE_GATED) {
    const int rows = blockDim.x / TT;
    const int t = tid % TT, r = tid / TT;
    if (n0 + t < a.N) {
      const float px = pts[t], py = pts[TT + t], pz = pts[2 * TT + t];
      const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                                 __fmul_rn(pz, pz));
      for (int j = a.F * a.K - 1 - r; j >= 0; j -= rows) {
        const float4 e = __ldg(a.contacts + j);
        if (e.w < 0.f) continue;          // an invalid row
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(e.x, px), __fmul_rn(e.y, py)),
                                    __fmul_rn(e.z, pz));
        if (__fsub_rn(__fadd_rn(e.w, p2), __fmul_rn(2.f, dot)) < a.r2) {
          atomicMax(sel + t, j);
          break;
        }
      }
    }
    __syncthreads();
  }

  // the input projection on the coords, plus the gated finger's row
  for (int idx = tid; idx < H * TT; idx += blockDim.x) {
    const int o = idx / TT, t = idx % TT;
    const float* w = blob + Lw.wp + 3 * o;
    float v = fmaf(w[2], pts[2 * TT + t], fmaf(w[1], pts[TT + t], w[0] * pts[t])) +
              blob[Lw.bin + o];
    if (MODE == MODE_GATED && sel[t] >= 0) v += blob[Lw.tail + (sel[t] / a.K) * H + o];
    net[idx] = v;
  }
  // the c_img rows through W_img, staged in f before the features
  if (MODE == MODE_CIMG) {
    const T* ci = static_cast<const T*>(a.c_img);
    for (int idx = tid; idx < a.Ci * TT; idx += blockDim.x) {
      const int c = idx / TT, t = idx % TT;
      const long long n = n0 + t;
      f[idx] = n < a.N ? load_f32(ci + c * a.N + n) : 0.f;
    }
    __syncthreads();
    dense<false, true>(blob + Lw.tail, nullptr, H, a.Ci, f, net, TT);
  }
  __syncthreads();

  // the features: streamed (C, N) rows, or the trilinear gather
  if (WINDOW) {
    const long long dx = C, dy = (long long)a.R * C, dz = (long long)a.R * a.R * C;
    for (int idx = tid; idx < C * TT; idx += blockDim.x) {
      const int c = idx % C, t = idx / C;   // channels fastest: coalesced rows
      const float* g = a.grid + (long long)cell[t] * C + c;
      const float wx = wts[t], wy = wts[TT + t], wz = wts[2 * TT + t];
      const float c00 = lerp(__ldg(g), __ldg(g + dx), wx);
      const float c01 = lerp(__ldg(g + dy), __ldg(g + dy + dx), wx);
      const float c10 = lerp(__ldg(g + dz), __ldg(g + dz + dx), wx);
      const float c11 = lerp(__ldg(g + dz + dy), __ldg(g + dz + dy + dx), wx);
      f[c * TT + t] = lerp(lerp(c00, c01, wy), lerp(c10, c11, wy), wz);
    }
  } else {
    for (int idx = tid; idx < C * TT; idx += blockDim.x) {
      const int c = idx / TT, t = idx % TT;
      const long long n = n0 + t;
      f[idx] = n < a.N ? load_f32(feats + c * a.N + n) : 0.f;
    }
  }
  __syncthreads();

  // the chain
  for (int i = 0; i < a.NB; ++i) {
    const float* blk = blob + Lw.block + (long long)i * Lw.stride;
    const float* wc = blk;
    const float* bc = wc + H * C;
    const float* w0 = bc + H;
    const float* b0 = w0 + H * H;
    const float* w1 = b0 + H;
    const float* b1 = w1 + H * H;
    dense<false, true>(wc, bc, H, C, f, net, TT);
    __syncthreads();
    dense<true, false>(w0, b0, H, H, net, h, TT);
    __syncthreads();
    dense<true, true>(w1, b1, H, H, h, net, TT);
    __syncthreads();
  }

  // the head: the rows of the block share each point's sum
  const int rows = blockDim.x / TT;
  const int t = tid % TT, r = tid / TT;
  float s = 0.f;
  for (int o = r; o < H; o += rows) s = fmaf(blob[Lw.wout + o], fmaxf(net[o * TT + t], 0.f), s);
  h[r * TT + t] = s;        // h (and f after it, rows > H) is free now
  __syncthreads();
  if (r == 0 && n0 + t < a.N) {
    float sum = 0.f;
    for (int k = 0; k < rows; ++k) sum += h[k * TT + t];
    out[n0 + t] = sum + blob[Lw.bout];
  }
}

template <typename T, int MODE, bool WINDOW>
int launch(const Args& a, cudaStream_t stream) {
  if (a.H < 1 || a.C < 1 || a.NB < 0 || a.B < 1 || a.T < 1 ||
      kThreads % a.T != 0 || (MODE == MODE_CIMG && (a.Ci < 1 || a.c_img == nullptr)) ||
      (MODE == MODE_GATED && (a.F < 1 || a.K < 1 || a.contacts == nullptr)) ||
      (WINDOW && (a.R < 2 || a.L < 1)))
    return (int)cudaErrorInvalidValue;
  if (a.N <= 0) return (int)cudaSuccess;
  const long long blocks = (long long)a.B * ((a.N + a.T - 1) / a.T);
  const long long smem = smem_floats(a.H, a.C, MODE == MODE_CIMG ? a.Ci : 0, a.T) * 4;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = trunk_any_kernel<T, MODE, WINDOW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool WINDOW, typename T>
int launch_mode(int mode, const Args& a, cudaStream_t s) {
  switch (mode) {
    case MODE_COORDS: return launch<T, MODE_COORDS, WINDOW>(a, s);
    case MODE_CIMG: return launch<T, MODE_CIMG, WINDOW>(a, s);
    case MODE_GATED: return launch<T, MODE_GATED, WINDOW>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args base_args(const float* blob, int H, int C, int Ci, int NB, int T,
               const float* contacts, int F, int K, float r2) {
  Args a = {};
  a.blob = blob;
  a.H = H;
  a.C = C;
  a.Ci = Ci;
  a.NB = NB;
  a.T = T;
  a.contacts = reinterpret_cast<const float4*>(contacts);
  a.F = F;
  a.K = K;
  a.r2 = r2;
  a.B = 1;
  return a;
}

}  // namespace

extern "C" {

// K1, K2 and K2 over B objects at any width. blob: pack_any_params's layout;
// mode 0 (coords), 1 (c_img rows (Ci, N)) or 2 (gated: contacts (F K, 4)
// f32 rows, 16-byte aligned); T points per tile; p (B, 3, N) with p_stride
// elements between objects (0: one (3, N) shared by all), feats (B, C, N)
// with f_stride, c_img and out (B, N); p, feats and c_img f32 or (bf16 != 0)
// bf16.
int trunk_any_launch(const float* blob, int H, int C, int Ci, int NB, int mode, int T,
                     const float* contacts, int F, int K, float r2, const void* p,
                     long long p_stride, const void* feats, long long f_stride,
                     const void* c_img, int bf16, float* out, long long N, int B,
                     void* stream) {
  Args a = base_args(blob, H, C, Ci, NB, T, contacts, F, K, r2);
  a.p = p;
  a.p_stride = p_stride;
  a.feats = feats;
  a.f_stride = f_stride;
  a.c_img = c_img;
  a.out = out;
  a.N = N;
  a.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mode<false, uint16_t>(mode, a, s)
              : launch_mode<false, float>(mode, a, s);
}

// K3 (mode 0, 1) and K4 (mode 2) at any width: grid (R, R, R, C) f32
// channels-last, p (3, N) and c_img (Ci, N) f32, keys (N,) int32 or null;
// box_eps, u_hi, L and n1 as window.cu's window_cn_launch.
int trunk_any_window_launch(const float* blob, int H, int C, int Ci, int NB, int mode,
                            int T, const float* contacts, int F, int K, float r2,
                            const float* p, const float* grid, int R, float box_eps,
                            float u_hi, int L, int n1, const float* c_img, float* out,
                            int32_t* keys, long long N, void* stream) {
  Args a = base_args(blob, H, C, Ci, NB, T, contacts, F, K, r2);
  a.p = p;
  a.feats = nullptr;
  a.c_img = c_img;
  a.out = out;
  a.N = N;
  a.grid = grid;
  a.R = R;
  a.box_eps = box_eps;
  a.u_hi = u_hi;
  a.L = L;
  a.n1 = n1;
  a.keys = keys;
  return launch_mode<true, float>(mode, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
