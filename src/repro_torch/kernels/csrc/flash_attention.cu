// Flash-attention forward kernel for Hopper (sm_90a), bound with ctypes.
//
// K7 flash_attention  replaces src/repro/kernels/flash_attention.py:79
//                     flash_attention_call (_kernel): causal and
//                     sliding-window softmax attention with GQA,
//   out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h // g] / sqrt(hd))
//                  * v[b, t, h // g],   g = H / KV,
// over the keys t that the masks keep: causal t <= s, window s - t < window
// (window 0: none), with positions 0 .. S-1 on both sides.  q (B, S, H, hd),
// k/v (B, S, KV, hd), all fp32 or all bf16, read through their (b, s, h)
// strides (hd contiguous), so the model's layout needs no transpose; out
// (B, S, H, hd) contiguous in q's type.  It computes what the Pallas kernel
// computes: q scaled by hd^-0.5 in fp32, fp32 dot products, a running max
// and denominator and an fp32 accumulator (online softmax), masked scores
// -1e30, the sum divided by max(l, 1e-30) and cast to q's type.  hd is a
// template parameter: 16, 64, 112 and 128 (every head_dim of the configs
// and their smoke() reductions that runs attention).
//
// What bounds it: operations.  A (q, k) pair the masks keep costs 4 * hd
// flops (the dot and the weighted add of v); q, k and v are read once and
// the output written once, so at S = 4096 the flops outweigh the bytes by
// far: the bound is 4 * B * H * hd * (kept pairs) over the card's peak for
// the input type.  The products of this kernel run in fp32 on the CUDA
// cores, not on the tensor cores (wgmma, TMA and bf16 tensor-core products
// are later work), so in bf16 it stays far above that bound.
//
// Design.  The TPU kernel walks the key blocks as the sequential, innermost
// grid dimension and keeps m, l and the accumulator in VMEM scratch across
// grid steps.  Here one block of 256 threads owns one (batch, head, tile of
// kBQ = 64 query rows) and walks the key tiles of kBK = 64 keys in a loop;
// m, l and the accumulator live in registers.  The q tile (scaled, fp32) is
// staged in shared memory once; each key tile's K and V are staged as fp32
// (the dynamic shared-memory opt-in where the tiles pass 48 KB: 100 KB at
// hd = 128, two blocks an SM).  Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16 i (i < 4) of the tile, columns tx + 16 j (j < 4) of the
// score tile and dims tx + 16 c of the accumulator: the 4 x 4 score
// micro-tile is a register-blocked product over float4 reads (rows padded
// to hd + 4 floats, so the eight float4 reads of a quarter-warp hit 32
// distinct banks); the row max and sum are shuffles over the 16 lanes of a
// row; the tile's probabilities go to shared memory (over the K tile, which
// is no longer read) for the weighted add of V.  Tail rows and keys past S
// are zero-filled and masked, so any S works.  Key tiles wholly past the
// causal band or before the window of every row of the q tile are skipped;
// a tile that is masked for one row but not for all still runs for it.  For
// such a row its first tiles may be fully masked: it then takes p = 1 on
// masked scores (-1e30 - -1e30 = 0), as the Pallas kernel does on the
// masked blocks it streams; the first tile with a kept key (its own
// diagonal at the latest) gives m_new a real value and the correction
// exp(m_prev - m_new) = exp(-1e30 - m_new) = 0 zeroes what they added,
// exactly.  The q tiles are walked last tile first, so the longest causal
// rows start first.  No atomics: the result is the same bits from launch
// to launch.  A tensor that needs a gradient never reaches this kernel (the
// wrapper refuses it): there is no backward, as in the reference.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for a head_dim it does not
// take).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 64;          // keys a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // rows a thread
constexpr int kCols = kBK / 16;  // score columns a thread
constexpr int kStaticSmem = 48 * 1024;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

struct Strides {
  long long b, s, h;  // elements; hd is contiguous
};

template <int HD>
struct Layout {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  static constexpr int kLd = HD + 4;    // padded q/k row (floats)
  static constexpr int kPLd = kBK + 4;  // padded probability row
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKP = kBK * kLd > kBQ * kPLd ? kBK * kLd : kBQ * kPLd;
  static constexpr int kV = kBK * HD;
  static constexpr int kBytes = (kQ + kKP + kV) * 4;
  static constexpr int kDims = HD / 16;  // accumulator dims a thread
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int group, Strides qs, Strides ks, Strides vs, int causal,
                 int window, float scale) {
  using L = Layout<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + L::kQ;  // the K tile, then the tile's probabilities
  float* Ps = Ks;
  float* Vs = Ks + L::kKP;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    Qs[r * L::kLd + d] = s < S ? to_float(qb[s * qs.s + d]) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][L::kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) acc[i][c] = 0.0f;
  }

  // the key tiles some row of this q tile can see
  const int n_kt = (S + kBK - 1) / kBK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every read of the last tile's P and V is done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, t = k0 + r;
      const bool in = t < S;
      Ks[r * L::kLd + d] = in ? to_float(kb[t * ks.s + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_float(vb[t * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &Qs[(ty + 16 * i) * L::kLd + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &Ks[(tx + 16 * j) * L::kLd + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && qp - kp < window;
        if (!ok) sc[i][j] = kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every read of the K tile is done: P goes over it
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(ty + 16 * i) * L::kPLd + tx + 16 * j] = sc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + 16 * i) * L::kPLd + t];
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) {
        const float vv = Vs[t * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  const long long os = static_cast<long long>(H) * HD;  // o's row stride
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* orow = o + (static_cast<long long>(b) * S + s) * os +
              static_cast<long long>(h) * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < L::kDims; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, Strides qs, Strides ks, Strides vs, int causal,
           int window, cudaStream_t stream) {
  using L = Layout<HD>;
  if (L::kBytes > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, qs, ks, vs,
      causal, window, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
             int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                           window, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                            window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                            window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, S, H|KV, hd) with element strides (b, s, h) and hd
// contiguous; o: (B, S, H, hd) contiguous.  bf16 != 0: __nv_bfloat16, else
// float.
int mgg_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int hd, long long qsb,
                        long long qss, long long qsh, long long ksb,
                        long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, int causal, int window,
                        int bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs,
                                   causal, window, s);
  return dispatch<float>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                         window, s);
}

}  // extern "C"
