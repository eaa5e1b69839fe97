// Flash-attention forward kernels for Hopper (sm_90a), bound with ctypes.
//
// K7 flash_attention  replaces src/repro/kernels/flash_attention.py:79
//                     flash_attention_call (_kernel): causal and
//                     sliding-window softmax attention with GQA,
//   out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[b, t, h // g] / sqrt(hd))
//                  * v[b, t, h // g],   g = H / KV,
// over the keys t that the masks keep: causal t <= s, window s - t < window
// (window 0: none), with positions 0 .. S-1 on both sides.  q (B, S, H, hd),
// k/v (B, S, KV, hd), all fp32 or all bf16, read through their (b, s, h)
// strides (hd contiguous), so the model's layout and packed q/k/v slices
// need no copy; out (B, S, H, hd) contiguous in q's type.  It computes what
// the Pallas kernel computes: fp32 dot products scaled by hd^-0.5, a running
// max and denominator and an fp32 accumulator (online softmax), masked
// scores -1e30, the sum divided by max(l, 1e-30) and cast to q's type.
// head_dim 16, 64, 112 and 128 (every head_dim of the configs and their
// smoke() reductions that runs attention).
//
// What bounds it: operations.  A (q, k) pair the masks keep costs 4 * hd
// flops (the dot and the weighted add of v); q, k and v are read once and
// the output written once, so at the LM's shapes (B 2, S 4096, 32/8 heads,
// hd 128, causal: 2.749e11 flops against 168 MB) the flops outweigh the
// bytes by far: the bound is the flops over the card's peak for the input
// type.
//
// bf16: a tensor-core kernel (flash_tc_kernel).  One block, warp-
// specialised, owns one (head, batch, tile of kBQ = 192 query rows):
// - one producer warp issues TMA loads: the q tile once, then each tile of
//   kBK = 64 keys' K and V into a ring of kStages stages in shared memory,
//   each stage guarded by a "full" mbarrier (the loads' byte count,
//   complete_tx) and an "empty" one (the consumers' arrivals);
// - three consumer warpgroups of 64 query rows each compute S = Q.K^T with
//   wgmma (bf16 x bf16 -> fp32, both operands from shared memory), scale S
//   in fp32, run the online softmax in registers on wgmma's accumulator
//   layout (a row's max and sum over the four lanes that hold it), round P
//   to bf16 in registers and compute O += P.V with wgmma, P as the A operand
//   from registers (the accumulator layout of S is the register layout of
//   A, so no shuffle), V as B from shared memory in transposed (MN-major)
//   mode, V being keys x hd.
// Three warpgroups rather than two (one block an SM either way, 144 KB of
// shared memory at hd 128): one's softmax runs while another's products
// keep the tensor cores busy, and the three share each K/V stage.
// The tiles are 128-byte rows of 64 bf16 columns in TMA's 128-byte swizzle,
// which is wgmma's; a head_dim over 64 takes two such column blocks.  Each
// tensor map declares dim 0 as hd, so TMA's out-of-bounds zero fill pads a
// 64-wide block (hd 16) or the second block (hd 112): the padded columns add
// nothing to S, and products of whole zero k-steps are skipped.  Rows and
// keys past S are zero-filled too and masked.  The other dims (heads, S,
// batch) come from the (h, s, b) strides, so TMA needs a 16-byte-aligned
// base and strides that are multiples of 16 bytes: the wrapper refuses
// anything else.  The maps are built on the host for each call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library links nothing beyond the runtime) and passed as __grid_constant__.
// bf16 rounding enters twice: P before P.V (its fp32 row sums go into l
// unrounded), and the output.
//
// fp32: the CUDA-core kernel (flash_kernel), unchanged.  Tensor cores would
// mean TF32, three decimal digits, which cannot hold the fp32 tolerance of
// 2e-5; and in fp32 this kernel already beats scaled_dot_product_attention
// at the LM's shapes (10.37 against 26.53 ms, PERF.md).  One block of 256
// threads owns one (batch, head, tile of 64 query rows) and walks the key
// tiles of 64 keys in a loop; m, l and the accumulator live in registers;
// q (scaled, fp32), K and V are staged as fp32 in shared memory (100 KB at
// hd = 128, two blocks an SM); thread (ty, tx) owns a 4 x 4 score micro-tile
// of a register-blocked product over float4 reads; the tile's probabilities
// go through shared memory for the weighted add of V.
//
// Both kernels: key tiles wholly past the causal band or before the window
// of every row a warpgroup (bf16) or block (fp32) owns are skipped; a tile
// that is masked for one row but not for all still runs for it.  For such a
// row its first tiles may be fully masked: it then takes p = 1 on masked
// scores (-1e30 - -1e30 = 0), as the Pallas kernel does on the masked blocks
// it streams; the first tile with a kept key (its own diagonal at the
// latest) gives m_new a real value and the correction exp(m_prev - m_new) =
// exp(-1e30 - m_new) = 0 zeroes what they added, exactly.  The q tiles are
// walked last tile first, so the longest causal rows start first.  No
// atomics: the result is the same bits from launch to launch.  A tensor
// that needs a gradient never reaches these kernels (the wrapper refuses
// it): there is no backward, as in the reference.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for a head_dim it does not take,
// or bf16 operands that TMA cannot address).
#include <cuda.h>
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

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 192;            // query rows a block
constexpr int kWG = 64;             // query rows a consumer warpgroup
constexpr int kBK = 64;             // keys a stage
constexpr int kStages = 3;          // K/V stages in flight
constexpr int kColBlock = 64;       // bf16 columns in one 128-byte row
constexpr int kRowBytes = 128;
constexpr int kConsumers = 384;     // three warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNeg = -1e30f;

template <int NB>  // 64-column blocks of the (padded) head_dim
struct Smem {
  static constexpr int kQ = NB * kBQ * kRowBytes;    // the q tile
  static constexpr int kKV = NB * kBK * kRowBytes;   // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr int kBytes = kQ + kStages * kStage + kBars + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA tile: box (64 columns, 1 head, rows, 1 batch) at (col, head, row,
// batch) of `map` into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address, leading byte offset 16 (unused by this layout),
// stride byte offset 1024 (from one 8-row group to the next).  K-major
// operands step along K by adding 32 bytes (16 bf16) to the start; the
// MN-major V steps along K by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching an accumulator across a wgmma that is in
// flight: reads after the wait depend on this, and it cannot move above it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MGG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define MGG_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64, fp32) = [d +] A (64 x 16) . B (16 x 64), both bf16 K-major in
// shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MGG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MGG_OUT32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64), B bf16
// MN-major in shared memory (transposed mode).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MGG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MGG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef MGG_D32
#undef MGG_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool kept(int qp, int kp, int S, int causal,
                                     int window) {
  bool ok = kp < S;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// Thread t of a consumer warpgroup holds, of every 64 x 64 fp32 accumulator,
// rows r = 16 * (t / 32) + (t % 32) / 4 and r + 8, and of each group j of 8
// columns the two columns 8 j + 2 (t % 4) + {0, 1}: d[4 j + {0, 1}] on row
// r, d[4 j + {2, 3}] on row r + 8.
// NB: 64-column blocks of the padded hd; KS: 16-wide k-steps holding hd.
template <int NB, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(__grid_constant__ const CUtensorMap tq,
                    __grid_constant__ const CUtensorMap tk,
                    __grid_constant__ const CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int S, int H, int hd,
                    int group, int causal, int window, float scale_log2) {
  using L = Smem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;
  const uint32_t bars = kv_s + kStages * L::kStage;
  const uint32_t q_bar = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // last tile first
  // the key tiles some row of this q tile can see
  const int n_kt = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + kBQ - 1) / kBK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n_tiles = kt_end - kt_begin;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane issues every load
    if (tid == kConsumers) {
      const int kvh = h / group;
      mbar_expect_tx(q_bar, L::kQ);
      for (int cb = 0; cb < NB; ++cb)
        tma_load(q_s + cb * kBQ * kRowBytes, &tq, q_bar, cb * kColBlock, h,
                 q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), L::kStage);
        const int k0 = (kt_begin + i) * kBK;
        const uint32_t ks = kv_s + st * L::kStage;
        for (int cb = 0; cb < NB; ++cb) {
          tma_load(ks + cb * kBK * kRowBytes, &tk, full(st), cb * kColBlock,
                   kvh, k0, b);
          tma_load(ks + L::kKV + cb * kBK * kRowBytes, &tv, full(st),
                   cb * kColBlock, kvh, k0, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows qw .. qw + 63
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int qw = q0 + wg * kWG;
  const int r0 = qw + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int c_lane = 2 * (lane % 4);
  // the key tiles some row of this warpgroup can see (none past S)
  int wb = kt_end, we = kt_end;
  if (qw < S) {
    we = causal ? min(n_kt, (qw + kWG - 1) / kBK + 1) : n_kt;
    wb = window > 0 ? max(0, qw - window + 1) / kBK : 0;
  }

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;  // l: this lane's part

  mbar_wait(q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int kt = kt_begin + i;
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);
    if (kt >= wb && kt < we) {
      const int k0 = kt * kBK;
      const uint32_t ks = kv_s + st * L::kStage;
      const uint32_t vs = ks + L::kKV;

      // S = Q . K^T over the 16-wide k-steps that hold some of hd (a
      // compile-time count: a runtime test around each wgmma makes ptxas
      // fence and wait on every one)
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 along hd
        wgmma_ss(s,
                 desc(q_s + (kk / 4) * kBQ * kRowBytes +
                      wg * kWG * kRowBytes + col),
                 desc(ks + (kk / 4) * kBK * kRowBytes + col), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax in the log2 domain: scores * hd^-0.5 * log2(e)
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > qw) ||
                        (window > 0 && qw + kWG - 1 - k0 >= window);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = s[4 * j + e] * scale_log2;
          float v1 = s[4 * j + 2 + e] * scale_log2;
          if (edge) {
            const int kp = k0 + 8 * j + c_lane + e;
            if (!kept(r0, kp, S, causal, window)) v0 = kNeg;
            if (!kept(r1, kp, S, causal, window)) v1 = kNeg;
          }
          s[4 * j + e] = v0;
          s[4 * j + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
      uint32_t p[16];  // P in bf16: k-step kk is p[4 kk .. 4 kk + 3]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p00 = exp2f(s[4 * j] - mn0);
        const float p01 = exp2f(s[4 * j + 1] - mn0);
        const float p10 = exp2f(s[4 * j + 2] - mn1);
        const float p11 = exp2f(s[4 * j + 3] - mn1);
        rs0 += p00 + p01;
        rs1 += p10 + p11;
        p[2 * j] = pack_bf16(p00, p01);
        p[2 * j + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[cb][4 * j] *= corr0;
          acc[cb][4 * j + 1] *= corr0;
          acc[cb][4 * j + 2] *= corr1;
          acc[cb][4 * j + 3] *= corr1;
        }

      // O += P . V, one 64-column block of hd at a time
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs(acc[cb], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3],
                   desc(vs + cb * kBK * kRowBytes + kk * 16 * kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) fence_regs(acc[cb]);
    }
    mbar_arrive(empty(st));  // this thread is done with the stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long os = static_cast<long long>(H) * hd;  // o's row stride
  __nv_bfloat16* o0 = o + (static_cast<long long>(b) * S + r0) * os +
                      static_cast<long long>(h) * hd;
  __nv_bfloat16* o1 = o0 + 8 * os;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * kColBlock + 8 * j + c_lane;
      if (col >= hd) continue;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(
            acc[cb][4 * j] / den0, acc[cb][4 * j + 1] / den0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(
            acc[cb][4 * j + 2] / den1, acc[cb][4 * j + 3] / den1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 tensor with element strides (b, s, h) as TMA's
// dims (hd, heads, S, B), boxes of 64 columns x `rows` positions.  The
// encoder refuses a base or a stride that TMA cannot address; the wrapper
// checks both first, with a readable error.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kColBlock), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int KS>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, Strides qs, Strides ks, Strides vs,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, hd, qs, kBQ) ||
      !make_map(&tk, k, B, S, KV, hd, ks, kBK) ||
      !make_map(&tv, v, B, S, KV, hd, vs, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<NB, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<NB>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(hd));
  flash_tc_kernel<NB, KS><<<grid, kThreads, Smem<NB>::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, hd, H / KV, causal,
      window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, Strides qs, Strides ks, Strides vs,
             int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<1, 1>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, causal,
                          window, stream);
    case 64:
      return launch<1, 4>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, causal,
                          window, stream);
    case 112:
      return launch<2, 7>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, causal,
                          window, stream);
    case 128:
      return launch<2, 8>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, causal,
                          window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v: (B, S, H|KV, hd) with element strides (b, s, h) and hd
// contiguous; o: (B, S, H, hd) contiguous.  bf16 != 0: __nv_bfloat16 on the
// tensor cores (16-byte-aligned bases, strides multiples of 8 elements),
// else float on the CUDA cores.
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
    return tc::dispatch(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                        window, s);
  return dispatch<float>(hd, q, k, v, o, B, S, H, KV, qs, ks, vs, causal,
                         window, s);
}

}  // extern "C"
