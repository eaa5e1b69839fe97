// sLSTM sequence scan for Hopper (sm_90a), bound with ctypes.
//
// K8 slstm_scan  replaces src/repro/kernels/slstm_scan.py:83
//                slstm_scan_call (_kernel): the sLSTM recurrence over S
//                steps with the four states kept on chip,
//   gates[b, h]  = xp[b, t, h] + h_prev[b, h] . wr[h]          (4·hd wide)
//   z = tanh(gz), log_i = gi, log_f = log_sigmoid(gf), o = sigmoid(go)
//   m' = max(log_f + m, log_i)
//   c' = exp(log_f + m - m') c + exp(log_i - m') z
//   n' = exp(log_f + m - m') n + exp(log_i - m')
//   h' = o c' / max(|n'|, 1)
// which is the reference model's _slstm_cell (repro/models/xlstm.py:191-210)
// step for step.  Inputs are the model's own layout: xp (B, S, H, 4·hd)
// fp32, head-major, each head [z | i | f | o]; wr (H, hd, 4·hd) fp32, one
// recurrent matrix a head; h/c/n/m (B, H, hd) fp32.  Outputs: hs (B, S, H,
// hd) fp32 and the four states after the last step.  The TPU kernel took a
// gate-major xp and a block-diagonal (D, 4·D) wr so that one MXU product
// covered every head; that matrix is H times the work, on zeros, and is not
// carried over: a block here owns one head.
//
// What bounds it: operations, on paper.  A step costs 2·hd·4·hd flops a
// (row, head) for the recurrent product (the gate arithmetic is O(hd));
// xp is read once, hs written once and wr read once: at B = 2, S = 4096,
// H = 4, hd = 192 that is 9.66e9 flops against about 128 MB, so the bound
// is 0.144 ms at 67 TFLOP/s fp32.  In practice the recurrence bounds it:
// S dependent steps, each a product whose input is the previous step's
// output, on only ceil(B / bt) · H blocks (4 at that shape).  Each step
// reads the head's wr (590 KB at hd = 192, more than one SM's 227 KB of
// shared memory) from L2 on one SM, so a step costs about that read: on
// one "NVIDIA H100 80GB HBM3, 700.00 W" this design reads about 37 GB/s
// from L2 an SM, some 16 us a step (65 ms a launch at that shape).
//
// Design (simple and right first).  Grid (ceil(B / bt), H), one block of
// 4·hd threads (768 at hd = 192), bt <= 8 batch rows a block.  The kernel
// is instantiated for BT = 1, 2, 4 and 8 rows and a launch takes the
// smallest BT >= bt, so a block spends its instructions on the rows it
// has.  Thread j owns gate column j.  Each
// step it issues its xp loads for the block's rows, then adds the BT dot
// products h[r] . wr[:, j] over k = 0 .. hd-1 in that order with
// __fmaf_rn: its wr column is read through L2, coalesced across the
// block, kKB values a batch with the next batch's loads in flight while
// the current one is multiplied; h is read from shared memory as float4
// broadcasts (rows padded to a multiple of 4 floats).  It adds xp and
// stores the gate in shared memory.  After a barrier, bt · hd threads (a
// loop when bt · hd > 4·hd) update c, n, m and h of one (row, unit) each
// in fp32, with explicitly rounded adds, products and quotients (no
// contraction the compiler could choose differently), and write h to hs.
// The states live in shared memory across all S steps and are written
// once at the end.  Shared memory: 8 · BT · hd floats and the padding
// (48 KB at BT = 8, hd = 192; the opt-in above 48 KB).
//
// Invariants that hold by construction, bitwise:
//  * a row's result does not depend on B, bt or the other rows: every row
//    runs the same sequence of explicitly rounded operations on its own h,
//    c, n, m whichever BT instance runs it, so served batched == solo for
//    this layer;
//  * one launch over S equals any split of S with the state carried: the
//    state written at the end is the fp32 state the next step would read;
//  * two launches are equal: no atomics, no order that depends on timing.
//
// Making it fast is later work.  The plan: a thread-block cluster per
// (head, row tile) holds the head's wr split across its SMs' shared memory
// (590 KB over 4 SMs, 147 KB each): SM c owns a quarter of the hd units
// and the four gate columns (z, i, f, o) of each, so it computes those
// gates from its resident slice and updates its units' states locally;
// the new h of its units is written into every SM of the cluster through
// distributed shared memory, with one cluster barrier a step.  That
// removes the L2 read of wr from every step; what is left is the latency
// of one product from shared memory and one cluster barrier a step.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for hd > 256 or bt outside
// 1..8).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBT = 8;        // batch rows a block
constexpr int kKB = 8;           // wr values a batch (a thread's loads)
constexpr int kMaxThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  // min(x, 0) - log1p(exp(-|x|)), the stable form torch and jax use
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

template <int BT>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const float* __restrict__ xp, const float* __restrict__ wr,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ hs, float* __restrict__ hN,
                  float* __restrict__ cN, float* __restrict__ nN,
                  float* __restrict__ mN, int B, int S, int H, int hd,
                  int bt) {
  extern __shared__ float4 smem4[];
  const int G = 4 * hd;                 // gate columns of a head
  const int hdp = pad4(hd);             // an h row in shared memory
  const int head = blockIdx.y;
  const int b0 = blockIdx.x * bt;
  const int rows = min(bt, B - b0);
  const int units = rows * hd;
  float* h_s = reinterpret_cast<float*>(smem4);   // (BT, hdp), 16-B rows
  float* c_s = h_s + BT * hdp;                     // (BT, hd)
  float* n_s = c_s + BT * hd;
  float* m_s = n_s + BT * hd;
  float* g_s = m_s + BT * hd;                      // (BT, 4·hd)

  for (int idx = threadIdx.x; idx < BT * hdp; idx += blockDim.x)
    h_s[idx] = 0.f;                     // rows past B and the padding
  __syncthreads();
  for (int idx = threadIdx.x; idx < units; idx += blockDim.x) {
    const int r = idx / hd, u = idx - (idx / hd) * hd;
    const size_t o = (static_cast<size_t>(b0 + r) * H + head) * hd + u;
    h_s[r * hdp + u] = h0[o];
    c_s[idx] = c0[o];
    n_s[idx] = n0[o];
    m_s[idx] = m0[o];
  }
  __syncthreads();

  const int j = threadIdx.x;            // blockDim.x == G
  const float* wcol = wr + static_cast<size_t>(head) * hd * G + j;
  const size_t row_stride = static_cast<size_t>(S) * H * G;  // xp, per b
  const float* xcol = xp + static_cast<size_t>(b0) * row_stride +
                      static_cast<size_t>(head) * G + j;
  const size_t step_stride = static_cast<size_t>(H) * G;      // xp, per t
  const size_t hs_row = static_cast<size_t>(S) * H * hd;      // hs, per b
  const int k_full = hd - hd % kKB;     // k below it: whole batches

  for (int t = 0; t < S; ++t) {
    float x[BT], acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      x[r] = r < rows ? xcol[r * row_stride + t * step_stride] : 0.f;
      acc[r] = 0.f;
    }
    float w[kKB];
#pragma unroll
    for (int i = 0; i < kKB; ++i)
      w[i] = k_full > 0 ? __ldg(wcol + static_cast<size_t>(i) * G) : 0.f;
    for (int k0 = 0; k0 < k_full; k0 += kKB) {
      float wn[kKB];                    // the next batch, in flight
      const bool more = k0 + kKB < k_full;
#pragma unroll
      for (int i = 0; i < kKB; ++i)
        wn[i] = more ? __ldg(wcol + static_cast<size_t>(k0 + kKB + i) * G)
                     : 0.f;
#pragma unroll
      for (int q = 0; q < kKB / 4; ++q) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(h_s + r * hdp + k0 + 4 * q);
          acc[r] = __fmaf_rn(h4.x, w[4 * q + 0], acc[r]);
          acc[r] = __fmaf_rn(h4.y, w[4 * q + 1], acc[r]);
          acc[r] = __fmaf_rn(h4.z, w[4 * q + 2], acc[r]);
          acc[r] = __fmaf_rn(h4.w, w[4 * q + 3], acc[r]);
        }
      }
#pragma unroll
      for (int i = 0; i < kKB; ++i) w[i] = wn[i];
    }
    for (int k = k_full; k < hd; ++k) {  // the tail, in the same k order
      const float wk = __ldg(wcol + static_cast<size_t>(k) * G);
#pragma unroll
      for (int r = 0; r < BT; ++r)
        acc[r] = __fmaf_rn(h_s[r * hdp + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < BT; ++r)
      if (r < rows) g_s[r * G + j] = __fadd_rn(x[r], acc[r]);
    __syncthreads();

    for (int idx = threadIdx.x; idx < units; idx += blockDim.x) {
      const int r = idx / hd, u = idx - (idx / hd) * hd;
      const float* g = g_s + r * G;
      const float z = tanhf(g[u]);
      const float log_i = g[hd + u];
      const float log_f = log_sigmoid(g[2 * hd + u]);
      const float o = sigmoid(g[3 * hd + u]);
      const float fm = __fadd_rn(log_f, m_s[idx]);
      const float m_new = fmaxf(fm, log_i);
      const float i_p = expf(__fsub_rn(log_i, m_new));
      const float f_p = expf(__fsub_rn(fm, m_new));
      const float c = __fadd_rn(__fmul_rn(f_p, c_s[idx]), __fmul_rn(i_p, z));
      const float n = __fadd_rn(__fmul_rn(f_p, n_s[idx]), i_p);
      const float h = __fdiv_rn(__fmul_rn(o, c), fmaxf(fabsf(n), 1.f));
      c_s[idx] = c;
      n_s[idx] = n;
      m_s[idx] = m_new;
      h_s[r * hdp + u] = h;
      hs[(b0 + r) * hs_row + (static_cast<size_t>(t) * H + head) * hd + u] =
          h;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < units; idx += blockDim.x) {
    const int r = idx / hd, u = idx - (idx / hd) * hd;
    const size_t o = (static_cast<size_t>(b0 + r) * H + head) * hd + u;
    hN[o] = h_s[r * hdp + u];
    cN[o] = c_s[idx];
    nN[o] = n_s[idx];
    mN[o] = m_s[idx];
  }
}

template <int BT>
int launch(const float* xp, const float* wr, const float* h0, const float* c0,
           const float* n0, const float* m0, float* hs, float* hN, float* cN,
           float* nN, float* mN, int B, int S, int H, int hd, int bt,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BT * (pad4(hd) + 3 * hd + 4 * hd));
  if (smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        slstm_scan_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + bt - 1) / bt, H);
  slstm_scan_kernel<BT><<<grid, 4 * hd, smem, stream>>>(
      xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd, bt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xp (B, S, H, 4·hd), wr (H, hd, 4·hd), h0/c0/n0/m0 (B, H, hd): fp32,
// contiguous.  hs (B, S, H, hd), hN/cN/nN/mN (B, H, hd): fp32, contiguous,
// allocated by the caller.
int mgg_slstm_scan(const float* xp, const float* wr, const float* h0,
                   const float* c0, const float* n0, const float* m0,
                   float* hs, float* hN, float* cN, float* nN, float* mN,
                   int B, int S, int H, int hd, int bt, cudaStream_t stream) {
  if (hd <= 0 || 4 * hd > kMaxThreads || bt < 1 || bt > kMaxBT || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (bt == 1)
    return launch<1>(xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd,
                     bt, stream);
  if (bt == 2)
    return launch<2>(xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd,
                     bt, stream);
  if (bt <= 4)
    return launch<4>(xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd,
                     bt, stream);
  return launch<8>(xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN, B, S, H, hd,
                   bt, stream);
}

}  // extern "C"
