// sLSTM sequence scan (K8) and its backward (K9) for Hopper (sm_90a),
// bound with ctypes.
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
// carried over: a cluster here owns one head.
//
// What bounds it.  On paper operations: 2·hd·4·hd flops a (row, head) a
// step, 9.66e9 at B = 2, S = 4096, H = 4, hd = 192, or 0.144 ms at 67
// TFLOP/s fp32.  In practice one step's latency: S dependent steps, each a
// product whose input is the previous step's output, on ceil(B / bt) · H
// clusters.  No step reads wr from global memory, so bytes do not bound
// it.  A step is the product out of shared memory (each block reads its
// whole wr slice and h every step), the gate update's transcendentals and
// the exchange of h between the blocks.  On one "NVIDIA H100 80GB HBM3,
// 700.00 W" at that shape (chip_smoke.py, PERF.md §6): about 1.2 us a
// step, 4.8 to 4.9 ms a launch, with C = 8 (about 7.0 ms with C = 4); the
// exchange alone (mgg_slstm_cluster_probe) about 0.35 us a step, where a
// cluster barrier a step instead took about 0.94 us.  The one-block-a-head
// kernel this replaces read its head's 590 KB of wr from L2 on one SM
// every step: 15.8 us a step.
// What is left: the step less the exchange, mostly the product, whose
// shared-memory reads (73.7 KB of wr a block a step at C = 8) set its
// floor; holding wr in registers (96 floats a thread there) would remove
// them.
//
// Design.  One thread-block cluster of C blocks (C = 2, 4 or 8, the
// portable sizes, or 1 for a head of one unit; kernels/slstm_scan.py's
// plan picks C, and smem_bytes below gives the bytes it computes) per (row
// tile of bt <= 8 batch rows, head): grid (C · ceil(B / bt), H), launched
// with cudaLaunchKernelEx and a cluster dimension of C.  Block c owns the
// units [c·U, (c+1)·U), U = ceil(hd / C) (the last block may be short,
// never empty: (C - 1) · U < hd), and all
// four gate columns z, i, f, o of each, so it updates its units' c, n, m
// and h with no exchange of gates.  kSplit = 8 threads share a unit: thread
// kSplit·uu + s holds slice s of the k range of the unit's four columns.
//  * wr: each thread copies its slice of its unit's four columns into
//    shared memory once per launch with cp.async and reads it from there
//    every step (the block's slice: hd × 4U fp32, 73.7 KB at hd = 192 and
//    C = 8).  Slice s holds k = 32i + 4s .. 32i + 4s + 3 for i = 0, 1, ...,
//    so a warp reads 512 contiguous bytes of wr a float4 and the eight
//    slices of a unit read neighbouring float4s of h.
//  * xp: thread s prefetches its unit's four gates of row s (the row it
//    updates; BT <= kSplit) kStages - 1 steps ahead with cp.async into a
//    ring of kStages slots; it reads only what it copied, so its own
//    cp.async.wait_group is the only wait.
//  * The product: each slice sums its k in increasing order with __fmaf_rn
//    from 0 (k padded with zeros to a multiple of 32), then the slices of a
//    column are added pairwise by __shfl_xor_sync at distance 1, 2 and 4:
//    ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)), the same bits in
//    every slice's thread; gate = xp + that (__fadd_rn).  The association
//    depends only on hd: not on bt, C, the row or timing.  Eight slices,
//    not the one k = 0 .. hd-1 chain of the kernel this replaces: a chain
//    of hd dependent fmas a thread set the step on the card, and a split
//    over four threads still left the step clearly longer than over eight
//    (variant builds, not in the repo).
//  * The update: thread s of a unit updates row s; its c, n, m and h live
//    in registers for all S steps, with explicitly rounded adds, products
//    and quotients (no contraction the compiler could choose differently).
//    It writes h to hs with a plain store and into every block of the
//    cluster with st.async into distributed shared memory, into the h
//    buffer of parity t + 1, each store completing bytes on that block's
//    mbarrier for the buffer.
//  * The exchange: a block starts step t + 1 when its mbarrier for buffer
//    (t + 1) & 1 has counted rows · hd · 4 bytes, every unit's h of step t
//    (thread 0 re-arms it right after, for step t + 2).  No cluster barrier
//    runs a step.  The argument needs every thread still in the loop to
//    send h each step, or to meet a thread of its warp that does at the
//    step's __shfl_xor_sync: so every block holds a unit ((C - 1) · U <
//    hd, which valid() demands) and a warp with no live unit leaves after
//    the set-up (thread 0 sits in warp 0, live whenever its block is).
//    Then a block writes buffer (t + 1) & 1 of block q at step t only
//    after it has received every unit's h of step t - 1, each stored after
//    its warp's shuffle of step t - 1: every thread of q still in the loop
//    has read that buffer at step t - 1, and thread 0 has re-armed its
//    mbarrier for the h of step t.  Nor can a thread fall two phases
//    behind the mbarrier it waits on: the h of step t + 2 includes its own
//    warp's, sent after it passed its wait of step t + 1.  A block leaves
//    only after the last step's h has reached it, so no store lands in a
//    finished block.
// Shared memory, in floats: h 2 · BT · hdk, wr hdk · 4U, the xp ring
// kStages · BT · 4U, and two mbarriers, with hdk = hd padded to 32
// (79,888 bytes at BT = 2, hd = 192, C = 8; smem_bytes).
//
// Invariants that hold by construction, bitwise:
//  * a row's result does not depend on B, bt, C or the other rows: every
//    row runs the same sequence of explicitly rounded operations on its own
//    h, c, n, m whichever BT instance and cluster size runs it, so served
//    batched == solo for this layer;
//  * one launch over S equals any split of S with the state carried: the
//    state written at the end is the fp32 state the next step would read;
//  * two launches are equal: no atomics, no order that depends on timing.
//
// The save (for K9).  Given four more output pointers, K8 also writes each
// step's gates (the pre-activations z, i, f, o of each unit, as one float4:
// (B, S, H, hd, 4)) and the states c, n, m after the step ((B, S, H, hd)).
// It is a second instance of the kernel (kSave); without the pointers the
// launch is the one above, bit for bit.
//
// K9 slstm_scan_backward  replaces no Pallas kernel: the reference trains
//                the sLSTM through autodiff of lax.scan over _slstm_cell
//                (repro/models/xlstm.py:230), and K8 has no VJP.  It is
//                the reverse-time scan of that chain rule, step t from
//                S - 1 down to 0, from the saved gates g_t and the states
//                before the step (c, n, m):
//   dh   = dhs[t] + dg_{t+1} . wr^T        (dhN at t = S - 1)
//   the forward's step recomputed from g_t and (c, n, m) with K8's rounding
//   do   = dh c'/N,  dc' += dh o/N,  dN = -dh o c'/N^2,  N = max(|n'|, 1)
//   dn' += dN sign(n') [|n'| > 1], half of it at |n'| == 1
//   df'  = dc' c + dn' n,  di' = dc' z + dn',  dz = dc' i'
//   dc   = dc' f',  dn = dn' f'
//   dm'  = dm - df' f' - di' i', to log_f + m if larger, to log_i if
//          larger, half to each at a tie (lax.max's rule)
//   dgz  = dz (1 - z^2), dgi = dlog_i, dgf = dlog_f sigmoid(-gf),
//   dgo  = do o (1 - o)
// and writes dg_t as dxp[t] (g = xp + h wr, so dxp = dg) and, after step
// 0, the gradients of the states before it (dh0 = dg_0 . wr^T).  dwr =
// sum over (b, t) of h_{t-1}^T dg_t is one product over saved tensors,
// outside the recurrence: the wrapper's caller runs it as a matmul.
// What bounds it.  As K8: on paper 2·hd·4·hd flops a (row, head) a step
// (the step-to-step product), 0.144 ms at B = 2, S = 4096, H = 4, hd = 192
// over 67 TFLOP/s fp32; in practice one step's latency: S dependent
// steps, each a product of the previous step's dg, whose exchange moves
// 4·hd floats a row to every block of the cluster, four times K8's h.
// Its floor, the exchange alone (mgg_slstm_bwd_cluster_probe, K9's lanes
// and bytes): 0.30 us a step at that shape against 0.25 for K8's, on one
// "NVIDIA H100 80GB HBM3, 700.00 W" (tools/k9_variants.py, PERF.md §6).
// Design.  K8's skeleton with the roles of wr's rows and columns swapped:
// a cluster of C blocks a (row tile, head), block c holding the rows of wr
// of its units U_c (all 4·hd columns), forming its units' dg elementwise
// and sending each unit's dg (four floats, one st.async.v4) to every block
// of the cluster onto the same two mbarriers; each block then sums
// (dg . wr^T)[u] for its units, kSplit = 8 threads a unit over the j range
// (slice s holds units v = 8i + s, i ascending, their four gates in order,
// with __fmaf_rn from 0), the slices added pairwise by __shfl_xor_sync as
// in K8.  What the design does about the step's latency:
//  * wr's rows sit in registers, hdk / 8 float4s a thread (96 floats at
//    hd 192), one instance a padded hd, wherever hdk <= 256 and the block
//    has at most 256 threads (its __launch_bounds__; no instance spills);
//    else in shared memory, read in the same order, so both give the same
//    bits.  In shared memory the product read 73.7 KB of wr a block a
//    step;
//  * before the step's wait each thread recomputes the forward's step from
//    its saved gates and states (forward_step: the transcendentals, the
//    quotients' factors, the tie rules), none of which depends on the
//    exchanged dg, and pins it there (computed()); after the wait only dh
//    = dhs[t] + dg_{t+1} . wr^T and its chain rule (grad_step: two
//    quotients, some fifteen products and sums) remain;
//  * each thread keeps the inputs of the next kBwdAhead = 2 steps (gates,
//    dhs, the states before the step) in flight in registers;
//  * every lane of a unit computes the update of row s % rows (the same
//    operations on the same inputs as the owner, lane s < rows), so the C
//    stores of each (row, unit) spread over its lanes;
//  * the wrapper's plan (kernels/slstm_scan.py::bwd_rows) picks the rows a
//    cluster: the fewest that keep at most one cluster a 16 SMs.  A step's
//    product sums every row of the cluster, so fewer rows is a shorter
//    step: at B 2, 2 rows a cluster cost 0.30 us a step more than 1, of
//    which 0.08 remain without the product (the exchange probe: +0.06).
// At that shape a step takes about 0.93 us (3.8 ms a launch) against 1.91
// us for the first, simple design (wr in shared memory, the recompute
// after the wait, inputs one step ahead, the owner's C stores, 2 rows a
// cluster), with the same bits; 0.61 us without its product, whose dg
// reads (24 float4s a row a thread a step) are most of the rest.
// Measured and dropped (patched builds of this source, timed in one call
// of tools/k9_variants.py): four accumulators a row (a 24-fma chain for
// 96; other bits) -2 % at B 2, S 4096, -1 % at B 8, S 256; the quotients
// as products by reciprocals (other bits) +4 %; inputs three steps ahead
// +1 %; a cluster of 16 (a non-portable size) +6 %, faster only where a
// batch fills fewer clusters (B 1: -10 %).  Shared memory: dg 2 · BT · hdk
// · 4 floats, wr hdk / 8 · nt float4s where it is not in registers, two
// mbarriers (49,168 bytes at BT = 8, hd = 192, C = 8;
// mgg_slstm_bwd_smem_bytes).
// Invariants, bitwise, by construction as K8's: the association depends
// only on hd (not on bt, C, where wr sits, the row or timing); two launches
// are equal; a row alone equals the row in its batch; one launch over S
// equals the launch over the last S2 steps then the one over the first S1
// with the gradients dh (its dh0), dc, dn, dm carried, the states before
// the second launch's steps being those saved at step S1 - 1.
//
// Every launch runs on the caller's stream and allocates nothing.
// mgg_slstm_scan and mgg_slstm_scan_backward return
// cudaErrorInvalidValue for hd outside 1..256, bt
// outside 1..8, C not 1, 2, 4 or 8, a block with no unit or more than
// kMaxUnits, or shared memory above the card's opt-in limit;
// cudaErrorLaunchOutOfResources when cudaOccupancyMaxActiveClusters says
// no such cluster can be placed; else cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMaxBT = 8;          // batch rows a cluster
constexpr int kMaxHeadDim = 256;
constexpr int kSplit = 8;          // threads a unit (its k range split)
constexpr int kChunk = 4 * kSplit; // k that one float4 of each slice spans
constexpr int kMaxUnits = 48;      // units a block
constexpr int kMaxThreads = kSplit * kMaxUnits;
constexpr int kStages = 4;         // xp ring: steps in flight
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSplit >= kMaxBT, "a thread updates one row: kSplit >= BT");

__host__ __device__ __forceinline__ int bt_instance(int bt) {
  return bt <= 1 ? 1 : bt <= 2 ? 2 : bt <= 4 ? 4 : 8;
}

// A block's shared memory, in floats (offsets and total).
struct Layout {
  int units;   // U = ceil(hd / C)
  int nt;      // threads: kSplit · U rounded up to a warp
  int hdk;     // k padded to a multiple of kChunk (zeros past hd)
  int w_off, x_off, bar_off, total;
};

__host__ __device__ __forceinline__ Layout layout(int hd, int BT, int C) {
  Layout L;
  L.units = (hd + C - 1) / C;
  L.nt = (kSplit * L.units + 31) & ~31;
  L.hdk = (hd + kChunk - 1) / kChunk * kChunk;
  L.w_off = 2 * BT * L.hdk;                        // h (2, BT, hdk)
  L.x_off = L.w_off + L.hdk / kChunk * 16 * L.nt;  // wr (hdk/kChunk, 4, nt)
  L.bar_off = L.x_off + kStages * BT * 4 * L.units;  // xp (kStages, BT, U, 4)
  L.total = L.bar_off + 4;                         // two mbarriers
  return L;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  // min(x, 0) - log1p(exp(-|x|)), the stable form torch and jax use
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// v into block `rank`'s shared memory at the offset `local` has in this
// block's, completing 4 bytes on that block's mbarrier at `bar`'s offset.
__device__ __forceinline__ void st_async(uint32_t local, uint32_t bar,
                                         uint32_t rank, float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n"
      :: "r"(map_rank(local, rank)), "f"(v), "r"(map_rank(bar, rank))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The one arrival of the barrier's current phase, expecting `bytes`.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed; what the other
// blocks stored before completing it is seen after.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// What one thread of a block owns.  Thread kSplit·uu + s holds slice s of
// the k range of the four gate columns of unit u = rank·U + uu and
// updates row s of that unit.
struct Place {
  Layout L;
  int rank, head, b0, rows, uu, s, u;
  bool live;    // u < hd: the unit exists
  bool owner;   // and row s is one of the tile's rows
  bool warp_live;   // the unit of the warp's lane 0 exists
};

__device__ __forceinline__ Place place(int B, int hd, int bt, int BT,
                                       int C) {
  Place p;
  p.L = layout(hd, BT, C);
  p.rank = static_cast<int>(cluster_rank());
  p.head = blockIdx.y;
  p.b0 = (blockIdx.x / C) * bt;
  p.rows = min(bt, B - p.b0);
  p.uu = threadIdx.x / kSplit;
  p.s = threadIdx.x % kSplit;
  p.u = p.rank * p.L.units + p.uu;
  p.live = p.uu < p.L.units && p.u < hd;
  p.owner = p.live && p.s < p.rows;
  const int uu0 = (threadIdx.x & ~31) / kSplit;
  p.warp_live = uu0 < p.L.units && p.rank * p.L.units + uu0 < hd;
  return p;
}

// The two mbarriers, armed for the h of steps 0 and 1, seen by the whole
// cluster before any block stores into another.
__device__ __forceinline__ void exchange_init(uint64_t* full,
                                              uint32_t bytes) {
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&full[1], bytes);
    mbar_arm(&full[0], bytes);
  }
  __syncthreads();
  cluster_sync();
}

// Before step t reads buffer t & 1: wait for step t - 1's h, then re-arm
// that buffer's mbarrier for the h of step t + 1.
__device__ __forceinline__ void exchange_wait(uint64_t* full, int t,
                                              uint32_t bytes) {
  if (t == 0) return;                       // buffer 0 holds h0
  mbar_wait(&full[t & 1], ((t - 1) >> 1) & 1);
  if (threadIdx.x == 0) mbar_arm(&full[t & 1], bytes);
}

// a[r] for a row r known only at run time, without indexing registers
template <int BT>
__device__ __forceinline__ float pick(const float (&a)[BT], int r) {
  float v = a[0];
#pragma unroll
  for (int q = 1; q < BT; ++q) v = q == r ? a[q] : v;
  return v;
}

template <int BT, bool kSave>
__global__ void __launch_bounds__(kMaxThreads)
slstm_cluster_kernel(const float* __restrict__ xp,
                     const float* __restrict__ wr,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0, float* __restrict__ hs,
                     float* __restrict__ hN, float* __restrict__ cN,
                     float* __restrict__ nN, float* __restrict__ mN,
                     float4* __restrict__ gS, float* __restrict__ cS,
                     float* __restrict__ nS, float* __restrict__ mS, int B,
                     int S, int H, int hd, int bt, int C) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Place p = place(B, hd, bt, BT, C);
  const Layout& L = p.L;
  const int G = 4 * hd;
  const int tid = threadIdx.x;
  float* h_s = sm;                          // (2, BT, hdk)
  float4* w_s = reinterpret_cast<float4*>(sm + L.w_off);
  float* x_s = sm + L.x_off;                // (kStages, BT, U, 4)
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar_off);
  const int n_it = L.hdk / kChunk;          // float4s a gate a thread
  const uint32_t bytes = static_cast<uint32_t>(p.rows * hd * 4);

  // this thread's slice of its unit's four columns of wr, once: float4
  // (i, g) holds k = kChunk·i + 4s + 0..3 of gate g (zeros past hd)
  if (p.live) {
    const float* src = wr + static_cast<size_t>(p.head) * hd * G + p.u;
    for (int i = 0; i < n_it; ++i) {
      for (int g = 0; g < 4; ++g) {
        float* dst =
            reinterpret_cast<float*>(w_s + (4 * i + g) * L.nt + tid);
        for (int e = 0; e < 4; ++e) {
          const int k = kChunk * i + 4 * p.s + e;
          if (k < hd)
            cp_async4(dst + e, src + static_cast<size_t>(k) * G + g * hd);
          else
            dst[e] = 0.f;
        }
      }
    }
  }
  cp_async_commit();

  // the xp ring: step t's four gates of row s of this unit in slot
  // t % kStages, one commit group a step (empty past S)
  const size_t x_step = static_cast<size_t>(H) * G;      // xp, per t
  const float* x_src = xp + static_cast<size_t>(p.b0 + p.s) * S * x_step +
                       static_cast<size_t>(p.head) * G + p.u;
  auto x_at = [&](int t) {
    return x_s + (((t % kStages) * BT + p.s) * L.units + p.uu) * 4;
  };
  auto issue = [&](int t) {
    if (p.owner && t < S) {
      const float* src = x_src + t * x_step;
      float* dst = x_at(t);
      for (int g = 0; g < 4; ++g) cp_async4(dst + g, src + g * hd);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  // h: buffer 0 from h0, buffer 1, the padding and the rows past B zero
  for (int idx = tid; idx < 2 * BT * L.hdk; idx += blockDim.x) {
    const int r = (idx / L.hdk) % BT, k = idx % L.hdk;
    h_s[idx] = idx < BT * L.hdk && r < p.rows && k < hd
                   ? h0[(static_cast<size_t>(p.b0 + r) * H + p.head) * hd + k]
                   : 0.f;
  }
  // the state of (row s, unit u), kept in registers
  const size_t so = (static_cast<size_t>(p.b0 + p.s) * H + p.head) * hd +
                    p.u;
  float hr = 0.f, cr = 0.f, nr = 0.f, mr = 0.f;
  if (p.owner) {
    hr = h0[so];
    cr = c0[so];
    nr = n0[so];
    mr = m0[so];
  }
  cp_async_wait<kStages - 1>();             // the wr slice has landed
  exchange_init(full, bytes);
  if (!p.warp_live) return;                 // nothing to send or compute

  const size_t hs_row = static_cast<size_t>(S) * H * hd;   // hs, per b
  const float4* wt = w_s + tid;
  const uint32_t h_own = smem_u32(h_s + p.s * L.hdk + p.u);  // buffer 0
  for (int t = 0; t < S; ++t) {
    issue(t + kStages - 1);
    exchange_wait(full, t, bytes);
    const float* hc = h_s + (t & 1) * BT * L.hdk + 4 * p.s;
    float acc[4][BT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[g][r] = 0.f;
    if (p.live) {
#pragma unroll 2
      for (int i = 0; i < n_it; ++i) {
        const float4* wi = wt + 4 * i * L.nt;
        const float4 w[4] = {wi[0], wi[L.nt], wi[2 * L.nt], wi[3 * L.nt]};
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              hc + r * L.hdk + kChunk * i);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][r] = __fmaf_rn(h4.x, w[g].x, acc[g][r]);
            acc[g][r] = __fmaf_rn(h4.y, w[g].y, acc[g][r]);
            acc[g][r] = __fmaf_rn(h4.z, w[g].z, acc[g][r]);
            acc[g][r] = __fmaf_rn(h4.w, w[g].w, acc[g][r]);
          }
        }
      }
    }
    // the slices of a column, pairwise in a fixed order; every slice's
    // thread ends with the same bits
#pragma unroll
    for (int m = 1; m < kSplit; m <<= 1)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          acc[g][r] = __fadd_rn(acc[g][r],
                                __shfl_xor_sync(kFull, acc[g][r], m));
    cp_async_wait<kStages - 1>();           // step t's xp has landed
    if (p.owner) {
      const float* x = x_at(t);
      const float gz = __fadd_rn(x[0], pick(acc[0], p.s));
      const float gi = __fadd_rn(x[1], pick(acc[1], p.s));
      const float gf = __fadd_rn(x[2], pick(acc[2], p.s));
      const float go = __fadd_rn(x[3], pick(acc[3], p.s));
      const float z = tanhf(gz);
      const float log_i = gi;
      const float log_f = log_sigmoid(gf);
      const float o = sigmoid(go);
      const float fm = __fadd_rn(log_f, mr);
      const float m_new = fmaxf(fm, log_i);
      const float i_p = expf(__fsub_rn(log_i, m_new));
      const float f_p = expf(__fsub_rn(fm, m_new));
      cr = __fadd_rn(__fmul_rn(f_p, cr), __fmul_rn(i_p, z));
      nr = __fadd_rn(__fmul_rn(f_p, nr), i_p);
      mr = m_new;
      hr = __fdiv_rn(__fmul_rn(o, cr), fmaxf(fabsf(nr), 1.f));
      const int nb = (t + 1) & 1;
      const uint32_t a = h_own + nb * BT * L.hdk * 4;
      const uint32_t bar = smem_u32(&full[nb]);
      for (int q = 0; q < C; ++q) st_async(a, bar, q, hr);
      const size_t at = (p.b0 + p.s) * hs_row +
                        (static_cast<size_t>(t) * H + p.head) * hd + p.u;
      hs[at] = hr;
      if (kSave) {          // what K9 reads: the gates and the states
        gS[at] = make_float4(gz, gi, gf, go);
        cS[at] = cr;
        nS[at] = nr;
        mS[at] = mr;
      }
    }
  }
  if (S > 0)                  // the last step's h has reached this block
    mbar_wait(&full[S & 1], ((S - 1) >> 1) & 1);

  if (p.owner) {
    hN[so] = hr;
    cN[so] = cr;
    nN[so] = nr;
    mN[so] = mr;
  }
}

// The same cluster shape doing only K8's exchange (st.async and the
// mbarriers): each step every (row, unit) owner reads a unit of the next
// block from the h buffer, adds one and sends it to every block of the
// cluster; the other threads leave after the set-up, so every thread in
// the loop sends.  Its time a step is the floor the recurrence allows K8;
// out (B, H, hd) ends at S everywhere when every store arrived in its
// step.
template <int BT>
__global__ void __launch_bounds__(kMaxThreads)
cluster_probe_kernel(float* __restrict__ out, int B, int S, int H, int hd,
                     int bt, int C) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);
  const Place p = place(B, hd, bt, BT, C);
  const Layout& L = p.L;
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + L.bar_off);
  const uint32_t bytes = static_cast<uint32_t>(p.rows * hd * 4);
  for (int idx = threadIdx.x; idx < 2 * BT * L.hdk; idx += blockDim.x)
    h_s[idx] = 0.f;
  exchange_init(full, bytes);
  if (!p.owner) return;
  const int peer = (p.u + L.units) % hd;
  float v = 0.f;
  for (int t = 0; t < S; ++t) {
    exchange_wait(full, t, bytes);
    v = __fadd_rn(h_s[((t & 1) * BT + p.s) * L.hdk + peer], 1.f);
    const int nb = (t + 1) & 1;
    const uint32_t a = smem_u32(h_s + (nb * BT + p.s) * L.hdk + p.u);
    for (int q = 0; q < C; ++q) st_async(a, smem_u32(&full[nb]), q, v);
  }
  if (S > 0) mbar_wait(&full[S & 1], ((S - 1) >> 1) & 1);
  out[(static_cast<size_t>(p.b0 + p.s) * H + p.head) * hd + p.u] = v;
}

// ---------------------------------------------------------------------------
// K9: the scan's backward.  Block c of a cluster owns the units U_c of a
// (row tile, head), as in K8, but holds the ROWS of wr for them: thread
// kSplit·uu + s holds, for unit u = rank·U + uu, the float4s
// wr[head, u, e·hd + v] (e = 0..3, the gates z, i, f, o) of the units
// v = kSplit·i + s, i = 0, 1, ... (zeros past hd), in registers where the
// block is small enough (kBwdRegHdk, kBwdRegThreads), else in shared
// memory.  The exchanged vector is dg, the four gate gradients of every
// unit, kept unit-major (hdk, 4) a row so that a unit's four gates travel
// as one float4.
// ---------------------------------------------------------------------------

constexpr int kBwdRegHdk = 256;      // wr in registers up to this padded hd
constexpr int kBwdRegThreads = 256;  // in blocks of at most this many threads
constexpr int kBwdAhead = 2;         // steps whose inputs are in flight

// A block of K9's shared memory, in floats.
struct BwdLayout {
  int units, nt, hdk;
  bool w_regs;   // wr's rows in registers, not in shared memory
  int w_off, bar_off, total;
};

__host__ __device__ __forceinline__ BwdLayout bwd_layout(int hd, int BT,
                                                         int C) {
  BwdLayout L;
  L.units = (hd + C - 1) / C;
  L.nt = (kSplit * L.units + 31) & ~31;
  L.hdk = (hd + kChunk - 1) / kChunk * kChunk;
  L.w_regs = L.hdk <= kBwdRegHdk && L.nt <= kBwdRegThreads;
  L.w_off = 2 * BT * 4 * L.hdk;                    // dg (2, BT, hdk, 4)
  L.bar_off = L.w_off + (L.w_regs ? 0 : L.hdk / kSplit * 4 * L.nt);
  L.total = L.bar_off + 4;                          // two mbarriers
  return L;                                 // wr (hdk/kSplit, nt, 4)
}

// v (16 bytes) into block `rank`'s shared memory at the offset `local`
// has in this block's, completing 16 bytes on that block's mbarrier.
__device__ __forceinline__ void st_async4(uint32_t local, uint32_t bar,
                                          uint32_t rank, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n"
      :: "r"(map_rank(local, rank)), "f"(v.x), "f"(v.y), "f"(v.z),
         "f"(v.w), "r"(map_rank(bar, rank))
      : "memory");
}

// K9's pointers and sizes (one kernel parameter).
struct BwdArgs {
  const float *dhs, *dhN, *dcN, *dnN, *dmN, *wr;
  const float4* gS;
  const float *cS, *nS, *mS, *c0, *n0, *m0;
  float *dxp, *dh0, *dc0, *dn0, *dm0;
  int B, S, H, hd, bt, C;
};

// One step's inputs of an owner: the forward's gates (g z, i, f, o), the
// incoming gradient of h, and the states before the step.
struct StepIn {
  float4 g;
  float dh, c, n, m;
};

// What the chain rule of a step needs of its forward: the step recomputed
// from its gates and the states before it with K8's rounding, and the
// factors that depend on nothing else.  None of it depends on the
// gradient exchanged in the step.
struct Fwd {
  float c, n, z, o, i_p, f_p, c_new, nrm, oc, nrm2, at_n, sgn, to_fm,
      to_li, dtanh, dlsig, one_m_o;
};

__device__ __forceinline__ Fwd forward_step(const StepIn& in) {
  Fwd f;
  f.c = in.c;
  f.n = in.n;
  f.z = tanhf(in.g.x);
  const float log_i = in.g.y;
  const float log_f = log_sigmoid(in.g.z);
  f.o = sigmoid(in.g.w);
  const float fm = __fadd_rn(log_f, in.m);
  const float m_new = fmaxf(fm, log_i);
  f.i_p = expf(__fsub_rn(log_i, m_new));
  f.f_p = expf(__fsub_rn(fm, m_new));
  f.c_new = __fadd_rn(__fmul_rn(f.f_p, in.c), __fmul_rn(f.i_p, f.z));
  const float n_new = __fadd_rn(__fmul_rn(f.f_p, in.n), f.i_p);
  const float an = fabsf(n_new);
  f.nrm = fmaxf(an, 1.f);                   // N = max(|n'|, 1)
  f.oc = __fmul_rn(f.o, f.c_new);
  f.nrm2 = __fmul_rn(f.nrm, f.nrm);
  // half the gradient at a tie, of N's max and of m' = max(fm, log_i)
  f.at_n = an > 1.f ? 1.f : an == 1.f ? 0.5f : 0.f;
  f.sgn = copysignf(1.f, n_new);
  f.to_fm = fm > log_i ? 1.f : fm == log_i ? 0.5f : 0.f;
  f.to_li = __fsub_rn(1.f, f.to_fm);
  f.dtanh = __fsub_rn(1.f, __fmul_rn(f.z, f.z));     // z = tanh(gz)
  f.dlsig = sigmoid(-in.g.z);                         // log_sigmoid(gf)
  f.one_m_o = __fsub_rn(1.f, f.o);                    // o = sigmoid(go)
  return f;
}

// Pins f's values before what follows: an empty asm that reads them,
// kept in order with the volatile asm of the exchange wait after it.
__device__ __forceinline__ void computed(const Fwd& f) {
  asm volatile("" :: "f"(f.c), "f"(f.n), "f"(f.z), "f"(f.o), "f"(f.i_p),
               "f"(f.f_p), "f"(f.c_new), "f"(f.nrm), "f"(f.oc),
               "f"(f.nrm2), "f"(f.at_n), "f"(f.sgn), "f"(f.to_fm),
               "f"(f.to_li), "f"(f.dtanh), "f"(f.dlsig), "f"(f.one_m_o));
}

// The chain rule of one step once dh, the gradient of its h, is known:
// updates the carried dc, dn, dm to those of the states before the step
// and returns dg.  h' = o c'/N; c' = f' c + i' z, n' = f' n + i';
// f' = exp(fm - m'), i' = exp(log_i - m'), fm = log_f + m.
__device__ __forceinline__ float4 grad_step(const Fwd& f, float dh,
                                           float& dc, float& dn,
                                           float& dm) {
  const float q = __fdiv_rn(dh, f.nrm);
  const float d_nrm = -__fdiv_rn(__fmul_rn(dh, f.oc), f.nrm2);
  const float d_o = __fmul_rn(q, f.c_new);
  const float dcp = __fadd_rn(dc, __fmul_rn(q, f.o));
  const float dnp = __fadd_rn(dn, __fmul_rn(__fmul_rn(d_nrm, f.at_n), f.sgn));
  const float dfp = __fadd_rn(__fmul_rn(dcp, f.c), __fmul_rn(dnp, f.n));
  const float dip = __fadd_rn(__fmul_rn(dcp, f.z), dnp);
  const float dz = __fmul_rn(dcp, f.i_p);
  dc = __fmul_rn(dcp, f.f_p);
  dn = __fmul_rn(dnp, f.f_p);
  const float d1 = __fmul_rn(dfp, f.f_p);
  const float d2 = __fmul_rn(dip, f.i_p);
  const float dmn = __fsub_rn(__fsub_rn(dm, d1), d2);
  const float d_fm = __fadd_rn(d1, __fmul_rn(dmn, f.to_fm));
  const float d_li = __fadd_rn(d2, __fmul_rn(dmn, f.to_li));
  dm = d_fm;
  return make_float4(__fmul_rn(dz, f.dtanh), d_li, __fmul_rn(d_fm, f.dlsig),
                     __fmul_rn(__fmul_rn(d_o, f.o), f.one_m_o));
}

// (dg · wr^T)[u] of the BT rows for this thread's unit u, its slice:
// float4 i of wr (its registers w_r[i] when NIT > 0, else shared memory
// wt[i · nt]) against dg of the units kSplit·i + slice, i ascending, with
// __fmaf_rn from 0.
template <int BT, int NIT>
__device__ __forceinline__ void bwd_product(
    const float* dgb, int hdk, const float4 (&w_r)[NIT > 0 ? NIT : 1],
    const float4* wt, int nt, int n_it, float (&acc)[BT]) {
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0.f;
  auto step = [&](int i, const float4 w) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 d = *reinterpret_cast<const float4*>(
          dgb + (r * hdk + kSplit * i) * 4);
      acc[r] = __fmaf_rn(d.x, w.x, acc[r]);
      acc[r] = __fmaf_rn(d.y, w.y, acc[r]);
      acc[r] = __fmaf_rn(d.z, w.z, acc[r]);
      acc[r] = __fmaf_rn(d.w, w.w, acc[r]);
    }
  };
  if (NIT > 0) {
#pragma unroll
    for (int i = 0; i < (NIT > 0 ? NIT : 1); ++i) step(i, w_r[i]);
  } else {
#pragma unroll 4
    for (int i = 0; i < n_it; ++i) step(i, wt[i * nt]);
  }
}

// NIT > 0: wr's rows in registers, NIT = hdk / kSplit float4s a thread;
// NIT = 0: in shared memory.
template <int BT, int NIT>
__global__ void __launch_bounds__(NIT > 0 ? kBwdRegThreads : kMaxThreads)
slstm_bwd_cluster_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int hd = a.hd, S = a.S, H = a.H;
  const Place p = place(a.B, hd, a.bt, BT, a.C);
  const BwdLayout L = bwd_layout(hd, BT, a.C);
  const int G = 4 * hd;
  const int tid = threadIdx.x;
  float* dg_s = sm;                             // (2, BT, hdk, 4)
  const float4* w_s = reinterpret_cast<const float4*>(sm + L.w_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bar_off);
  const int n_it = L.hdk / kSplit;              // float4s of wr a thread
  const uint32_t bytes = static_cast<uint32_t>(p.rows * hd * 16);

  // this thread's slice of its unit's row of wr, once: float4 i holds
  // wr[head, u, e·hd + v], v = kSplit·i + s (zeros past hd)
  float4 w_r[NIT > 0 ? NIT : 1];
  {
    const float* src = a.wr + (static_cast<size_t>(p.head) * hd + p.u) * G;
    if (NIT > 0) {
#pragma unroll
      for (int i = 0; i < (NIT > 0 ? NIT : 1); ++i) {
        const int v = kSplit * i + p.s;
        w_r[i] = p.live && v < hd
                     ? make_float4(__ldg(src + v), __ldg(src + hd + v),
                                   __ldg(src + 2 * hd + v),
                                   __ldg(src + 3 * hd + v))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = 0; i < n_it; ++i) {
        const int v = kSplit * i + p.s;
        float* dst = reinterpret_cast<float*>(sm + L.w_off) +
                     (static_cast<size_t>(i) * L.nt + tid) * 4;
        for (int e = 0; e < 4; ++e) {
          if (p.live && v < hd)
            cp_async4(dst + e, src + e * hd + v);
          else
            dst[e] = 0.f;
        }
      }
    }
  }
  cp_async_commit();
  // dg: both buffers zero (the padding past hd stays zero)
  for (int idx = tid; idx < 2 * BT * 4 * L.hdk; idx += blockDim.x)
    dg_s[idx] = 0.f;

  // the row this thread computes: row s % rows on every lane of a live
  // unit, the `copies` lanes of a row sending to blocks first, first +
  // copies, ...
  const int row = p.s % p.rows;
  const bool comp = p.live;
  const int copies = (kSplit - 1 - row) / p.rows + 1;
  const int first = p.s / p.rows;
  // the carried gradients of (row, unit u), in registers
  const size_t so = (static_cast<size_t>(p.b0 + row) * H + p.head) * hd +
                    p.u;
  float dh_last = 0.f, dc = 0.f, dn = 0.f, dm = 0.f;
  if (comp) {
    dh_last = a.dhN[so];
    dc = a.dcN[so];
    dn = a.dnN[so];
    dm = a.dmN[so];
  }
  // step t's inputs; the states before step 0 are c0, n0, m0
  const size_t row0 = static_cast<size_t>(p.b0 + row) * S * H * hd +
                      static_cast<size_t>(p.head) * hd + p.u;
  auto load = [&](int t) {
    StepIn in = {make_float4(0.f, 0.f, 0.f, 0.f), 0.f, 0.f, 0.f, 0.f};
    if (comp && t >= 0) {
      const size_t at = row0 + static_cast<size_t>(t) * H * hd;
      in.g = __ldg(a.gS + at);
      in.dh = __ldg(a.dhs + at);
      if (t > 0) {
        const size_t prev = at - static_cast<size_t>(H) * hd;
        in.c = __ldg(a.cS + prev);
        in.n = __ldg(a.nS + prev);
        in.m = __ldg(a.mS + prev);
      } else {
        in.c = __ldg(a.c0 + so);
        in.n = __ldg(a.n0 + so);
        in.m = __ldg(a.m0 + so);
      }
    }
    return in;
  };
  // the inputs of the next kBwdAhead steps, in flight: ahead[j] is step
  // S - 1 - tau - j at iteration tau
  StepIn ahead[kBwdAhead];
#pragma unroll
  for (int j = 0; j < kBwdAhead; ++j) ahead[j] = load(S - 1 - j);
  cp_async_wait<0>();                           // the wr slice has landed
  exchange_init(full, bytes);
  if (!p.warp_live) return;                     // nothing to send or sum

  const float4* wt = w_s + tid;
  const uint32_t dg_own = smem_u32(dg_s + (row * L.hdk + p.u) * 4);
  const size_t x_step = static_cast<size_t>(H) * G;   // dxp, per t
  float* dx_row = a.dxp + static_cast<size_t>(p.b0 + row) * S * x_step +
                  static_cast<size_t>(p.head) * G + p.u;
  // iteration tau handles step t = S - 1 - tau; iteration S only sums the
  // gradient of h0 from step 0's dg
  for (int tau = 0; tau <= S; ++tau) {
    const int t = S - 1 - tau;
    const StepIn cur = ahead[0];
#pragma unroll
    for (int j = 0; j + 1 < kBwdAhead; ++j) ahead[j] = ahead[j + 1];
    ahead[kBwdAhead - 1] = load(t - kBwdAhead);
    // everything of the update that does not depend on the exchanged dg,
    // before the wait
    const Fwd f = forward_step(cur);
    computed(f);
    float rec = 0.f;                            // (dg_{t+1} · wr^T)[u]
    if (tau > 0) {
      if (tau < S)
        exchange_wait(full, tau, bytes);
      else                            // step 0's dg has reached this block
        mbar_wait(&full[S & 1], ((S - 1) >> 1) & 1);
      float acc[BT];
      bwd_product<BT, NIT>(dg_s + (tau & 1) * BT * L.hdk * 4 + 4 * p.s,
                           L.hdk, w_r, wt, L.nt, n_it, acc);
      // the slices of a unit, pairwise in a fixed order; every slice's
      // thread ends with the same bits
#pragma unroll
      for (int m = 1; m < kSplit; m <<= 1)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(kFull, acc[r], m));
      rec = pick(acc, row);
    }
    if (tau == S) {
      if (p.owner) {
        a.dh0[so] = S > 0 ? rec : dh_last;
        a.dc0[so] = dc;
        a.dn0[so] = dn;
        a.dm0[so] = dm;
      }
      break;
    }
    if (comp) {
      // after the wait only what depends on dh
      const float4 dg = grad_step(
          f, __fadd_rn(cur.dh, tau == 0 ? dh_last : rec), dc, dn, dm);
      const int nb = (tau + 1) & 1;
      const uint32_t at = dg_own + nb * BT * L.hdk * 16;
      const uint32_t bar = smem_u32(&full[nb]);
      for (int q = first; q < a.C; q += copies) st_async4(at, bar, q, dg);
      if (p.owner) {
        float* dx = dx_row + static_cast<size_t>(t) * x_step;
        dx[0] = dg.x;
        dx[hd] = dg.y;
        dx[2 * hd] = dg.z;
        dx[3 * hd] = dg.w;
      }
    }
  }
}

// K9's cluster shape doing only its per-step exchange, with K9's lanes:
// each step every lane that computes a (row, unit) reads a float4 of a
// unit of the next block from the dg buffer, adds one to each lane, meets
// its warp (__syncwarp, where K9 meets it at the product's shuffles) and
// sends it to its blocks (one st.async.v4 each, as K9 sends dg); warps
// with no live unit leave after the set-up.  Its time a step is the floor
// the recurrence allows K9; out (B, H, hd) ends at S everywhere when
// every store arrived in its step.
template <int BT>
__global__ void __launch_bounds__(kMaxThreads)
bwd_probe_kernel(float* __restrict__ out, int B, int S, int H, int hd,
                 int bt, int C) {
  extern __shared__ float4 smem4[];
  float* dg_s = reinterpret_cast<float*>(smem4);
  const Place p = place(B, hd, bt, BT, C);
  const BwdLayout L = bwd_layout(hd, BT, C);
  uint64_t* full = reinterpret_cast<uint64_t*>(dg_s + L.bar_off);
  const uint32_t bytes = static_cast<uint32_t>(p.rows * hd * 16);
  const int row = p.s % p.rows;
  const bool comp = p.live;
  const int copies = (kSplit - 1 - row) / p.rows + 1;
  const int first = p.s / p.rows;
  for (int idx = threadIdx.x; idx < 2 * BT * 4 * L.hdk; idx += blockDim.x)
    dg_s[idx] = 0.f;
  exchange_init(full, bytes);
  if (!p.warp_live) return;
  const int peer = (p.u + L.units) % hd;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < S; ++t) {
    exchange_wait(full, t, bytes);
    if (comp) {
      const float4 x = *reinterpret_cast<const float4*>(
          dg_s + (((t & 1) * BT + row) * L.hdk + peer) * 4);
      v = make_float4(__fadd_rn(x.x, 1.f), __fadd_rn(x.y, 1.f),
                      __fadd_rn(x.z, 1.f), __fadd_rn(x.w, 1.f));
    }
    __syncwarp();
    if (comp) {
      const int nb = (t + 1) & 1;
      const uint32_t at =
          smem_u32(dg_s + ((nb * BT + row) * L.hdk + p.u) * 4);
      for (int q = first; q < C; q += copies)
        st_async4(at, smem_u32(&full[nb]), q, v);
    }
  }
  if (S > 0) mbar_wait(&full[S & 1], ((S - 1) >> 1) & 1);
  if (p.owner)
    out[(static_cast<size_t>(p.b0 + p.s) * H + p.head) * hd + p.u] =
        fminf(fminf(v.x, v.y), fminf(v.z, v.w));
}

int smem_bytes(int hd, int bt, int C) {
  return static_cast<int>(sizeof(float)) *
         layout(hd, bt_instance(bt), C).total;
}

int bwd_smem_bytes(int hd, int bt, int C) {
  return static_cast<int>(sizeof(float)) *
         bwd_layout(hd, bt_instance(bt), C).total;
}

// Whether a cluster of C blocks with this kernel and shared memory can be
// placed on the current card (cudaOccupancyMaxActiveClusters >= 1), asked
// once per (device, kernel, C, bytes); the kernel's dynamic shared-memory
// limit is raised to the card's opt-in on first use.
int placeable(const void* fn, int C, int threads, int smem) {
  struct Seen { int dev; const void* fn; int C, threads, smem, rc; };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.dev == dev && s.fn == fn && s.C == C && s.threads == threads &&
        s.smem == smem)
      return s.rc;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = cudaSuccess;
  if (smem > optin) {
    rc = cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    rc = err != cudaSuccess ? static_cast<int>(err)
         : clusters < 1     ? cudaErrorLaunchOutOfResources
                            : cudaSuccess;
  }
  seen.push_back({dev, fn, C, threads, smem, rc});
  return rc;
}

// One launch of `kernel` over a grid of (C · tiles, H) blocks of `nt`
// threads and `smem` bytes, C blocks a cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int tiles, int H, int nt,
                   int smem, int C, cudaStream_t stream, Args... args) {
  int rc = placeable(reinterpret_cast<const void*>(kernel), C, nt, smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * tiles, H, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Every block of the cluster holds at least one unit and at most kMaxUnits.
bool valid(int hd, int bt, int C) {
  const int units = (hd + C - 1) / C;
  return hd >= 1 && hd <= kMaxHeadDim && bt >= 1 && bt <= kMaxBT &&
         (C == 1 || C == 2 || C == 4 || C == 8) && (C - 1) * units < hd &&
         units <= kMaxUnits;
}

// K9 at a BT instance: wr's rows in registers (the instance of its hdk)
// where bwd_layout puts them there, else in shared memory.
template <int BT, int NIT>
int bwd_launch_nit(const BwdArgs& a, int tiles, cudaStream_t stream) {
  if constexpr (NIT * kSplit > kBwdRegHdk) {
    return cudaErrorInvalidValue;   // never: bwd_layout keeps wr in smem
  } else {
    return launch_cluster(slstm_bwd_cluster_kernel<BT, NIT>, tiles, a.H,
                          bwd_layout(a.hd, BT, a.C).nt,
                          bwd_smem_bytes(a.hd, BT, a.C), a.C, stream, a);
  }
}

template <int BT>
int bwd_launch(const BwdArgs& a, int tiles, cudaStream_t stream) {
  const BwdLayout L = bwd_layout(a.hd, BT, a.C);
  constexpr int k = kChunk / kSplit;          // NIT a kChunk of k
  switch (L.w_regs ? L.hdk / kChunk : 0) {
    case 1: return bwd_launch_nit<BT, 1 * k>(a, tiles, stream);
    case 2: return bwd_launch_nit<BT, 2 * k>(a, tiles, stream);
    case 3: return bwd_launch_nit<BT, 3 * k>(a, tiles, stream);
    case 4: return bwd_launch_nit<BT, 4 * k>(a, tiles, stream);
    case 5: return bwd_launch_nit<BT, 5 * k>(a, tiles, stream);
    case 6: return bwd_launch_nit<BT, 6 * k>(a, tiles, stream);
    case 7: return bwd_launch_nit<BT, 7 * k>(a, tiles, stream);
    case 8: return bwd_launch_nit<BT, 8 * k>(a, tiles, stream);
    default: return bwd_launch_nit<BT, 0>(a, tiles, stream);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of K8 uses at (hd, bt, C): the numbers the
// wrapper's plan (kernels/slstm_scan.py::smem_bytes) must give.  -1 for a
// shape the kernel does not take.
int mgg_slstm_smem_bytes(int hd, int bt, int C) {
  return valid(hd, bt, C) ? smem_bytes(hd, bt, C) : -1;
}

// xp (B, S, H, 4·hd), wr (H, hd, 4·hd), h0/c0/n0/m0 (B, H, hd): fp32,
// contiguous.  hs (B, S, H, hd), hN/cN/nN/mN (B, H, hd): fp32, contiguous,
// allocated by the caller.  C blocks a cluster.
// With gS, cS, nS and mS not null (all four), it also saves each step's
// gates gS (B, S, H, hd, 4: z, i, f, o pre-activations, unit-major) and
// states cS, nS, mS (B, S, H, hd) after the step, fp32, for K9; with them
// null it is the launch without the save.
int mgg_slstm_scan(const float* xp, const float* wr, const float* h0,
                   const float* c0, const float* n0, const float* m0,
                   float* hs, float* hN, float* cN, float* nN, float* mN,
                   float* gS, float* cS, float* nS, float* mS, int B, int S,
                   int H, int hd, int bt, int C, cudaStream_t stream) {
  const bool save = gS != nullptr;
  if (!valid(hd, bt, C) || S < 0 || B < 0 || H < 0 ||
      save != (cS != nullptr) || save != (nS != nullptr) ||
      save != (mS != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (B + bt - 1) / bt;
#define MGG_SLSTM(BT, SAVE)                                                \
  launch_cluster(slstm_cluster_kernel<BT, SAVE>, tiles, H,                 \
                 layout(hd, BT, C).nt, smem_bytes(hd, BT, C), C, stream,   \
                 xp, wr, h0, c0, n0, m0, hs, hN, cN, nN, mN,               \
                 reinterpret_cast<float4*>(gS), cS, nS, mS, B, S, H, hd,   \
                 bt, C)
#define MGG_SLSTM_BT(SAVE)                   \
  switch (bt_instance(bt)) {                 \
    case 1: return MGG_SLSTM(1, SAVE);       \
    case 2: return MGG_SLSTM(2, SAVE);       \
    case 4: return MGG_SLSTM(4, SAVE);       \
    default: return MGG_SLSTM(8, SAVE);      \
  }
  if (save) MGG_SLSTM_BT(true)
  MGG_SLSTM_BT(false)
#undef MGG_SLSTM_BT
#undef MGG_SLSTM
}

// Bytes of shared memory a block of K9 uses at (hd, bt, C); -1 for a shape
// the kernel does not take.
int mgg_slstm_bwd_smem_bytes(int hd, int bt, int C) {
  return valid(hd, bt, C) ? bwd_smem_bytes(hd, bt, C) : -1;
}

// K9.  dhs (B, S, H, hd): the gradient of hs; dhN/dcN/dnN/dmN (B, H, hd):
// of the states after the last step; wr (H, hd, 4·hd); gS, cS, nS, mS:
// what mgg_slstm_scan saved; c0/n0/m0 (B, H, hd): the states before step
// 0.  Writes dxp (B, S, H, 4·hd) and dh0/dc0/dn0/dm0 (B, H, hd), the
// gradients of xp and of the states before step 0.  fp32, contiguous.
int mgg_slstm_scan_backward(const float* dhs, const float* dhN,
                            const float* dcN, const float* dnN,
                            const float* dmN, const float* wr,
                            const float* gS, const float* cS,
                            const float* nS, const float* mS,
                            const float* c0, const float* n0,
                            const float* m0, float* dxp, float* dh0,
                            float* dc0, float* dn0, float* dm0, int B, int S,
                            int H, int hd, int bt, int C,
                            cudaStream_t stream) {
  if (!valid(hd, bt, C) || S < 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (B + bt - 1) / bt;
  const BwdArgs a = {dhs, dhN, dcN, dnN, dmN, wr,
                     reinterpret_cast<const float4*>(gS), cS, nS, mS, c0, n0,
                     m0, dxp, dh0, dc0, dn0, dm0, B, S, H, hd, bt, C};
  switch (bt_instance(bt)) {
    case 1: return bwd_launch<1>(a, tiles, stream);
    case 2: return bwd_launch<2>(a, tiles, stream);
    case 4: return bwd_launch<4>(a, tiles, stream);
    default: return bwd_launch<8>(a, tiles, stream);
  }
}

// K8's cluster shape at (B, H, hd, bt, C) running only its per-step
// exchange of h for S steps; out (B, H, hd) fp32.
int mgg_slstm_cluster_probe(float* out, int B, int S, int H, int hd, int bt,
                            int C, cudaStream_t stream) {
  if (!valid(hd, bt, C) || S < 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (B + bt - 1) / bt;
#define MGG_PROBE(BT)                                                 \
  launch_cluster(cluster_probe_kernel<BT>, tiles, H, layout(hd, BT, C).nt, \
                 smem_bytes(hd, BT, C), C, stream, out, B, S, H, hd, bt, C)
  switch (bt_instance(bt)) {
    case 1: return MGG_PROBE(1);
    case 2: return MGG_PROBE(2);
    case 4: return MGG_PROBE(4);
    default: return MGG_PROBE(8);
  }
#undef MGG_PROBE
}

// K9's cluster shape at (B, H, hd, bt, C) running only its per-step
// exchange of dg (a float4 a unit a row) for S steps; out (B, H, hd) fp32.
int mgg_slstm_bwd_cluster_probe(float* out, int B, int S, int H, int hd,
                                int bt, int C, cudaStream_t stream) {
  if (!valid(hd, bt, C) || S < 0 || B < 0 || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (B + bt - 1) / bt;
#define MGG_PROBE(BT)                                                     \
  launch_cluster(bwd_probe_kernel<BT>, tiles, H, bwd_layout(hd, BT, C).nt, \
                 bwd_smem_bytes(hd, BT, C), C, stream, out, B, S, H, hd,  \
                 bt, C)
  switch (bt_instance(bt)) {
    case 1: return MGG_PROBE(1);
    case 2: return MGG_PROBE(2);
    case 4: return MGG_PROBE(4);
    default: return MGG_PROBE(8);
  }
#undef MGG_PROBE
}

}  // extern "C"
