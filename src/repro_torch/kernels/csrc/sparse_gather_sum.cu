// MGG sparse (top-k compressed) gather-sum kernel for Hopper (sm_90a),
// bound with ctypes.
//
// K6 sparse_gather_sum  replaces repro/kernels/neighbor_agg.py
//                       sparse_gather_sum_call (_sparse_pipelined_kernel):
//   out[p] = sum_j mask[p, j] * decompress(values, idx)[nbrs[p, j]]
// with values (T, k) fp32, idx (T, k) int16 (the wire's ids) or int32,
// nbrs/mask (P, ps) int32/bool, out (P, D) fp32.  Row r of the compressed
// table holds the k largest entries of a D-wide row, values[r, s] at
// column idx[r, s]; the ids of a row are distinct (a top-k guarantee).
//
// What bounds it: bytes.  Each masked slot reads one compressed row,
// k * (4 + sizeof(id)) bytes at a data-dependent address, plus its
// partition's ids and mask (ps * 5 bytes), and each partition writes one
// D-wide row: (valid_slots * k * (4 + id) + P * ps * 5 + P * D * 4) bytes
// over the card's memory rate, with no arithmetic to speak of.  At the
// fig9e width (D = 96, k = 24, int16 ids) a compressed row is 144 bytes
// against a dense row's 384: the gather reads 0.375x the dense bytes, but
// the output is still D wide.
//
// The TPU kernel streams one compressed row per grid step and expands it
// into each db-wide output block with a one-hot matmul on the MXU.  Here
// the decompression is a scatter into shared memory: one warp owns one
// partition and holds its D-wide fp32 accumulator in shared memory
// (zeroed, +0.0).  For each slot j = 0 .. ps-1 in order, the lanes add the
// neighbor's k pairs into it, lane l taking pairs l, l + 32, ...; the ids
// of one row are distinct, so no two lanes of a slot touch one word, and a
// __syncwarp() between slots orders the slots' adds to a column.  Each
// column thus receives its values in slot order -- the order of the plain
// version, which adds the decompressed rows, whose other columns hold
// +0.0.  Adding +0.0 to an accumulator that started at +0.0 changes no
// bit (the accumulator is never -0.0), so the kernel is bitwise equal to
// decompress-then-gather-sum.  To keep many row loads in flight, a batch
// of kSlots slots (kPairs pairs a lane each) is loaded into registers
// before its adds.  Ids are read as they travel (int16 or int32, a
// template parameter): nothing is widened first.  An id outside [0, D) is
// skipped (top-k never produces one).  No atomics: deterministic.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kStaticSmem = 48 * 1024;     // no opt-in needed below this
constexpr int kMaxSmem = 227 * 1024;       // a block's most on sm_90

template <typename Id, int kSlots, int kPairs>
__global__ void sparse_gather_sum_kernel(const float* __restrict__ values,
                                         const Id* __restrict__ idx,
                                         const int* __restrict__ nbrs,
                                         const uint8_t* __restrict__ mask,
                                         float* __restrict__ out, long long P,
                                         int ps, int k, int D, int wpb) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long p = static_cast<long long>(blockIdx.x) * wpb + warp;
  if (p >= P) return;  // the whole warp leaves: no block barrier below
  float* acc = smem + static_cast<long long>(warp) * D;
  for (int c = lane; c < D; c += kWarp) acc[c] = 0.0f;
  __syncwarp();
  const int* nb = nbrs + p * ps;
  const uint8_t* mk = mask + p * ps;
  constexpr int kSpan = kWarp * kPairs;  // pairs a batch covers per slot
  for (int j0 = 0; j0 < ps; j0 += kSlots) {
    // with kSlots > 1 the host guarantees k <= kSpan: one pass of e0
    for (int e0 = 0; e0 < k; e0 += kSpan) {
      float v[kSlots][kPairs];
      int col[kSlots][kPairs];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int j = j0 + q;
        const bool live = j < ps && mk[j] != 0;
        const long long r = live ? static_cast<long long>(nb[j]) : 0;
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          const int e = e0 + lane + kWarp * t;
          col[q][t] = -1;
          v[q][t] = 0.0f;
          if (live && e < k) {
            v[q][t] = values[r * k + e];
            col[q][t] = static_cast<int>(idx[r * k + e]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
#pragma unroll
        for (int t = 0; t < kPairs; ++t) {
          const int c = col[q][t];
          if (static_cast<unsigned>(c) < static_cast<unsigned>(D))
            acc[c] += v[q][t];
        }
        __syncwarp();  // slot q's adds land before slot q + 1's
      }
    }
  }
  float* dst = out + p * D;
  for (int c = lane; c < D; c += kWarp) dst[c] = acc[c];
}

template <typename Id, int kSlots, int kPairs>
int launch(const float* values, const void* idx, const int* nbrs,
           const uint8_t* mask, float* out, long long P, int ps, int k, int D,
           cudaStream_t stream) {
  const long long row_bytes = 4LL * D;
  if (row_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = static_cast<int>(kStaticSmem / row_bytes);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
  const int smem = static_cast<int>(wpb * row_bytes);
  auto kernel = sparse_gather_sum_kernel<Id, kSlots, kPairs>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((P + wpb - 1) / wpb);
  kernel<<<grid, wpb * kWarp, smem, stream>>>(
      values, static_cast<const Id*>(idx), nbrs, mask, out, P, ps, k, D, wpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename Id>
int dispatch(const float* values, const void* idx, const int* nbrs,
             const uint8_t* mask, float* out, long long P, int ps, int k,
             int D, cudaStream_t s) {
  // one register batch holds every pair of 8 (or 4) slots up to k = 128;
  // wider rows go slot by slot, 128 pairs at a time
  if (k <= kWarp) return launch<Id, 8, 1>(values, idx, nbrs, mask, out, P, ps,
                                          k, D, s);
  if (k <= 2 * kWarp)
    return launch<Id, 8, 2>(values, idx, nbrs, mask, out, P, ps, k, D, s);
  if (k <= 4 * kWarp)
    return launch<Id, 4, 4>(values, idx, nbrs, mask, out, P, ps, k, D, s);
  return launch<Id, 1, 4>(values, idx, nbrs, mask, out, P, ps, k, D, s);
}

}  // namespace

extern "C" {

// id_bytes: 2 for int16 ids, 4 for int32 ids.
int mgg_sparse_gather_sum(const float* values, const void* idx,
                          const int* nbrs, const uint8_t* mask, float* out,
                          long long P, int ps, int k, int D, int id_bytes,
                          void* stream) {
  if (P == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 2)
    return dispatch<int16_t>(values, idx, nbrs, mask, out, P, ps, k, D, s);
  if (id_bytes == 4)
    return dispatch<int32_t>(values, idx, nbrs, mask, out, P, ps, k, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
