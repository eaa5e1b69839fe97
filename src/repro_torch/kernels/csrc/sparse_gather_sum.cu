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
// What bounds it, on paper: bytes.  Each distinct gathered row is read
// once, k * (4 + sizeof(id)) bytes at a data-dependent address; each
// partition reads its ids and mask (ps * 5 bytes) and writes one D-wide
// row: (distinct_rows * k * (4 + id) + P * ps * 5 + P * D * 4) bytes over
// the card's memory rate.  At the fig9e width (D = 96, k = 24, int16 ids,
// ps = 8) a partition holds 2.5 live slots of 8 and the output row is 65 %
// of those bytes.  What bounds it in practice is the work a warp does per
// partition and per live slot around those bytes: timed with parts
// removed (builds not kept with the source), the first K6 -- one warp a
// partition, every lane loading all ps ids and mask bytes, a batch of 8
// slots a step -- spent 2.58 of its 3.68 ms with no rows loaded and no row
// written, and the output write only 0.15.
//
// The TPU kernel streams one compressed row per grid step and expands it
// into each db-wide output block with a one-hot matmul on the MXU.  Here
// the decompression is a scatter into shared memory.  A warp owns a group
// of Q = 32 / span partitions (span: the next power of two >= ps, at most
// 32; Q = 4 at ps = 8) and their D-wide fp32 accumulators, zeroed (+0.0).
// One load a lane brings a window of the group's ids and mask bytes, and
// one ballot ranks the live slots in (partition, slot) order; the live
// lanes write their row and accumulator offset into a list in shared
// memory at their rank, so a slot costs the warp one broadcast read where
// picking it by ffs and shfl cost a chain of them.  The warp takes the
// list four slots at a time (one past 128 pairs), loads their pairs into
// registers, lane l taking pairs l, l + 32, ..., and adds them, one slot a
// step with a __syncwarp() between slots, into the accumulators.  The ids
// of one row are distinct, so no two lanes of a slot touch one word, and
// each column receives its values in slot order -- the order of the plain
// version, which adds the decompressed rows, whose other columns hold
// +0.0.  Adding +0.0 to an accumulator that started at +0.0 changes no bit
// (it is never -0.0), so the kernel is bitwise equal to
// decompress-then-gather-sum.
// Ids are read as they travel (int16 or int32, a template parameter); an
// id outside [0, D) is skipped (top-k never produces one).  No atomics:
// deterministic.  The group goes out as float4 where D % 4 == 0.
//
// Measured at the fig9e layer-1 shapes: 1.69 ms an aggregation against the
// first K6's 3.68; 1.43 with no rows loaded, 1.47 with no row written,
// 0.90 with neither, so the per-slot work still leads.  Four slots a
// batch beat 2, 3, 5, 6 and 8 (timed on an occupancy-sized grid); four
// warps a block beat eight (1.69 against 1.74).  The kernel can walk
// groups grid-stride, but the host launches one group a warp: an
// occupancy-sized grid, each warp walking many groups, ran 1.92.  Slower
// too: rows copied by cp.async into a ring of shared-memory stages
// (2.72) and rows scattered into dense staging rows summed by column
// owners (3.23).
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kStaticSmem = 48 * 1024;  // no opt-in needed below this
constexpr int kMaxSmem = 227 * 1024;    // a block's most on sm_90

__host__ __device__ constexpr int round4(int words) {
  return (words + 3) / 4 * 4;
}

// A warp walks groups of Q = 32 >> shift partitions grid-stride, each in
// windows of span = 1 << shift slots.  Lane l of a window holds the id and
// liveness of slot w0 + l % span of partition l / span of the group,
// loaded one window ahead.  A ballot ranks the window's live slots in
// (partition, slot) order; each live lane writes its row and its
// partition's accumulator offset into the warp's list at its rank.  The
// warp then takes the list kSlots entries at a time: their rows' pairs
// are loaded into registers (kPairs a lane) and added, one slot a step,
// into the group's accumulators in shared memory.  After a group's last
// window the accumulators are written out and zeroed in one pass.
template <typename Id, int kSlots, int kPairs, bool kVec4>
__global__ void __launch_bounds__(kMaxWarpsPerBlock* kWarp)
    sparse_gather_sum_kernel(const float* __restrict__ values,
                             const Id* __restrict__ idx,
                             const int* __restrict__ nbrs,
                             const uint8_t* __restrict__ mask,
                             float* __restrict__ out, long long P, int ps,
                             int k, int D, int shift) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int wpb = blockDim.x / kWarp;
  const int span = 1 << shift;
  const int Q = kWarp >> shift;
  const int width = Q * D;  // the group's accumulators, side by side
  float* acc =
      smem + static_cast<long long>(warp) * (round4(width) + 2 * kWarp);
  int* list_row = reinterpret_cast<int*>(acc + round4(width));
  int* list_at = list_row + kWarp;
  for (int c = lane; c < width; c += kWarp) acc[c] = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * wpb * Q;
  long long p0 = (static_cast<long long>(blockIdx.x) * wpb + warp) * Q;
  int w0 = 0;
  auto load = [&](long long pp, int ww, int& id, bool& live) {
    const long long p = pp + (lane >> shift);
    const int j = ww + (lane & (span - 1));
    id = 0;
    live = false;
    if (p < P && j < ps) {
      id = nbrs[p * ps + j];
      live = mask[p * ps + j] != 0;
    }
  };
  int id;
  bool live;
  load(p0, w0, id, live);
  constexpr int kSpan = kWarp * kPairs;  // pairs a batch covers per slot
  while (p0 < P) {  // p0 is the same on every lane
    const unsigned bits = __ballot_sync(kFull, live);
    const int n_live = __popc(bits);
    if (live) {
      const int rank = __popc(bits & ((1u << lane) - 1u));
      list_row[rank] = id;
      list_at[rank] = (lane >> shift) * D;
    }
    long long np0 = p0;
    int nw0 = w0 + span;
    if (nw0 >= ps) {
      nw0 = 0;
      np0 = p0 + stride;
    }
    load(np0, nw0, id, live);  // in flight during this window
    __syncwarp();              // the list is written
    for (int b = 0; b < n_live; b += kSlots) {
      // with kSlots > 1 the host guarantees k <= kSpan: one pass of e0
      for (int e0 = 0; e0 < k; e0 += kSpan) {
        float v[kSlots][kPairs];
        int col[kSlots][kPairs];
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const bool has = b + q < n_live;
          const int row = has ? list_row[b + q] : 0;
#pragma unroll
          for (int t = 0; t < kPairs; ++t) {
            const int e = e0 + lane + kWarp * t;
            col[q][t] = -1;
            v[q][t] = 0.0f;
            if (has && e < k) {
              const size_t at = static_cast<size_t>(row) * k + e;
              v[q][t] = values[at];
              col[q][t] = static_cast<int>(idx[at]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          if (b + q >= n_live) break;
          float* a = acc + list_at[b + q];
#pragma unroll
          for (int t = 0; t < kPairs; ++t) {
            const int c = col[q][t];
            if (static_cast<unsigned>(c) < static_cast<unsigned>(D))
              a[c] += v[q][t];
          }
          __syncwarp();  // slot q's adds land before slot q + 1's
        }
      }
    }
    if (np0 != p0) {  // the group's last window: write out, zero
      const long long left = (P - p0) * D;  // the last group may be short
      const int n_out = left < width ? static_cast<int>(left) : width;
      float* dst = out + p0 * D;
      if constexpr (kVec4) {
        float4* a4 = reinterpret_cast<float4*>(acc);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int c = lane; c < n_out / 4; c += kWarp) {
          d4[c] = a4[c];
          a4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int c = lane; c < n_out; c += kWarp) {
          dst[c] = acc[c];
          acc[c] = 0.0f;
        }
      }
    }
    __syncwarp();  // the zeros and the list's reads land before reuse
    p0 = np0;
    w0 = nw0;
  }
}

// Shared memory a warp needs, in bytes: Q accumulators and its list.
long long warp_bytes(int D, int shift) {
  return 4LL * (round4((kWarp >> shift) * D) + 2 * kWarp);
}

// span = 1 << shift: lanes a partition's window, a power of two >=
// min(ps, 32), raised until a warp fits 48 KB (or span = 32); wpb (at
// most 4) warps a block, one where a warp needs the dynamic opt-in; one
// group a warp.
template <typename Id, int kSlots, int kPairs, bool kVec4>
int launch(const float* values, const void* idx, const int* nbrs,
           const uint8_t* mask, float* out, long long P, int ps, int k, int D,
           cudaStream_t stream) {
  int shift = 0;
  while ((1 << shift) < ps && (1 << shift) < kWarp) ++shift;
  while ((1 << shift) < kWarp && warp_bytes(D, shift) > kStaticSmem) ++shift;
  const long long bytes = warp_bytes(D, shift);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int wpb = static_cast<int>(kStaticSmem / bytes);
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : wpb);
  const int smem = static_cast<int>(wpb * bytes);
  auto kernel = sparse_gather_sum_kernel<Id, kSlots, kPairs, kVec4>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = static_cast<long long>(wpb) * (kWarp >> shift);
  const unsigned grid = static_cast<unsigned>((P + per_block - 1) / per_block);
  kernel<<<grid, wpb * kWarp, smem, stream>>>(
      values, static_cast<const Id*>(idx), nbrs, mask, out, P, ps, k, D,
      shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename Id, bool kVec4>
int by_pairs(const float* values, const void* idx, const int* nbrs,
             const uint8_t* mask, float* out, long long P, int ps, int k,
             int D, cudaStream_t s) {
  // a register batch: 4 slots of up to 128 pairs; wider rows go slot by
  // slot, 128 pairs at a time
  if (k <= kWarp)
    return launch<Id, 4, 1, kVec4>(values, idx, nbrs, mask, out, P, ps, k, D,
                                   s);
  if (k <= 2 * kWarp)
    return launch<Id, 4, 2, kVec4>(values, idx, nbrs, mask, out, P, ps, k, D,
                                   s);
  if (k <= 4 * kWarp)
    return launch<Id, 4, 4, kVec4>(values, idx, nbrs, mask, out, P, ps, k, D,
                                   s);
  return launch<Id, 1, 4, kVec4>(values, idx, nbrs, mask, out, P, ps, k, D,
                                 s);
}

template <typename Id>
int dispatch(const float* values, const void* idx, const int* nbrs,
             const uint8_t* mask, float* out, long long P, int ps, int k,
             int D, cudaStream_t s) {
  // float4 rows out where D % 4 == 0 and out sits on 16 bytes
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return by_pairs<Id, true>(values, idx, nbrs, mask, out, P, ps, k, D, s);
  return by_pairs<Id, false>(values, idx, nbrs, mask, out, P, ps, k, D, s);
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
