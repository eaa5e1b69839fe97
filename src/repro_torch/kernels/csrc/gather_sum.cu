// MGG neighbor gather-sum kernels for Hopper (sm_90a), bound with ctypes.
//
// K1 gather_sum_pipelined  replaces repro/kernels/neighbor_agg.py
//                          gather_sum_pipelined_call (_pipelined_kernel).
// K2 gather_sum_blocked    replaces repro/kernels/neighbor_agg.py
//                          gather_sum_blocked_call (_blocked_kernel).
// K3 segment_add_ordered   has no Pallas counterpart: it replaces the
//                          per-ring-step ``out.at[tgt].add(partial)`` of
//                          repro/core/pipeline.py (_mgg_shard_body).
// K4 scatter_sum_ordered   has no Pallas counterpart either: it replaces
//                          the gather-sum's backward, the masked scatter-add
//                          ``zeros.at[nbrs].add(g * mask)`` of
//                          repro/kernels/ops.py (_gather_sum_bwd); it runs
//                          K3's kernels on a transposed index.
//
// K1/K2 compute out[p] = sum_j mask[p, j] * buf[nbrs[p, j]] in fp32, the
// slots summed in order j = 0 .. ps-1 (masked slots are skipped: they add 0).
//
// What bounds them: bytes.  Each distinct gathered row is read once at a
// data-dependent address, each partition reads its ids and mask and writes
// one row: (distinct_rows * D * 4 + P * ps * 5 + P * D * 4) bytes over the
// card's memory rate, no arithmetic to speak of.  The work is per
// partition, not per row: in the products serving plan (D = 16, ps = 8) a
// partition holds 2.6 live slots of 8, carries 40 bytes of index and
// writes a 64-byte row -- 0.230 GB of index and 0.368 GB of output beside
// 0.312 GB of rows.
//
// K1's design: a group of G threads (the next power of two >= D / V, at
// most 32) owns a partition, each thread V columns of a column chunk of
// G * V: V = 4 (one float4) where D % 4 == 0 and buf and out sit on 16
// bytes, else V = 1.  At D = 16 that is 4 threads, so a warp holds 8
// partitions side by side; D > 32 * V loops over chunks.  A warp walks
// the partitions grid-stride (the grid is what fits the card at once) as
// a chain of steps (partition, chunk, batch of kSlots = 8 slots): a step
// issues every live slot's row into registers (masked slots load
// nothing), loads the next step's ids and mask, and then adds the rows in
// slot order.  So a warp keeps 8 partitions' index and live rows in
// flight, where the first K1 (a cp.async double buffer, two partitions a
// warp, each thread one word a slot) waited on eight serial index round
// trips a partition: with no row loaded and none written it still took
// 1.64 of its 1.98 ms.  Measured at the serving shapes (builds with parts
// removed, not kept with the source): 0.457 ms an aggregation; 0.271 with
// no rows loaded, 0.349 with no row written, 0.20 with neither; 0.517
// with one step a warp and no walk.  The adds are K2's and the plain
// version's, in the same order from +0: the bits are theirs.
//
// K2's design: one block owns pb partitions (the paper's warps-per-block
// knob), one warp per partition; the block stages its partitions' ids and
// mask in shared memory once.  P need not be a multiple of pb.  What
// bounds it: K1's bytes; what sets its time is the partitions in flight,
// one a warp (64 an SM at pb >= 2), times each one's life: the index round
// trip, the rows' round trip and its instructions, all paid by one warp
// for 2.6 live rows (about 2 us a partition at the serving shapes).  A
// lane owns a column (32 a chunk) and loads the rows of kSlots slots into
// registers before it adds the live ones in slot order from +0, where its
// first design walked the slots one load and add at a time (1.59 ms an
// aggregation).  Splitting the lanes between slots and float4 columns (8
// slots by 4 lanes at D = 16), with each row passed to its column's lane
// by shuffles, measured slower (2.07-2.69 ms), as did a persistent walk
// over tiles two deep (2.84-3.06 ms): they spend more instructions a
// partition.  The adds are K1's and the plain version's, so K2 == K1 ==
// plain, bitwise.
//
// K3's design: targets are sorted only up to their padding, and a row with
// degree > ps owns several partitions, so a plain scatter-add needs atomics
// and its bits change from run to run.  The host builds, once per plan, a
// stable argsort of each target array plus segment offsets; each
// destination row adds its partials in partition order onto its old value.
// One owner per output word: deterministic, no atomics.  It moves (P * D *
// 4 + P * 4 + S * 8 + 2 * S * D * 4) bytes for P partials into S rows,
// read as 16-byte float4 (V = 4) wherever D % 4 == 0.  Its time is set by
// the bytes and by the longest serial walk, a hub row's (8,123 partials in
// the products serving plan).  So the host cuts every segment longer than
// a chunk length C (ops.chunk_length: the largest power of two not above
// sqrt(L / 8) for the longest segment L, at least 64) into chunks of C:
// pass 1 sums each hub chunk in partition order into a scratch row, pass 2
// adds a hub's chunk sums in chunk order and any other segment's partials
// as without chunks.  The walk drops from L to C + ceil(L / C); the
// association is fixed by the index, and the plain version takes the same
// two passes, bitwise.  Every walk of more than kShortLen entries is made
// by a whole warp (warp_walk): lanes split into S slots by G column
// groups, a lane has kWalk rows in flight while the next ids load, and
// the adds run in order through shuffles.  Three launches: pass 1, a warp
// a chunk; the long segments (a warp reads 32 segments' offsets and walks
// each long one in turn); the short ones, at most kShortLanes lanes each,
// a batch of rows in flight, so that this launch, which holds most of the
// work, keeps its registers few and the card full.
//
// K4 computes dbuf[r] += sum of g[src(k)] over the masked slots k whose
// neighbor id is r: the transpose of K1/K2.  A CUDA scatter-add of the
// slots would need atomics (and its bits would change from run to run), so
// the host builds, once per plan, the transposed index (ops.GradIndex):
// the masked slots sorted stably by neighbor row (segment offsets per
// distinct row) and, per slot, the row of g it reads -- in the ring that
// is the slot's target row tgt[p], composed on the host, so the backward
// never materialises the per-partition gradient.  That is K3's problem
// with g in place of the partials and src as the order, and K4 runs K3's
// pair on it (mgg_segment_add_ordered) with the index's own hub chunks.
// What bounds it: bytes, (G * D * 4 + K * 4 + S * 8 + 2 * S * D * 4) for K
// masked slots reading G distinct rows of g into S rows.  Its tail is the
// longest walk: a hub neighbor is named by up to 173,973 slots of one ring
// step in the products training plan, about 20 times K3's longest
// segment, so its chunks are longer (128 there against K3's 64, by the
// same rule).  Its
// first design ran one thread a (row, column) on scalar floats and cut
// every row into chunks of 256 once any row was longer, with a zeroed
// scratch of chunk sums for all of them: 3.05 ms an aggregation, 1.95 of
// them in pass 1's serial 256-slot walks.
//
// Every launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K1 / K3 block size
constexpr int kSlots = 8;      // K1: slots a register batch
constexpr int kSegBatch = 16;  // K3/K4: words a lane loads ahead of adds
constexpr int kWalk = 8;       // K3/K4 warp walk: rows a lane has in flight
constexpr int kShortLen = 16;  // K3/K4: a segment of at most this many
                               // entries (and no hub) is short
constexpr int kShortLanes = 8; // K3/K4: lanes a short segment, at most

// V columns a thread, as one float4 where V = 4 (K1-K4).
template <int V>
struct Cols;
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
  static __device__ __forceinline__ T shfl(T a, int lane) {
    return __shfl_sync(0xffffffffu, a, lane);
  }
};
template <>
struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ T shfl(T a, int lane) {
    return make_float4(__shfl_sync(0xffffffffu, a.x, lane),
                       __shfl_sync(0xffffffffu, a.y, lane),
                       __shfl_sync(0xffffffffu, a.z, lane),
                       __shfl_sync(0xffffffffu, a.w, lane));
  }
};

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The lanes that share a row (K1-K4): the next power of two >= ceil(D /
// V), at most 32.
int group_threads(int D, int V) {
  const int nv = (D + V - 1) / V;
  int g = 1;
  while (g < nv && g < 32) g *= 2;
  return g;
}

// K1: slots j0 .. j0 + kSlots - 1 of partition p, their ids and a bit a
// live slot (none past ps, none for p >= P).
struct SlotBatch {
  int id[kSlots];
  unsigned live;
};

__device__ __forceinline__ SlotBatch load_slots(
    const int* __restrict__ nbrs, const uint8_t* __restrict__ mask,
    long long p, long long P, int ps, int j0) {
  SlotBatch b;
  b.live = 0;
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    b.id[u] = 0;
    if (p < P && j0 + u < ps) {
      b.id[u] = nbrs[p * ps + j0 + u];
      if (mask[p * ps + j0 + u]) b.live |= 1u << u;
    }
  }
  return b;
}

// A group of G threads (a power of two, <= 32) owns a partition, each
// thread V columns of a column chunk of G * V; a warp holds 32 / G
// partitions side by side and walks the partitions grid-stride.  Its walk
// is a chain of steps (partition, column chunk, batch of kSlots slots):
// a step issues every live slot's row into registers, loads the next
// step's ids and mask, then adds the rows in slot order.
template <int V>
__global__ void __launch_bounds__(kThreads)
    gather_sum_pipelined_kernel(const float* __restrict__ buf,
                                const int* __restrict__ nbrs,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, long long P, int ps,
                                int D, int G) {
  using T = typename Cols<V>::T;
  const int lane = threadIdx.x % 32;
  const int sub = lane / G;  // this thread's partition within the warp
  const int col = (lane % G) * V;
  const int chunk = G * V;
  const long long ppw = 32 / G;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const long long stride = static_cast<long long>(gridDim.x) *
                           (blockDim.x / 32) * ppw;
  long long p = warp * ppw + sub;
  int j0 = 0, c0 = 0;
  SlotBatch cur = load_slots(nbrs, mask, p, P, ps, 0);
  T acc = Cols<V>::zero();
  while (p - sub < P) {  // the warp's first partition: uniform
    const int c = c0 + col;
    const unsigned live = c < D ? cur.live : 0u;
    T v[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      v[u] = Cols<V>::zero();
      if ((live >> u) & 1u)
        v[u] = *reinterpret_cast<const T*>(
            buf + static_cast<size_t>(cur.id[u]) * D + c);
    }
    // the next step: the next batch, else the next chunk, else partition
    int nj = j0 + kSlots, nc = c0;
    long long np = p;
    const bool done = nj >= ps;
    if (done) {
      nj = 0;
      nc = c0 + chunk;
      if (nc >= D) {
        nc = 0;
        np = p + stride;
      }
    }
    const SlotBatch next = load_slots(nbrs, mask, np, P, ps, nj);
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if ((live >> u) & 1u) Cols<V>::add(acc, v[u]);
    if (done) {
      if (p < P && c < D) *reinterpret_cast<T*>(out + p * D + c) = acc;
      acc = Cols<V>::zero();
    }
    cur = next;
    j0 = nj;
    c0 = nc;
    p = np;
  }
}

// K2: one block owns pb partitions, one warp each, and stages their ids
// and mask in shared memory once.  A lane owns a column of the partition
// (32 columns a chunk); each step loads the rows of kSlots slots into
// registers (masked slots load nothing), then adds the live ones in slot
// order from +0.
__global__ void gather_sum_blocked_kernel(const float* __restrict__ buf,
                                          const int* __restrict__ nbrs,
                                          const uint8_t* __restrict__ mask,
                                          float* __restrict__ out, long long P,
                                          int ps, int D) {
  extern __shared__ int ids[];  // [pb * ps] neighbor ids, then [pb * ps] mask
  const int pb = blockDim.x / 32;
  int* s_nbr = ids;
  int* s_msk = ids + pb * ps;
  const long long p0 = static_cast<long long>(blockIdx.x) * pb;
  for (int i = threadIdx.x; i < pb * ps; i += blockDim.x) {
    const bool ok = p0 + i / ps < P;
    s_nbr[i] = ok ? nbrs[p0 * ps + i] : 0;
    s_msk[i] = ok ? static_cast<int>(mask[p0 * ps + i]) : 0;
  }
  __syncthreads();
  const long long p = p0 + threadIdx.x / 32;
  if (p >= P) return;
  const int* my_nbr = s_nbr + (threadIdx.x / 32) * ps;
  const int* my_msk = s_msk + (threadIdx.x / 32) * ps;
  for (int c = threadIdx.x % 32; c < D; c += 32) {
    float acc = 0.0f;
    for (int j0 = 0; j0 < ps; j0 += kSlots) {
      float v[kSlots];
      unsigned live = 0;
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        v[u] = 0.0f;
        if (j0 + u < ps && my_msk[j0 + u]) {
          live |= 1u << u;
          v[u] = buf[static_cast<size_t>(my_nbr[j0 + u]) * D + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        if ((live >> u) & 1u) acc += v[u];
    }
    out[p * D + c] = acc;
  }
}

// acc += src[order[k]] (columns c .. c + V - 1) for k = k0 .. k1 - 1 in k
// order; the rows of a batch are in flight together.
template <int V>
__device__ __forceinline__ void add_rows(typename Cols<V>::T& acc,
                                         const float* __restrict__ src,
                                         const int* __restrict__ order,
                                         int k0, int k1, int D, int c) {
  using T = typename Cols<V>::T;
  constexpr int kB = kSegBatch / V;
  auto row = [&](int k) {
    return *reinterpret_cast<const T*>(
        src + static_cast<size_t>(order[k]) * D + c);
  };
  int k = k0;
  for (; k + kB <= k1; k += kB) {
    T v[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) v[u] = row(k + u);
#pragma unroll
    for (int u = 0; u < kB; ++u) Cols<V>::add(acc, v[u]);
  }
  for (; k < k1; ++k) Cols<V>::add(acc, row(k));
}

// The whole warp adds src[id(k)] (id(k) = order[k], or k without an
// order) for k = k0 .. k1 - 1 onto acc in k order, columns c .. c + V - 1
// of each lane: the lanes are S = 32 / G slots by G column groups, and
// every lane of a column group returns the same sum.  A step loads kWalk
// rows a lane (kWalk * S entries) while the next step's ids load, then
// adds the rows in k order, each taken from its lane by a shuffle.
// k0, k1 and G are the same on every lane.
template <int V, bool kOrder>
__device__ __forceinline__ typename Cols<V>::T warp_walk(
    typename Cols<V>::T acc, const float* __restrict__ src,
    const int* __restrict__ order, int k0, int k1, int D, int c, int G) {
  using T = typename Cols<V>::T;
  const int lane = threadIdx.x % 32;
  const int S = 32 / G, u = lane / G, cg = lane % G;
  const int step = kWalk * S;
  auto id_at = [&](int k) { return k < k1 ? (kOrder ? order[k] : k) : -1; };
  int id[kWalk];
#pragma unroll
  for (int r = 0; r < kWalk; ++r) id[r] = id_at(k0 + r * S + u);
  for (int k = k0; k < k1; k += step) {
    T v[kWalk];
#pragma unroll
    for (int r = 0; r < kWalk; ++r) {
      v[r] = Cols<V>::zero();
      if (id[r] >= 0 && c < D)
        v[r] = *reinterpret_cast<const T*>(
            src + static_cast<size_t>(id[r]) * D + c);
    }
#pragma unroll
    for (int r = 0; r < kWalk; ++r) id[r] = id_at(k + step + r * S + u);
#pragma unroll
    for (int r = 0; r < kWalk; ++r) {
      if (k + r * S >= k1) break;
      for (int x = 0; x < S; ++x) {
        const T row = Cols<V>::shfl(v[r], x * G + cg);
        if (k + r * S + x < k1) Cols<V>::add(acc, row);
      }
    }
  }
  return acc;
}

// K3 pass 1: sums[ch] = sum of partial[order[k]] over chunk ch, from zero;
// a warp a chunk.
template <int V>
__global__ void __launch_bounds__(kThreads)
    segment_chunk_sum_kernel(float* __restrict__ sums,
                             const float* __restrict__ partial,
                             const int* __restrict__ order,
                             const int* __restrict__ chunk_start,
                             const int* __restrict__ chunk_end,
                             long long n_chunks, int D, int G) {
  using T = typename Cols<V>::T;
  const long long ch =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (ch >= n_chunks) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int k0 = chunk_start[ch], k1 = chunk_end[ch];
  for (int c0 = 0; c0 < D; c0 += G * V) {
    const int c = c0 + (lane % G) * V;
    const T acc = warp_walk<V, true>(Cols<V>::zero(), partial, order, k0, k1,
                                     D, c, G);
    if (lane < G && c < D) *reinterpret_cast<T*>(sums + ch * D + c) = acc;
  }
}

// K3 pass 2: a segment walked by the whole warp (warp_walk) rather than by
// its own lanes: longer than kShortLen entries, or a hub.
__device__ __forceinline__ bool long_segment(int len, int n_hubs,
                                             int chunk_len) {
  return len > kShortLen || (n_hubs > 0 && len > chunk_len);
}

// K3 pass 2 (or the only pass), long segments: out[seg_rows[s]] += each
// partial of segment s in order, or, for a hub (a segment longer than
// chunk_len found in hubs), its chunk sums in chunk order.  A warp reads
// the offsets of 32 segments, one a lane, and walks each long one of them
// in turn with all its lanes.
template <int V>
__global__ void __launch_bounds__(kThreads)
    segment_long_kernel(float* __restrict__ out,
                        const float* __restrict__ partial,
                        const int* __restrict__ order,
                        const int* __restrict__ seg_rows,
                        const int* __restrict__ seg_start, long long n_seg,
                        int D, const float* __restrict__ sums,
                        const int* __restrict__ hubs,
                        const int* __restrict__ hub_chunks, int n_hubs,
                        int chunk_len, int G) {
  using T = typename Cols<V>::T;
  const int lane = threadIdx.x % 32;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
      32;
  if (first >= n_seg) return;  // warp-uniform
  const long long s = first + lane;
  int k0 = 0, k1 = 0;
  if (s < n_seg) {
    k0 = seg_start[s];
    k1 = seg_start[s + 1];
  }
  unsigned todo = __ballot_sync(
      0xffffffffu, s < n_seg && long_segment(k1 - k0, n_hubs, chunk_len));
  const int u = lane / G, cg = lane % G;
  while (todo) {
    const int lead = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long sl = first + lead;
    const int a = __shfl_sync(0xffffffffu, k0, lead);
    const int b = __shfl_sync(0xffffffffu, k1, lead);
    int hub = -1;
    if (b - a > chunk_len && n_hubs > 0) {  // find sl among the hubs
      int lo = 0, hi = n_hubs;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (hubs[mid] < sl) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < n_hubs && hubs[lo] == sl) hub = lo;
    }
    float* row = out + static_cast<size_t>(seg_rows[sl]) * D;
    for (int c0 = 0; c0 < D; c0 += G * V) {
      const int c = c0 + cg * V;
      T acc = c < D ? *reinterpret_cast<const T*>(row + c) : Cols<V>::zero();
      if (hub >= 0) {
        acc = warp_walk<V, false>(acc, sums, nullptr, hub_chunks[hub],
                                  hub_chunks[hub + 1], D, c, G);
      } else {
        acc = warp_walk<V, true>(acc, partial, order, a, b, D, c, G);
      }
      if (u == 0 && c < D) *reinterpret_cast<T*>(row + c) = acc;
    }
  }
}

// K3 pass 2 (or the only pass), short segments: a group of G lanes
// (at most kShortLanes) adds segment s's partials onto out[seg_rows[s]] in
// order, kSegBatch / V rows at a time, looping over column chunks.
template <int V>
__global__ void __launch_bounds__(kThreads)
    segment_short_kernel(float* __restrict__ out,
                         const float* __restrict__ partial,
                         const int* __restrict__ order,
                         const int* __restrict__ seg_rows,
                         const int* __restrict__ seg_start, long long n_seg,
                         int D, int n_hubs, int chunk_len, int G) {
  using T = typename Cols<V>::T;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long s = t / G;
  if (s >= n_seg) return;
  const int k0 = seg_start[s], k1 = seg_start[s + 1];
  if (long_segment(k1 - k0, n_hubs, chunk_len)) return;
  float* row = out + static_cast<size_t>(seg_rows[s]) * D;
  for (int c = static_cast<int>(t % G) * V; c < D; c += G * V) {
    T* dst = reinterpret_cast<T*>(row + c);
    T acc = *dst;
    add_rows<V>(acc, partial, order, k0, k1, D, c);
    *dst = acc;
  }
}

template <int V>
int launch_segment_add(float* out, const float* partial, const int* order,
                       const int* seg_rows, const int* seg_start,
                       long long n_seg, int D, const int* hubs,
                       const int* hub_chunks, long long n_hubs,
                       const int* chunk_start, const int* chunk_end,
                       long long n_chunks, int chunk_len, float* sums,
                       cudaStream_t stream) {
  const int G = group_threads(D, V);
  const long long per_block = kThreads / 32;  // warps a block
  if (n_chunks > 0) {
    segment_chunk_sum_kernel<V>
        <<<static_cast<unsigned>((n_chunks + per_block - 1) / per_block),
           kThreads, 0, stream>>>(sums, partial, order, chunk_start,
                                  chunk_end, n_chunks, D, G);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long warps = (n_seg + 31) / 32;
  segment_long_kernel<V>
      <<<static_cast<unsigned>((warps + per_block - 1) / per_block),
         kThreads, 0, stream>>>(out, partial, order, seg_rows, seg_start,
                                n_seg, D, sums, hubs, hub_chunks,
                                static_cast<int>(n_hubs), chunk_len, G);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g_short = G < kShortLanes ? G : kShortLanes;
  const long long threads = n_seg * g_short;
  segment_short_kernel<V>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
         kThreads, 0, stream>>>(out, partial, order, seg_rows, seg_start,
                                n_seg, D, static_cast<int>(n_hubs),
                                chunk_len, g_short);
  return static_cast<int>(cudaGetLastError());
}

// K1: as many blocks as fit the card at once (the walk is grid-stride),
// no more than the partitions need.
template <int V>
int launch_pipelined(const float* buf, const int* nbrs, const uint8_t* mask,
                     float* out, long long P, int ps, int D,
                     cudaStream_t stream) {
  auto kernel = gather_sum_pipelined_kernel<V>;
  static int per_sm = 0;  // resident blocks an SM: the same on every H100
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = group_threads(D, V);
  const long long per_block = (kThreads / 32) * (32 / G);
  const long long need = (P + per_block - 1) / per_block;
  const long long fit = static_cast<long long>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(need < fit ? need : fit);
  kernel<<<grid, kThreads, 0, stream>>>(buf, nbrs, mask, out, P, ps, D, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mgg_gather_sum_pipelined(const float* buf, const int* nbrs,
                             const uint8_t* mask, float* out, long long P,
                             int ps, int D, void* stream) {
  if (P == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(buf) && aligned16(out))
    return launch_pipelined<4>(buf, nbrs, mask, out, P, ps, D, s);
  return launch_pipelined<1>(buf, nbrs, mask, out, P, ps, D, s);
}

int mgg_gather_sum_blocked(const float* buf, const int* nbrs,
                           const uint8_t* mask, float* out, long long P,
                           int ps, int D, int pb, void* stream) {
  if (P == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>((P + pb - 1) / pb);
  const size_t smem = 2 * static_cast<size_t>(pb) * ps * sizeof(int);
  gather_sum_blocked_kernel<<<grid, pb * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      buf, nbrs, mask, out, P, ps, D);
  return static_cast<int>(cudaGetLastError());
}

// hubs == nullptr (n_hubs = n_chunks = 0): one pass.  Otherwise sums
// (n_chunks, D), scratch that pass 1 fills, receives each chunk's sum
// (order[chunk_start[c]] .. order[chunk_end[c] - 1]), and hub hubs[h] adds
// its chunks hub_chunks[h] .. hub_chunks[h + 1] - 1 in order.
int mgg_segment_add_ordered(float* out, const float* partial, const int* order,
                            const int* seg_rows, const int* seg_start,
                            long long n_seg, int D, const int* hubs,
                            const int* hub_chunks, long long n_hubs,
                            const int* chunk_start, const int* chunk_end,
                            long long n_chunks, int chunk_len, float* sums,
                            void* stream) {
  if (n_seg == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(out) && aligned16(partial) && aligned16(sums))
    return launch_segment_add<4>(out, partial, order, seg_rows, seg_start,
                                 n_seg, D, hubs, hub_chunks, n_hubs,
                                 chunk_start, chunk_end, n_chunks, chunk_len,
                                 sums, s);
  return launch_segment_add<1>(out, partial, order, seg_rows, seg_start,
                               n_seg, D, hubs, hub_chunks, n_hubs,
                               chunk_start, chunk_end, n_chunks, chunk_len,
                               sums, s);
}

}  // extern "C"
