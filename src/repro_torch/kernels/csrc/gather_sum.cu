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
//                          repro/kernels/ops.py (_gather_sum_bwd).
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
// mask in shared memory once and each lane loops over the slots for its
// columns.  P need not be a multiple of pb.
//
// K3's design: targets are sorted only up to their padding, and a row with
// degree > ps owns several partitions, so a plain scatter-add needs atomics
// and its bits change from run to run.  The host builds, once per plan, a
// stable argsort of each target array plus segment offsets; here a thread
// owns one (destination row, group of V columns) and adds that row's
// partials in partition order.  One owner per output word: deterministic,
// no atomics.  It moves (P * D * 4 + P * 4 + S * 8 + 2 * S * D * 4) bytes
// for P partials into S rows.  Two things set its time: the bytes, read as
// 16-byte float4 (V = 4, four threads a 64-byte row at D = 16) wherever D
// % 4 == 0; and the longest serial walk, a hub row's (8,123 partials in the
// products serving plan).  So the host also cuts every segment longer than
// a chunk length C (ops.SEG_CHUNK) into chunks of C partials: pass 1 sums
// each hub chunk in partition order into a scratch row, pass 2 runs every
// segment, a hub adding its chunk sums in chunk order, any other its
// partials as without chunks (same bits, no scratch).  The longest walk
// drops from L to C + ceil(L / C); the association is fixed by the index,
// and the plain version takes the same two passes, bitwise.
// K4 computes dbuf[r] += sum of g[src(k)] over the masked slots k whose
// neighbor id is r: the transpose of K1/K2.  A CUDA scatter-add of the
// slots would need atomics (and its bits would change from run to run), so
// the host builds, once per plan, the transposed index: the masked slots
// sorted stably by neighbor row (segment offsets per distinct row) and, per
// slot, the row of g it reads -- in the ring that is the slot's target row
// tgt[p], composed on the host, so the backward never materialises the
// per-partition gradient.  That is K3's problem with a gather index in
// front, so K4 runs the ordered segment-sum kernel that K3 ran before it
// took its own (ordered_segment_sum_kernel, reading g[src[k]]): one thread
// owns one (row, column).  What bounds it: bytes, (G * D * 4 + K * 4 + S * 8 +
// 2 * S * D * 4) for K masked slots reading G distinct rows of g into S
// rows.  Its tail is the longest segment: a hub neighbor is named by
// ~1e5 slots of one ring step, where K3's longest segment is ps times
// shorter.  So when a segment is longer than the host's chunk (256 slots),
// K4 runs two passes of the kernel: each chunk's slots summed in slot
// order into a scratch row (pass 1, identity rows), then each row's chunk
// sums added in chunk order (pass 2, identity order).  The association is
// fixed by the index, so the bits are the same from run to run, and the
// plain version takes the same two passes.
//
// Every launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // K1 / K3 block size
constexpr int kSlots = 8;      // K1: slots a register batch
constexpr int kSegBatch = 32;  // K3/K4: partial words loaded ahead of adds

// V columns a thread, as one float4 where V = 4 (K1, K3).
template <int V>
struct Cols;
template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
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
};

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
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p = p0 + w;
  if (p >= P) return;
  const int* my_nbr = s_nbr + w * ps;
  const int* my_msk = s_msk + w * ps;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.0f;
    for (int j = 0; j < ps; ++j) {
      if (my_msk[j]) acc += buf[static_cast<size_t>(my_nbr[j]) * D + c];
    }
    out[p * D + c] = acc;
  }
}

// out[seg_rows[s]] += sum over k in segment s of partial[order[k]], added in
// k order (K4).  Without kRows the row is s, without kOrder the partial is
// k (K4's two passes); K4's one pass takes both.
template <bool kOrder, bool kRows>
__global__ void ordered_segment_sum_kernel(float* __restrict__ out,
                                          const float* __restrict__ partial,
                                          const int* __restrict__ order,
                                          const int* __restrict__ seg_rows,
                                          const int* __restrict__ seg_start,
                                          long long n_seg, int D) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_seg * D) return;
  const long long s = t / D;
  const int c = static_cast<int>(t - s * D);
  long long row = s;
  if constexpr (kRows) row = seg_rows[s];
  float* dst = out + static_cast<size_t>(row) * D + c;
  float acc = *dst;
  const int end = seg_start[s + 1];
  int k = seg_start[s];
  // A hub row owns thousands of partitions in one step.  Loading kSegBatch
  // partials before adding them keeps that many loads in flight instead of
  // one, and the next batch's ids load while this batch's rows are in
  // flight; the adds still run in partition order, so the bits do not change.
  if (k + kSegBatch <= end) {
    int ids[kSegBatch];
#pragma unroll
    for (int u = 0; u < kSegBatch; ++u) {
      if constexpr (kOrder) {
        ids[u] = order[k + u];
      } else {
        ids[u] = k + u;
      }
    }
    for (; k + kSegBatch <= end; k += kSegBatch) {
      float v[kSegBatch];
#pragma unroll
      for (int u = 0; u < kSegBatch; ++u) {
        v[u] = partial[static_cast<size_t>(ids[u]) * D + c];
      }
      const int next = k + kSegBatch;
#pragma unroll
      for (int u = 0; u < kSegBatch; ++u) {
        if constexpr (kOrder) {
          ids[u] = next + u < end ? order[next + u] : 0;
        } else {
          ids[u] = next + u;
        }
      }
#pragma unroll
      for (int u = 0; u < kSegBatch; ++u) acc += v[u];
    }
  }
  for (; k < end; ++k) {
    long long id = k;
    if constexpr (kOrder) id = order[k];
    acc += partial[static_cast<size_t>(id) * D + c];
  }
  *dst = acc;
}

// acc += src[id(k)] (columns c .. c + V - 1) for k = k0 .. k1 - 1 in k
// order, id(k) = order[k] (or k without an order); the rows of a batch are
// in flight together.
template <int V, bool kOrder>
__device__ __forceinline__ void add_rows(typename Cols<V>::T& acc,
                                         const float* __restrict__ src,
                                         const int* __restrict__ order,
                                         int k0, int k1, int D, int c) {
  using T = typename Cols<V>::T;
  constexpr int kB = kSegBatch / V;
  auto row = [&](int k) {
    const long long id = kOrder ? order[k] : k;
    return *reinterpret_cast<const T*>(src + static_cast<size_t>(id) * D + c);
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

// K3 pass 1: sums[ch] = sum of partial[order[k]] over chunk ch, from zero.
template <int V>
__global__ void segment_chunk_sum_kernel(float* __restrict__ sums,
                                         const float* __restrict__ partial,
                                         const int* __restrict__ order,
                                         const int* __restrict__ chunk_start,
                                         const int* __restrict__ chunk_end,
                                         long long n_chunks, int D) {
  const int nv = D / V;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_chunks * nv) return;
  const long long ch = t / nv;
  const int c = static_cast<int>(t - ch * nv) * V;
  typename Cols<V>::T acc = Cols<V>::zero();
  add_rows<V, true>(acc, partial, order, chunk_start[ch], chunk_end[ch], D,
                    c);
  *reinterpret_cast<typename Cols<V>::T*>(sums + ch * D + c) = acc;
}

// K3 pass 2 (or the only pass): out[seg_rows[s]] += each partial of
// segment s in order, or, for a hub (a segment longer than chunk_len found
// in hubs), its chunk sums in chunk order.
template <int V>
__global__ void segment_add_kernel(float* __restrict__ out,
                                   const float* __restrict__ partial,
                                   const int* __restrict__ order,
                                   const int* __restrict__ seg_rows,
                                   const int* __restrict__ seg_start,
                                   long long n_seg, int D,
                                   const float* __restrict__ sums,
                                   const int* __restrict__ hubs,
                                   const int* __restrict__ hub_chunks,
                                   int n_hubs, int chunk_len) {
  using T = typename Cols<V>::T;
  const int nv = D / V;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_seg * nv) return;
  const int s = static_cast<int>(t / nv);
  const int c = static_cast<int>(t - static_cast<long long>(s) * nv) * V;
  T* dst = reinterpret_cast<T*>(out + static_cast<size_t>(seg_rows[s]) * D +
                                c);
  T acc = *dst;
  const int k0 = seg_start[s], k1 = seg_start[s + 1];
  int hub = -1;
  if (k1 - k0 > chunk_len && n_hubs > 0) {  // find s among the hubs
    int lo = 0, hi = n_hubs;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (hubs[mid] < s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < n_hubs && hubs[lo] == s) hub = lo;
  }
  if (hub >= 0) {
    add_rows<V, false>(acc, sums, nullptr, hub_chunks[hub],
                       hub_chunks[hub + 1], D, c);
  } else {
    add_rows<V, true>(acc, partial, order, k0, k1, D, c);
  }
  *dst = acc;
}

template <int V>
int launch_segment_add(float* out, const float* partial, const int* order,
                       const int* seg_rows, const int* seg_start,
                       long long n_seg, int D, const int* hubs,
                       const int* hub_chunks, long long n_hubs,
                       const int* chunk_start, const int* chunk_end,
                       long long n_chunks, int chunk_len, float* sums,
                       cudaStream_t stream) {
  const int nv = D / V;
  if (n_chunks > 0) {
    const long long work = n_chunks * nv;
    segment_chunk_sum_kernel<V>
        <<<static_cast<unsigned>((work + kThreads - 1) / kThreads), kThreads,
           0, stream>>>(sums, partial, order, chunk_start, chunk_end,
                        n_chunks, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long work = n_seg * nv;
  segment_add_kernel<V>
      <<<static_cast<unsigned>((work + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(out, partial, order, seg_rows, seg_start, n_seg, D, sums,
                   hubs, hub_chunks, static_cast<int>(n_hubs), chunk_len);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kOrder, bool kRows>
int launch_segments(float* out, const float* partial, const int* order,
                    const int* seg_rows, const int* seg_start, long long n_seg,
                    int D, cudaStream_t stream) {
  const long long work = n_seg * D;
  const unsigned grid = static_cast<unsigned>((work + kThreads - 1) / kThreads);
  ordered_segment_sum_kernel<kOrder, kRows><<<grid, kThreads, 0, stream>>>(
      out, partial, order, seg_rows, seg_start, n_seg, D);
  return static_cast<int>(cudaGetLastError());
}

// K1: threads a partition, the next power of two >= ceil(D / V), <= 32.
int group_threads(int D, int V) {
  const int nv = (D + V - 1) / V;
  int g = 1;
  while (g < nv && g < 32) g *= 2;
  return g;
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
  if (P == 0) return static_cast<int>(cudaGetLastError());
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

// chunk_start == nullptr: one pass over the segments.  Otherwise two:
// chunk_sums (n_chunks, D), zeroed by the caller, receives each chunk's sum
// (chunks delimited by chunk_start in src), then row seg_rows[s] receives
// its chunks row_chunks[s] .. row_chunks[s + 1] - 1 in order.
int mgg_scatter_sum_ordered(float* dbuf, const float* g, const int* src,
                            const int* seg_rows, const int* seg_start,
                            long long n_seg, const int* chunk_start,
                            const int* row_chunks, float* chunk_sums,
                            long long n_chunks, int D, void* stream) {
  if (n_seg == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (chunk_start == nullptr) {
    return launch_segments<true, true>(dbuf, g, src, seg_rows, seg_start,
                                       n_seg, D, s);
  }
  const int rc = launch_segments<true, false>(chunk_sums, g, src, nullptr,
                                              chunk_start, n_chunks, D, s);
  if (rc != 0) return rc;
  return launch_segments<false, true>(dbuf, chunk_sums, nullptr, seg_rows,
                                      row_chunks, n_seg, D, s);
}

}  // extern "C"
