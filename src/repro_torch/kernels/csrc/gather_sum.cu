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
// What bounds them: bytes.  Each valid slot reads one D-wide row at a
// data-dependent address (a gather), plus the partition's ids and mask, and
// each partition writes one row: no arithmetic to speak of, so the bound is
// (valid_slots * D * 4 + P * ps * 5 + P * D * 4) bytes over the card's
// memory rate.  At the slice's width (D = 16) a row is 64 bytes, two 32-byte
// sectors, so the gather is latency-bound long before it is rate-bound: the
// designs keep many independent row loads in flight.
//
// K1's design: a group of `tpp` threads (a power of two, <= 32) owns one
// partition, so at D = 16 one warp covers two partitions.  Each thread owns
// up to kVPT columns of a column chunk.  While it adds slot j, the next
// slot's row is already in flight into shared memory through cp.async
// (double buffer) -- the counterpart of the row DMA that Pallas
// double-buffers from the BlockSpec index map.  Each thread reads back only
// the words it copied itself, so no block barrier is needed.
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
constexpr int kVPT = 4;        // K1: columns per thread per column chunk
constexpr int kSegBatch = 32;  // K3/K4: partial words loaded ahead of adds

__device__ __forceinline__ void cp_async_4(float* smem_dst,
                                           const float* gmem_src) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void gather_sum_pipelined_kernel(const float* __restrict__ buf,
                                            const int* __restrict__ nbrs,
                                            const uint8_t* __restrict__ mask,
                                            float* __restrict__ out,
                                            long long P, int ps, int D,
                                            int tpp) {
  // stage[(b * kVPT + v) * blockDim.x + threadIdx.x]: buffer b, column v of
  // this thread -- consecutive threads on consecutive words.
  extern __shared__ float stage[];
  const int lane = threadIdx.x & (tpp - 1);
  const long long p =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpp) +
      threadIdx.x / tpp;
  const bool active = p < P;
  const int* nb = nbrs + (active ? p : 0) * ps;
  const uint8_t* mk = mask + (active ? p : 0) * ps;
  const int chunk = tpp * kVPT;
  const int stride = blockDim.x;
  float* mine = stage + threadIdx.x;

  for (int c0 = 0; c0 < D; c0 += chunk) {
    float acc[kVPT];
#pragma unroll
    for (int v = 0; v < kVPT; ++v) acc[v] = 0.0f;

    // Issue slot j's row (this thread's columns) into buffer j & 1.
    auto issue = [&](int j) {
      if (!active || !mk[j]) return;
      const float* row = buf + static_cast<size_t>(nb[j]) * D;
      float* dst = mine + (j & 1) * kVPT * stride;
#pragma unroll
      for (int v = 0; v < kVPT; ++v) {
        const int col = c0 + lane + v * tpp;
        if (col < D) cp_async_4(dst + v * stride, row + col);
      }
    };

    issue(0);
    cp_async_commit();
    for (int j = 0; j < ps; ++j) {
      if (j + 1 < ps) issue(j + 1);
      cp_async_commit();   // possibly empty: keeps the group count uniform
      cp_async_wait_one(); // slot j has landed
      if (active && mk[j]) {
        const float* src = mine + (j & 1) * kVPT * stride;
#pragma unroll
        for (int v = 0; v < kVPT; ++v) {
          if (c0 + lane + v * tpp < D) acc[v] += src[v * stride];
        }
      }
      // The next issue overwrites this buffer: order the reads above
      // before it.
      __syncwarp();
    }
    cp_async_wait_all();
    if (active) {
#pragma unroll
      for (int v = 0; v < kVPT; ++v) {
        const int col = c0 + lane + v * tpp;
        if (col < D) out[p * D + col] = acc[v];
      }
    }
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

// K3: V columns a thread, as one float4 where V = 4.
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

int threads_per_partition(int D) {
  int t = 1;
  while (t < D && t < 32) t *= 2;
  return t;
}

}  // namespace

extern "C" {

int mgg_gather_sum_pipelined(const float* buf, const int* nbrs,
                             const uint8_t* mask, float* out, long long P,
                             int ps, int D, void* stream) {
  if (P == 0) return static_cast<int>(cudaGetLastError());
  const int tpp = threads_per_partition(D);
  const long long per_block = kThreads / tpp;
  const unsigned grid = static_cast<unsigned>((P + per_block - 1) / per_block);
  const size_t smem = 2 * kVPT * kThreads * sizeof(float);
  gather_sum_pipelined_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      buf, nbrs, mask, out, P, ps, D, tpp);
  return static_cast<int>(cudaGetLastError());
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
