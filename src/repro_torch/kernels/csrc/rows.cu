// MGG row-gather kernel for Hopper (sm_90a), bound with ctypes.
//
// K5 gather_rows  replaces repro/kernels/rows.py gather_rows_call
//                 (_gather_rows_kernel): out[i] = src[idx[i]], src (T, D)
//                 fp32, idx (B,) int32, out (B, D) fp32.  An id outside
//                 [0, T) gives a zero row (the Pallas kernel is never handed
//                 one; here it cannot fault the card).
//
// What bounds it: bytes.  Each distinct row of src is read once, each id
// read once and each output row written once, (distinct * D * 4 + B * 4 +
// B * D * 4) bytes, with no arithmetic.  On an H100 (3.35 TB/s) that is
// 0.03045 ms for the sampled step's two launches (the cold and the hot
// gather, 123,904 rows of D = 100 each) and 0.9215 ms at the padded
// table's shape.  The copy reaches that rate only with enough bytes in flight: by
// Little's law some 15-20 KB on every SM at 600-800 ns of DRAM latency.
//
// The TPU kernel is a copy body whose BlockSpec index map makes the DMA
// engine fetch one (1, db) block per grid step, the grid walked in order.
// Here the output is flattened into its 16-byte vectors (single words
// where D % 4 != 0 or a table is not 16-byte aligned): vector g of out is
// row g / vpr, column g % vpr (vpr = D / 4), so consecutive lanes take
// consecutive vectors whatever D is (no idle lanes at D = 100) and a
// warp's stores cover 512 contiguous bytes.  A persistent grid (the SMs
// times the blocks a SM holds, from the occupancy calculator) walks the
// vectors in chunks of kUnroll * kThreads, grid-stride, the ragged last
// chunk masked.  Each thread loads the ids of its kUnroll = 4 vectors first
// (neighbouring lanes share a row, so these mostly hit L1), then issues
// all 4 row loads (ld.global.nc, through L1), and only then its 4 stores
// (st.global.cs, streaming).  A vector of an out-of-range id stores zeros
// with no load.  The divmod by vpr is taken once a thread; each further
// vector adds a precomputed (quotient, remainder) pair with one carry, in
// 64 bits, so a B * D past 2^31 cannot wrap.  The output is a pure copy,
// bitwise equal to src[idx].  kUnroll and kThreads are fixed here; the
// width and the grid are `kernels/rows.py::plan`.
//
// Measured (tools/k5_variants.py with --parent the rows.cu of commit
// f2601cb, one call, four turns, "NVIDIA H100 80GB HBM3, 700.00 W"; each
// call's median from a full queue): 0.04034 ms at the sampled step's shape
// (75 % of its bound; the previous design, a group of threads a row and 8
// rows a block, 0.04954) and 1.1079 ms at the padded table's (83 %;
// 1.1846).  Both shapes read one row for most of their vectors (the cold
// table's pad row, the hot table's row 0): with rows loaded past L1
// (ld.global.nc.L1::no_allocate) that row came from L2 every time and the
// gather took 0.07205 and 1.6544 ms.  Write-back stores took 0.04651 ms
// (15 % more) at the sampled shape.  U = 2 ties U = 4 (0.04021, 1.1133);
// U = 8 (80 registers) is slower at the sampled shape (0.04203) and ties at
// the padded one (1.1049); 128 or 512 threads a block are within 1 %.  A
// bulk-copy design (TMA 1-D: a cp.async.bulk a row into shared memory, a
// tile's rows out in one bulk store) took 0.4573 and 5.490 ms.  Each of
// these is a patch in tools/k5_variants.py.  Called from Python, K5 is
// paced by the host (some 27 us a launch), not by this kernel.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Vectors in flight a thread, and threads a block (rows.py's UNROLL and
// THREADS); tools/k5_variants.py times other values as patches of these.
constexpr int kUnroll = 4;
constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ V zero_vec();

template <>
__device__ __forceinline__ float zero_vec<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ float4 zero_vec<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// A row of src: read-only (non-coherent) through L1, so that a row many
// vectors repeat is read from L1 and not from L2.
__device__ __forceinline__ float load_row(const float* p) {
  float v;
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 load_row(const float4* p) {
  float4 v;
  asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// (r, c) += (q, m), c kept in [0, vpr): m < vpr, so one carry at most.
__device__ __forceinline__ void advance(long long& r, int& c, long long q,
                                        int m, int vpr) {
  r += q;
  c += m;
  if (c >= vpr) {
    c -= vpr;
    ++r;
  }
}

// vpr: vectors a row.  Thread t of block b takes, in its k-th chunk,
// vectors (b + k * gridDim) * kUnroll * kThreads + u * kThreads + t,
// u < kUnroll.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                       V* __restrict__ out, long long B, long long T,
                       int vpr) {
  // < 2^31: the plan keeps grid * kUnroll * kThreads under it
  const unsigned g0 = blockIdx.x * kUnroll * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kUnroll * kThreads;
  long long r = g0 / vpr;
  int c = static_cast<int>(g0 % vpr);
  const long long lane_q = kThreads / vpr;
  const int lane_m = kThreads % vpr;
  const long long chunk_q = (stride - (kUnroll - 1) * kThreads) / vpr;
  const int chunk_m =
      static_cast<int>((stride - (kUnroll - 1) * kThreads) % vpr);
  while (r < B) {
    long long rows[kUnroll];
    int cols[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rows[u] = r;
      cols[u] = c;
      if (u + 1 < kUnroll) advance(r, c, lane_q, lane_m, vpr);
    }
    long long ids[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ids[u] = rows[u] < B ? __ldg(idx + rows[u]) : -1;
    V vals[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      vals[u] = ids[u] >= 0 && ids[u] < T
                    ? load_row(src + ids[u] * vpr + cols[u])
                    : zero_vec<V>();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (rows[u] < B) __stcs(out + rows[u] * vpr + cols[u], vals[u]);
    advance(r, c, chunk_q, chunk_m, vpr);
  }
}

const void* kernel_of(int width) {
  return width == 4 ? reinterpret_cast<const void*>(&gather_rows_kernel<float4>)
                    : reinterpret_cast<const void*>(&gather_rows_kernel<float>);
}

}  // namespace

extern "C" {

// Blocks of kThreads threads that one SM holds at once for the instance of
// `width`: the persistent grid is this times the SM count.
int mgg_gather_rows_occupancy(int* blocks, int width) {
  if (width != 1 && width != 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(width), kThreads, 0));
}

// width 4: 16-byte vectors (D % 4 == 0, both tables 16-byte aligned), else
// 1; grid from rows.py::plan.
int mgg_gather_rows(const float* src, const int* idx, float* out, long long B,
                    long long T, int D, int width, int grid, void* stream) {
  if (B == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = D % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // the kernel's first vector of a thread and its stride fit 31 bits
  const long long span = static_cast<long long>(grid) * kUnroll * kThreads;
  if ((width != 1 && width != 4) || (width == 4 && !aligned) || grid <= 0 ||
      span >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int vpr = D / width;
  void* args[] = {&src, &idx, &out, &B, &T, &vpr};
  cudaLaunchKernel(kernel_of(width), dim3(grid), dim3(kThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
