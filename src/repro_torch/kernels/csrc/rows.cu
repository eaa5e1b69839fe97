// MGG row-gather kernel for Hopper (sm_90a), bound with ctypes.
//
// K5 gather_rows  replaces repro/kernels/rows.py gather_rows_call
//                 (_gather_rows_kernel): out[i] = src[idx[i]], src (T, D)
//                 fp32, idx (B,) int32, out (B, D) fp32.  An id outside
//                 [0, T) gives a zero row (the Pallas kernel is never handed
//                 one; here it cannot fault the card).
//
// What bounds it: bytes.  It reads B rows at data-dependent addresses and
// writes B rows, (2 * B * D * 4 + B * 4) bytes, with no arithmetic; the
// reads are latency-bound unless many rows are in flight at once.
//
// The TPU kernel is a copy body whose BlockSpec index map makes the DMA
// engine fetch one (1, db) block per grid step, the grid walked in order.
// Here every row is independent, so a group of `tpr` threads (a power of
// two, <= 32) owns one row and every block holds 256 / tpr rows: at
// D = 100 one warp moves one 400-byte row as 25 16-byte loads, and the
// whole batch of rows is in flight across the card at once.  When D is a
// multiple of 4 (and both tables are 16-byte aligned) each thread moves
// float4s; otherwise single words.  No shared memory, no atomics: the
// output is a pure copy, bitwise equal to src[idx].
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// vpr: vectors per row; tpr: threads per row (power of two).
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ src,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, long long B,
                                   long long T, int vpr, int tpr) {
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  if (r >= B) return;
  const int lane = threadIdx.x & (tpr - 1);
  const long long i = idx[r];
  V* dst = out + r * vpr;
  if (i < 0 || i >= T) {
    for (int c = lane; c < vpr; c += tpr) dst[c] = zero_vec<V>();
    return;
  }
  const V* row = src + i * vpr;
  for (int c = lane; c < vpr; c += tpr) dst[c] = row[c];
}

int threads_per_row(int vpr) {
  int t = 1;
  while (t < vpr && t < 32) t *= 2;
  return t;
}

template <typename V>
int launch(const float* src, const int* idx, float* out, long long B,
           long long T, int vpr, cudaStream_t stream) {
  const int tpr = threads_per_row(vpr);
  const long long per_block = kThreads / tpr;
  const unsigned grid = static_cast<unsigned>((B + per_block - 1) / per_block);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const V*>(src), idx, reinterpret_cast<V*>(out), B, T,
      vpr, tpr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mgg_gather_rows(const float* src, const int* idx, float* out, long long B,
                    long long T, int D, void* stream) {
  if (B == 0 || D == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<float4>(src, idx, out, B, T, D / 4, s);
  return launch<float>(src, idx, out, B, T, D, s);
}

}  // extern "C"
