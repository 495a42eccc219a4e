// Weighted segment sum: K3 of the port.
//
// Replaces: src/repro/kernels/segment_sum.py:_segsum_kernel (segment_sum).
//
// Computes sums[s, f] = sum over rows i with id_i == s of w_i * x[i, f] and
// mass[s] = sum of w_i over the same rows; ids outside [0, S) are dropped.
//
// What bounds it on an H100: the bytes. It reads x, the ids and the weights
// once and writes (S, d) + (S,) floats, a handful of flops per byte. The TPU
// kernel contracts a one-hot (rows x segments) tile on the MXU, which is
// O(n * S * d) work: 581,012 x 193,670 x 6 at level 0 of a covertype-sized
// fit. That is not carried over.
//
// Design: deterministic, with no float atomics. The wrapper sorts the ids
// with a stable sort (the sort is not the kernel's body), which groups each
// segment's rows in ascending row order. One thread owns one segment: it
// finds the segment's run in the sorted ids by binary search and folds
// w * x and w over the run left to right, starting from 0. The product and
// the sum are rounded separately (__fmul_rn, __fadd_rn: never contracted to
// an fma), which is the order and the rounding of the plain version's
// row-order fold, so on a CPU-comparable fold the bits match.
// Later work: a warp per long segment, vectorised loads of x rows.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long lower_bound(const int* a, long long n, int v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void segsum_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const int* __restrict__ sorted_ids,
                              const long long* __restrict__ perm,
                              float* __restrict__ sums, float* __restrict__ mass,
                              long long n, int num_segments, int d) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_segments) return;
  const int s = (int)t;
  const long long lo = lower_bound(sorted_ids, n, s);
  const long long hi = lower_bound(sorted_ids, n, s + 1);
  for (int f = 0; f < d; ++f) {
    float acc = 0.f;
    for (long long r = lo; r < hi; ++r) {
      const long long row = perm[r];
      acc = __fadd_rn(acc, __fmul_rn(x[row * d + f], w[row]));
    }
    sums[(long long)s * d + f] = acc;
  }
  float m = 0.f;
  for (long long r = lo; r < hi; ++r) m = __fadd_rn(m, w[perm[r]]);
  mass[s] = m;
}

}  // namespace

extern "C" {

// x (n, d) f32, w (n,) f32, sorted_ids (n,) i32 (stable sort of the ids),
// perm (n,) i64 (the rows in that order) -> sums (S, d) f32, mass (S,) f32.
// Returns a cudaError_t.
int repro_segment_sum_f32(const float* x, const float* w,
                          const int* sorted_ids, const long long* perm,
                          float* sums, float* mass, long long n,
                          int num_segments, int d, void* stream) {
  if (n < 0 || num_segments < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (num_segments == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (num_segments + threads - 1) / threads;
  segsum_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, sorted_ids, perm, sums, mass, n, num_segments, d);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
