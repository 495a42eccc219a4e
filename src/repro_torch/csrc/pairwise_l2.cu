// Dense squared-L2 distance matrix: K4 of the port.
//
// Replaces: src/repro/kernels/pairwise_l2.py:_pairwise_kernel
// (pairwise_sq_l2).
//
// Computes out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) in f32, and
// +inf where key j is invalid.
//
// What bounds it on an H100: at the main path's shapes (k-means++ and Lloyd
// over the final prototypes: n ~ 2,400 rows, m = k <= 8 centres, d = 6) the
// bytes, and those are mostly reading x and writing the (n, m) result; the
// 2*n*m*d flops are nothing. At those sizes one launch is a few
// microseconds of latency whatever the kernel does.
//
// Design: a 32 x 32 output tile per block of 32 x 8 threads. The x rows and
// y rows of the tile are staged through shared memory in chunks of 32
// features (rows padded to 33 floats against bank conflicts); each thread
// owns one column and four rows and accumulates the cross term and both
// norms in the same feature loop, in f32, on the CUDA cores. No cuBLAS.
// Later work: a fused distance + argmin variant for k-means shapes, so that
// (n, k) is never written.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;  // rows and columns of an output tile
constexpr int kRowsPerThread = 4;
constexpr int kFeat = 32;  // features staged per step

__global__ void pairwise_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const unsigned char* __restrict__ y_valid,
                                float* __restrict__ out, int n, int m, int d) {
  __shared__ float xs[kTile][kFeat + 1];
  __shared__ float ys[kTile][kFeat + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // (32, 8)
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int j = j0 + tx;

  float cross[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float xn[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float yn = 0.f;

  for (int f0 = 0; f0 < d; f0 += kFeat) {
    for (int r = ty; r < kTile; r += 8) {
      const int f = f0 + tx;
      xs[r][tx] = (i0 + r < n && f < d) ? x[(size_t)(i0 + r) * d + f] : 0.f;
      ys[r][tx] = (j0 + r < m && f < d) ? y[(size_t)(j0 + r) * d + f] : 0.f;
    }
    __syncthreads();
    const int nf = min(kFeat, d - f0);
    for (int f = 0; f < nf; ++f) {
      const float yv = ys[tx][f];
      yn = fmaf(yv, yv, yn);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float xv = xs[ty + 8 * r][f];
        cross[r] = fmaf(xv, yv, cross[r]);
        xn[r] = fmaf(xv, xv, xn[r]);
      }
    }
    __syncthreads();
  }

  if (j >= m) return;
  const bool ok = (y_valid == nullptr) || y_valid[j];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + ty + 8 * r;
    if (i < n) {
      out[(size_t)i * m + j] =
          ok ? fmaxf(xn[r] + yn - 2.f * cross[r], 0.f) : CUDART_INF_F;
    }
  }
}

}  // namespace

extern "C" {

// x (n, d) f32, y (m, d) f32, y_valid (m,) u8 or null -> out (n, m) f32.
// Returns a cudaError_t.
int repro_pairwise_sq_l2_f32(const float* x, const float* y,
                             const unsigned char* y_valid, float* out, int n,
                             int m, int d, void* stream) {
  if (n < 0 || m < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  const dim3 threads(kTile, 8);
  const dim3 blocks((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  pairwise_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, y_valid, out, n, m, d);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
