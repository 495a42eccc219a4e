// Dense squared-L2 distance matrix: K4 of the port.
//
// Replaces: src/repro/kernels/pairwise_l2.py:_pairwise_kernel
// (pairwise_sq_l2).
//
// Computes out[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) in f32, and
// +inf where key j is invalid; x (n, d), y (m, d), out (n, m).
//
// Per-pair arithmetic (the same in both instances, so the bits do not
// depend on the route): the cross term and both norms are each one fmaf
// chain over the features in ascending order from +0.0, and the epilogue
// is fmaxf((xn + yn) - 2 * cross, 0) with every operation rounded on its
// own (__fadd_rn, __fmul_rn, __fsub_rn; 2 * cross is exact, so a
// contracted fma would give the same bits anyway).
//
// What bounds it on an H100: each output costs 2d + 3 flops and 4 bytes
// written, so below d ~ 38 (67 TFLOP/s of f32 against 3.35 TB/s) the
// stores bound it. Every caller runs d = 2-7: HAC and DBSCAN write an
// (n, n) matrix (50,000^2 f32 is 10 GB, 2.99 ms at the memory rate), and
// k-means++/Lloyd an (n, k <= 8) one, where one launch is latency.
//
// Two instances:
//
//   tiled (m > 16 or d > 32; the (n, n) matrices): a block of 256 threads
//   owns a 64-row x 128-column output tile, 8 rows x 4 adjacent columns a
//   thread. The tile's x and y rows are staged once per 32-feature chunk
//   into shared memory, feature-major, so a thread reads its 8 rows as two
//   broadcast float4 and its 4 columns as one float4 per feature (32 fmaf
//   per 3 shared loads). Each tile row's and column's norm is computed once,
//   by one thread, while the chunk is staged. Rows go out as 16-byte float4
//   stores with the streaming hint (__stcs: the matrix is far larger than
//   the 50 MB L2) where the address is 16-byte aligned, scalar stores on
//   the ragged edge; a warp writes 512 contiguous bytes of one row. The
//   grid is one block per tile, 64-bit offsets throughout (n * m passes
//   2^31 at the DBSCAN shape).
//
//   small_m (m <= 16 and d <= 32; the k-means shapes): a block of 32
//   threads owns 32 whole rows, one row a thread. The m centres sit in
//   shared memory (every thread reads the same word: a broadcast), and
//   each thread folds their norms beside its row's; the block's x rows are
//   staged with coalesced loads, all in flight at once.
//   The rows' m outputs go through shared memory, so the block's 32 * m
//   outputs, one contiguous run of the result, leave as float4. One warp a
//   block gives 75 blocks at 2,390 rows and 489 at 15,625; a launch there
//   is a few microseconds, mostly latency, so the design keeps one staging
//   pass and two barriers.
//
// Tensor cores would pay only above d ~ 38, where no caller runs; both
// instances stay on the CUDA cores. No atomics: a repeat is bitwise.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// tiled instance
constexpr int kTR = 64;         // rows of an output tile
constexpr int kTC = 128;        // columns of an output tile
constexpr int kRT = 8;          // rows a thread
constexpr int kCT = 4;          // adjacent columns a thread
constexpr int kFeat = 32;       // features staged per step
constexpr int kPad = 4;         // keeps float4 alignment, spreads staging stores
constexpr int kThreads = 256;   // (kTC / kCT) x (kTR / kRT)

// small_m instance
constexpr int kSmallM = 16;     // most centres
constexpr int kSmallD = 32;     // most features
constexpr int kSmallRows = 32;  // rows (threads) a block

__device__ __forceinline__ float epilogue(float xn, float yn, float cross, bool ok) {
  return ok ? fmaxf(__fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.f, cross)), 0.f)
            : CUDART_INF_F;
}

__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const unsigned char* __restrict__ y_valid, float* __restrict__ out,
             int n, int m, int d, int col_tiles) {
  __shared__ __align__(16) float xs[kFeat][kTR + kPad];
  __shared__ __align__(16) float ys[kFeat][kTC + kPad];
  __shared__ float xn_s[kTR];
  __shared__ float yn_s[kTC];
  __shared__ bool ok_s[kTC];

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;  // column group, row group
  const int i0 = (blockIdx.x / col_tiles) * kTR;
  const int j0 = (blockIdx.x % col_tiles) * kTC;

  float acc[kRT][kCT];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < kCT; ++c) acc[r][c] = 0.f;
  float nrm = 0.f;  // tid < 64: x row i0 + tid; 64 <= tid < 192: y row j0 + tid - 64

  for (int f0 = 0; f0 < d; f0 += kFeat) {
    const int nf = min(kFeat, d - f0);
    for (int e = tid; e < kTR * nf; e += kThreads) {
      const int r = e / nf, f = e - r * nf;
      xs[f][r] = (i0 + r < n) ? x[(size_t)(i0 + r) * d + f0 + f] : 0.f;
    }
    for (int e = tid; e < kTC * nf; e += kThreads) {
      const int r = e / nf, f = e - r * nf;
      ys[f][r] = (j0 + r < m) ? y[(size_t)(j0 + r) * d + f0 + f] : 0.f;
    }
    __syncthreads();
    if (tid < kTR) {
      for (int f = 0; f < nf; ++f) nrm = fmaf(xs[f][tid], xs[f][tid], nrm);
    } else if (tid < kTR + kTC) {
      const int c = tid - kTR;
      for (int f = 0; f < nf; ++f) nrm = fmaf(ys[f][c], ys[f][c], nrm);
    }
    for (int f = 0; f < nf; ++f) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[f][ty * kRT]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[f][ty * kRT + 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&ys[f][tx * kCT]);
      const float xv[kRT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float yc[kCT] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < kCT; ++c) acc[r][c] = fmaf(xv[r], yc[c], acc[r][c]);
    }
    __syncthreads();
  }

  if (tid < kTR) {
    xn_s[tid] = nrm;
  } else if (tid < kTR + kTC) {
    const int c = tid - kTR;
    yn_s[c] = nrm;
    ok_s[c] = (j0 + c < m) && (y_valid == nullptr || y_valid[j0 + c]);
  }
  __syncthreads();

  const int jl = tx * kCT, j = j0 + jl;
  if (j >= m) return;
  float yn[kCT];
  bool ok[kCT];
#pragma unroll
  for (int c = 0; c < kCT; ++c) {
    yn[c] = yn_s[jl + c];
    ok[c] = ok_s[jl + c];
  }
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int il = ty * kRT + r, i = i0 + il;
    if (i >= n) break;
    const float xn = xn_s[il];
    float v[kCT];
#pragma unroll
    for (int c = 0; c < kCT; ++c) v[c] = epilogue(xn, yn[c], acc[r][c], ok[c]);
    float* dst = out + ((size_t)i * m + j);
    if (j + kCT <= m && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        if (j + c < m) __stcs(dst + c, v[c]);
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(kSmallRows)
small_m_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const unsigned char* __restrict__ y_valid, float* __restrict__ out,
               int n, int m, int d) {
  constexpr int kYLoads = kSmallM * kSmallD / kSmallRows;
  __shared__ float ys[kSmallM * kSmallD];   // the centres as they lie in memory
  __shared__ float xs[kSmallRows * kSmallD];  // the block's rows, likewise
  __shared__ bool ok_s[MT];
  __shared__ __align__(16) float os[kSmallRows * MT];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kSmallRows;
  const int rows = min(kSmallRows, n - i0);
  const int nx = rows * d, ny = m * d;
  const float* xb = x + (size_t)i0 * d;

  // every load of the staging pass is issued before any of them is
  // stored, so their latencies overlap (a launch at these shapes is a few
  // microseconds, mostly latency)
  float xr[kSmallD], yr[kYLoads];
#pragma unroll
  for (int k = 0; k < kSmallD; ++k) {
    const int e = tid + k * kSmallRows;
    xr[k] = e < nx ? xb[e] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kYLoads; ++k) {
    const int e = tid + k * kSmallRows;
    yr[k] = e < ny ? y[e] : 0.f;
  }
  if (tid < MT) ok_s[tid] = tid < m && (y_valid == nullptr || y_valid[tid]);
#pragma unroll
  for (int k = 0; k < kSmallD; ++k) xs[tid + k * kSmallRows] = xr[k];
#pragma unroll
  for (int k = 0; k < kYLoads; ++k) ys[tid + k * kSmallRows] = yr[k];
  __syncthreads();

  if (tid < rows) {
    // every thread folds the centres' norms too (the same chain, so the
    // same bits in each): no extra pass and barrier for them. Centre
    // columns c >= m read zeros or other centres' words; they are never
    // stored.
    float acc[MT], yn[MT];
#pragma unroll
    for (int c = 0; c < MT; ++c) acc[c] = yn[c] = 0.f;
    float xn = 0.f;
    for (int f = 0; f < d; ++f) {
      const float xv = xs[tid * d + f];
      xn = fmaf(xv, xv, xn);
#pragma unroll
      for (int c = 0; c < MT; ++c) {
        const float yv = ys[c * d + f];  // one word for the whole warp
        acc[c] = fmaf(xv, yv, acc[c]);
        yn[c] = fmaf(yv, yv, yn[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MT; ++c)
      if (c < m) os[tid * m + c] = epilogue(xn, yn[c], acc[c], ok_s[c]);
  }
  __syncthreads();

  // the block's rows are one contiguous run of rows * m outputs; its start,
  // i0 * m floats with i0 a multiple of 32, is 16-byte aligned
  float* dst = out + (size_t)i0 * m;
  const int count = rows * m;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  const int n4 = vec ? count / 4 : 0;
  for (int e = tid; e < n4; e += kSmallRows)
    reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(os)[e];
  for (int e = 4 * n4 + tid; e < count; e += kSmallRows) dst[e] = os[e];
}

bool small_m_route(int m, int d) { return m <= kSmallM && d <= kSmallD; }

}  // namespace

extern "C" {

// The default instance of (m, d): 0 small_m, 1 tiled (the Python wrapper's
// route() mirrors this rule). small_m runs only where m <= 16 and d <= 32;
// tiled runs anywhere, with the same bits.
int repro_pairwise_sq_l2_route(int m, int d) { return small_m_route(m, d) ? 0 : 1; }

// x (n, d) f32, y (m, d) f32, y_valid (m,) u8 or null, route 0 small_m /
// 1 tiled / -1 the default -> out (n, m) f32. Returns a cudaError_t
// (cudaErrorInvalidValue for small_m outside its range: never rerouted).
int repro_pairwise_sq_l2_f32(const float* x, const float* y,
                             const unsigned char* y_valid, float* out, int n,
                             int m, int d, int route, void* stream) {
  if (n < 0 || m < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (route < 0) route = repro_pairwise_sq_l2_route(m, d);
  if ((route != 0 && route != 1) || (route == 0 && !small_m_route(m, d)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const unsigned blocks = (unsigned)((n + kSmallRows - 1) / kSmallRows);
    if (m <= 4)
      small_m_kernel<4><<<blocks, kSmallRows, 0, s>>>(x, y, y_valid, out, n, m, d);
    else if (m <= 8)
      small_m_kernel<8><<<blocks, kSmallRows, 0, s>>>(x, y, y_valid, out, n, m, d);
    else
      small_m_kernel<16><<<blocks, kSmallRows, 0, s>>>(x, y, y_valid, out, n, m, d);
    return (int)cudaGetLastError();
  }
  const long long row_tiles = (n + kTR - 1) / kTR;
  const long long col_tiles = (m + kTC - 1) / kTC;
  if (row_tiles * col_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tiled_kernel<<<(unsigned)(row_tiles * col_tiles), kThreads, 0, s>>>(
      x, y, y_valid, out, n, m, d, (int)col_tiles);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
