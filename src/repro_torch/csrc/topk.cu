// Streaming k-nearest-keys of each query: K1 and K2 of the port.
//
// Replaces: src/repro/kernels/fused_assign.py:_fused_kernel (fused_topk,
// K1) and src/repro/kernels/knn_topk.py:_knn_kernel (knn_topk, K2; the same
// function with keys = queries and q_gidx = arange(n)).
//
// Computes, per query row q and every valid key y at global index g != q_gidx:
//   dist = max(|q|^2 + |y|^2 - 2 q.y, 0)   (f32; invalid keys never enter)
// and keeps the k smallest under the total order (dist, g): among equal
// distances the lowest key index wins, and unfilled slots stay (inf, -1).
// That is the reference's merge_topk contract, so the result does not
// depend on how the keys are tiled.
//
// What bounds it on an H100: the operations. Every (query, key) pair costs
// about 2*D flops of the cross term plus a compare, in f32 on the CUDA
// cores (no tensor-core path for d = 6); the bytes are only the queries and
// the keys once each, nq*d + p*d floats. At nq = p = 581,012 and d = 6 that
// is ~4e12 flops against ~28 MB.
//
// Design: the Pallas grid carries the best list across the key axis; here
// the key axis is a loop inside the block. A block owns QPB queries; LANES
// threads share a query and split each key tile between them (lane l takes
// keys l, l+LANES, ...), so a block of 256 threads keeps many warps busy
// even when only 8192 queries are in flight. Key tiles are staged in shared
// memory, zero-padded to D features (zeros add exactly 0 to every sum), with
// the key norm computed once per tile and +inf standing in for an invalid
// key. Each thread keeps its lane's K best in registers (K, D compile-time)
// and inserts a candidate by strict-< bubble in ascending key order, which
// reproduces the earliest-index tie rule. At the end the LANES lists of a
// query are merged through warp shuffles under the same (dist, g) order.
// No (nq, p) matrix is written and no atomics are used.
// Later work: tensor-core cross term (wgmma) and TMA-fed key tiles.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;               // threads that share one query
constexpr int kQPB = kThreads / kLanes;  // queries per block
constexpr int kTileFloats = 8192;        // 32 KB of keys per stage

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Place (dv, iv) into the sorted list; the caller checked that it beats
// the last entry.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float dv,
                                       int iv) {
  bd[K - 1] = dv;
  bi[K - 1] = iv;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ q_gidx, float* __restrict__ out_d,
                int* __restrict__ out_i, int nq, int p, int d, int k) {
  constexpr int kTile = kTileFloats / D;
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ float sn[kTile];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int qi = blockIdx.x * kQPB + tid / kLanes;
  const bool active = qi < nq;

  float xq[D];
  float xn = 0.f;
#pragma unroll
  for (int f = 0; f < D; ++f) {
    xq[f] = (active && f < d) ? q[(size_t)qi * d + f] : 0.f;
    xn = fmaf(xq[f], xq[f], xn);
  }
  const int self = (active && q_gidx != nullptr) ? q_gidx[qi] : -1;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }

  for (int base = 0; base < p; base += kTile) {
    const int nt = min(kTile, p - base);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, f = e % D;
      sk[e] = (r < nt && f < d) ? keys[(size_t)(base + r) * d + f] : 0.f;
    }
    __syncthreads();
    for (int r = tid; r < nt; r += kThreads) {
      float yn = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) yn = fmaf(sk[r * D + f], sk[r * D + f], yn);
      // an invalid key's distance comes out +inf and never enters a list
      sn[r] = (valid == nullptr || valid[base + r]) ? yn : CUDART_INF_F;
    }
    __syncthreads();
    if (active) {
      for (int r = lane; r < nt; r += kLanes) {
        const float4* kr = reinterpret_cast<const float4*>(sk + r * D);
        float cross = 0.f;
#pragma unroll
        for (int f4 = 0; f4 < D / 4; ++f4) {
          const float4 y = kr[f4];
          cross = fmaf(xq[4 * f4 + 0], y.x, cross);
          cross = fmaf(xq[4 * f4 + 1], y.y, cross);
          cross = fmaf(xq[4 * f4 + 2], y.z, cross);
          cross = fmaf(xq[4 * f4 + 3], y.w, cross);
        }
        const float dist = fmaxf(xn + sn[r] - 2.f * cross, 0.f);
        const int g = base + r;
        // keys arrive in ascending g within a lane: strict < keeps the
        // earlier index on a tie
        if (dist < bd[K - 1] && g != self) insert<K>(bd, bi, dist, g);
      }
    }
  }

  // merge the kLanes lists of each query (all lanes of a query sit in one
  // warp); every lane ends with the merged list
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = __shfl_xor_sync(0xffffffffu, bd[s], off);
      oi[s] = __shfl_xor_sync(0xffffffffu, bi[s], off);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (before(od[s], oi[s], bd[K - 1], bi[K - 1])) insert<K>(bd, bi, od[s], oi[s]);
    }
  }

  if (active && lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        out_d[(size_t)qi * k + s] = bd[s];
        out_i[(size_t)qi * k + s] = isinf(bd[s]) ? -1 : bi[s];
      }
    }
  }
}

template <int K, int D>
cudaError_t launch(const float* q, const float* keys, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, cudaStream_t stream) {
  const int blocks = (nq + kQPB - 1) / kQPB;
  topk_kernel<K, D><<<blocks, kThreads, 0, stream>>>(q, keys, valid, q_gidx,
                                                     out_d, out_i, nq, p, d, k);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k(const float* q, const float* keys, const unsigned char* valid,
                     const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                     int d, int k, cudaStream_t stream) {
  // the first k of a top-K list (K >= k) are the top-k under the same order
  if (k <= 1) return launch<1, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
  if (k <= 2) return launch<2, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
  if (k <= 4) return launch<4, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
  if (k <= 8) return launch<8, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
  if (k <= 16) return launch<16, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
  return launch<32, D>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, stream);
}

}  // namespace

extern "C" {

int repro_topk_max_k() { return 32; }
int repro_topk_max_d() { return 128; }

// q (nq, d) f32, keys (p, d) f32, valid (p,) u8 or null, q_gidx (nq,) i32 or
// null -> out_d (nq, k) f32, out_i (nq, k) i32. Returns a cudaError_t.
int repro_topk_f32(const float* q, const float* keys, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, void* stream) {
  if (nq < 0 || p < 0 || d < 1 || d > 128 || k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 4) err = launch_k<4>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, s);
  else if (d <= 8) err = launch_k<8>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, s);
  else if (d <= 32) err = launch_k<32>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, s);
  else err = launch_k<128>(q, keys, valid, q_gidx, out_d, out_i, nq, p, d, k, s);
  return (int)err;
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
