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
//
// Any width: up to d = 128 the query row sits in registers (D a template
// bound). Above that a row of D floats would pass the 255-register limit of
// a thread, so topk_chunked_kernel keeps nothing of width d in registers:
// a tile of 64 keys and the block's 32 query rows are staged through shared
// memory 64 features at a time, and each thread carries the cross terms of
// its 8 keys of the tile (lane l: keys l, l+8, ..., l+56, ascending, so the
// strict-< tie rule holds as above) and the key norms across the chunks.
// Key and query types (the reference's fused_bf16 / fused_int8 shortlist):
// the kernels are templated on the query type QT (f32 or bf16) and the key
// type KT (f32, bf16, or int8 with per-feature scale and zero point); the
// instances built are f32 x f32, bf16 x bf16 and f32 x int8. A
// bf16 element is read at 2 bytes and an int8 one at 1 byte, and each is
// widened to f32 in registers as it is staged into shared memory; no f32
// copy of the key set exists. An int8 key dequantizes as q * scale + zero
// with the multiply and the add rounded separately (__fmul_rn, __fadd_rn):
// nvcc would otherwise contract them into one FMA, which rounds once and
// gives other bits than the plain version's multiply-then-add. The register
// instance stages the (d,) scale and zero once per block into shared
// memory; the chunked instance reads them through the cache as it stages
// each 64-feature chunk. Everything after the widening (distance, merge,
// tie rule) is the f32 kernel's. The f32 instance covers every list length
// K in {1, 2, 4, 8, 16, 32}; the bf16/int8 instances K in {1, 8, 32} (the
// shortlist is k = 8; the first k of a top-K list are the top-k).
//
// Build: REPRO_TOPK_KEYS selects the key type whose C entry point (and so
// whose template instances) a build of this file holds: 0 f32, 1 bf16,
// 2 int8. The three are compiled by three nvcc processes at once, which
// splits the compile time of the instances.
//
// Later work: tensor-core cross term (wgmma) and TMA-fed key tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;               // threads that share one query
constexpr int kQPB = kThreads / kLanes;  // queries per block
constexpr int kTileFloats = 8192;        // 32 KB of keys per stage

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Element i of a key row (feature f) as f32. f32 and bf16 widen exactly;
// int8 dequantizes with a separately rounded multiply and add (no FMA).
template <typename KT>
__device__ __forceinline__ float key_at(const KT* keys, size_t i, int f,
                                        const float*, const float*) {
  return widen(keys[i]);
}
template <>
__device__ __forceinline__ float key_at<int8_t>(const int8_t* keys, size_t i,
                                                int f, const float* scale,
                                                const float* zero) {
  return __fadd_rn(__fmul_rn(static_cast<float>(keys[i]), scale[f]), zero[f]);
}

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

template <typename QT, typename KT, int K, int D>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const QT* __restrict__ q, const KT* __restrict__ keys,
                const float* __restrict__ scale, const float* __restrict__ zero,
                const unsigned char* __restrict__ valid,
                const int* __restrict__ q_gidx, float* __restrict__ out_d,
                int* __restrict__ out_i, int nq, int p, int d, int k) {
  constexpr int kTile = kTileFloats / D;
  __shared__ __align__(16) float sk[kTile * D];
  __shared__ float sn[kTile];
  __shared__ float ss[D], sz[D];  // int8 keys: per-feature scale, zero

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int qi = blockIdx.x * kQPB + tid / kLanes;
  const bool active = qi < nq;

  for (int f = tid; f < D; f += kThreads) {  // read after the tile loop's sync
    ss[f] = (scale != nullptr && f < d) ? scale[f] : 0.f;
    sz[f] = (zero != nullptr && f < d) ? zero[f] : 0.f;
  }

  float xq[D];
  float xn = 0.f;
#pragma unroll
  for (int f = 0; f < D; ++f) {
    xq[f] = (active && f < d) ? widen(q[(size_t)qi * d + f]) : 0.f;
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
      sk[e] = (r < nt && f < d)
                  ? key_at<KT>(keys, (size_t)(base + r) * d + f, f, ss, sz)
                  : 0.f;
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

constexpr int kChunk = 64;                  // features per stage
constexpr int kCTile = 64;                  // keys per tile
constexpr int kPerLane = kCTile / kLanes;   // keys of a tile per thread

template <typename QT, typename KT, int K>
__global__ void __launch_bounds__(kThreads)
    topk_chunked_kernel(const QT* __restrict__ q,
                        const KT* __restrict__ keys,
                        const float* __restrict__ scale,
                        const float* __restrict__ zero,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ q_gidx,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int nq, int p, int d, int k) {
  // rows padded by one float: the 8 lanes of a query read 8 neighbouring
  // key rows of a column, which then fall in 8 different banks
  __shared__ float sq[kQPB][kChunk + 1];
  __shared__ float sk[kCTile][kChunk + 1];
  __shared__ float sn[kCTile];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int ql = tid / kLanes;
  const int qi = blockIdx.x * kQPB + ql;
  const bool active = qi < nq;

  float xn = 0.f;
  if (active) {
    for (int f = 0; f < d; ++f) {
      const float v = widen(q[(size_t)qi * d + f]);
      xn = fmaf(v, v, xn);
    }
  }
  const int self = (active && q_gidx != nullptr) ? q_gidx[qi] : -1;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }

  for (int base = 0; base < p; base += kCTile) {
    const int nt = min(kCTile, p - base);
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
    float yn = 0.f;  // norm of key row tid (threads tid < kCTile)
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      const int cw = min(kChunk, d - c0);
      __syncthreads();  // the previous chunk is no longer read
      for (int e = tid; e < kCTile * kChunk; e += kThreads) {
        const int r = e / kChunk, f = e % kChunk;
        sk[r][f] = (r < nt && f < cw)
                       ? key_at<KT>(keys, (size_t)(base + r) * d + c0 + f,
                                    c0 + f, scale, zero)
                       : 0.f;
      }
      for (int e = tid; e < kQPB * kChunk; e += kThreads) {
        const int r = e / kChunk, f = e % kChunk;
        const int g = blockIdx.x * kQPB + r;
        sq[r][f] = (g < nq && f < cw) ? widen(q[(size_t)g * d + c0 + f]) : 0.f;
      }
      __syncthreads();
      if (tid < kCTile) {
#pragma unroll 8
        for (int f = 0; f < kChunk; ++f) yn = fmaf(sk[tid][f], sk[tid][f], yn);
      }
#pragma unroll 4
      for (int f = 0; f < kChunk; ++f) {
        const float xv = sq[ql][f];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          acc[j] = fmaf(xv, sk[lane + kLanes * j][f], acc[j]);
      }
    }
    if (tid < kCTile)
      sn[tid] = (tid < nt && (valid == nullptr || valid[base + tid])) ? yn
                                                                     : CUDART_INF_F;
    __syncthreads();
    if (active) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int r = lane + kLanes * j;
        if (r < nt) {
          const float dist = fmaxf(xn + sn[r] - 2.f * acc[j], 0.f);
          const int g = base + r;
          if (dist < bd[K - 1] && g != self) insert<K>(bd, bi, dist, g);
        }
      }
    }
  }

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

// D == 0 selects the chunked kernel (any d)
template <typename QT, typename KT, int K, int D>
cudaError_t launch(const QT* q, const KT* keys, const float* scale,
                   const float* zero, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, cudaStream_t stream) {
  const int blocks = (nq + kQPB - 1) / kQPB;
  if constexpr (D == 0)
    topk_chunked_kernel<QT, KT, K><<<blocks, kThreads, 0, stream>>>(
        q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k);
  else
    topk_kernel<QT, KT, K, D><<<blocks, kThreads, 0, stream>>>(
        q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k);
  return cudaGetLastError();
}

#define REPRO_TOPK_ARGS q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k, stream

template <typename QT, typename KT, int D>
cudaError_t launch_k(const QT* q, const KT* keys, const float* scale,
                     const float* zero, const unsigned char* valid,
                     const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                     int d, int k, cudaStream_t stream) {
  // the first k of a top-K list (K >= k) are the top-k under the same order
  if (k <= 1) return launch<QT, KT, 1, D>(REPRO_TOPK_ARGS);
  if constexpr (std::is_same<QT, float>::value && std::is_same<KT, float>::value) {
    if (k <= 2) return launch<QT, KT, 2, D>(REPRO_TOPK_ARGS);
    if (k <= 4) return launch<QT, KT, 4, D>(REPRO_TOPK_ARGS);
    if (k <= 8) return launch<QT, KT, 8, D>(REPRO_TOPK_ARGS);
    if (k <= 16) return launch<QT, KT, 16, D>(REPRO_TOPK_ARGS);
  } else {
    if (k <= 8) return launch<QT, KT, 8, D>(REPRO_TOPK_ARGS);
  }
  return launch<QT, KT, 32, D>(REPRO_TOPK_ARGS);
}

template <typename QT, typename KT>
cudaError_t launch_d(const QT* q, const KT* keys, const float* scale,
                     const float* zero, const unsigned char* valid,
                     const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                     int d, int k, cudaStream_t stream) {
  if (nq < 0 || p < 0 || d < 1 || k < 1 || k > 32) return cudaErrorInvalidValue;
  if (nq == 0) return cudaSuccess;
  if (d <= 4) return launch_k<QT, KT, 4>(REPRO_TOPK_ARGS);
  if (d <= 8) return launch_k<QT, KT, 8>(REPRO_TOPK_ARGS);
  if (d <= 32) return launch_k<QT, KT, 32>(REPRO_TOPK_ARGS);
  if (d <= 128) return launch_k<QT, KT, 128>(REPRO_TOPK_ARGS);
  return launch_k<QT, KT, 0>(REPRO_TOPK_ARGS);
}

#undef REPRO_TOPK_ARGS

}  // namespace

#ifndef REPRO_TOPK_KEYS
#define REPRO_TOPK_KEYS 0
#endif

extern "C" {

int repro_topk_max_k() { return 32; }

#if REPRO_TOPK_KEYS == 0

// q (nq, d) f32, keys (p, d) f32, valid (p,) u8 or null, q_gidx (nq,) i32 or
// null -> out_d (nq, k) f32, out_i (nq, k) i32. Returns a cudaError_t.
int repro_topk_f32(const float* q, const float* keys, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, void* stream) {
  return (int)launch_d<float, float>(q, keys, nullptr, nullptr, valid, q_gidx,
                                     out_d, out_i, nq, p, d, k,
                                     static_cast<cudaStream_t>(stream));
}
#endif

#if REPRO_TOPK_KEYS == 1
// q (nq, d) bf16, keys (p, d) bf16. As above.
int repro_topk_bf16(const __nv_bfloat16* q, const __nv_bfloat16* keys,
                    const unsigned char* valid, const int* q_gidx, float* out_d,
                    int* out_i, int nq, int p, int d, int k, void* stream) {
  return (int)launch_d<__nv_bfloat16, __nv_bfloat16>(
      q, keys, nullptr, nullptr, valid, q_gidx, out_d, out_i, nq, p, d, k,
      static_cast<cudaStream_t>(stream));
}
#endif

#if REPRO_TOPK_KEYS == 2
// int8 keys (p, d) with per-feature scale (d,) and zero (d,) f32: key value
// q8 * scale + zero. q (nq, d) f32. As above.
int repro_topk_int8(const float* q, const int8_t* keys, const float* scale,
                    const float* zero, const unsigned char* valid,
                    const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                    int d, int k, void* stream) {
  if (scale == nullptr || zero == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_d<float, int8_t>(q, keys, scale, zero, valid, q_gidx, out_d,
                                      out_i, nq, p, d, k,
                                      static_cast<cudaStream_t>(stream));
}
#endif

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
