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
// Any width (lists longer than 8, every key type): up to d = 128 the query
// row sits in registers (D a template bound). Above that a row of D floats
// would pass the 255-register limit of a thread, so topk_chunked_kernel
// keeps nothing of width d in registers: a tile of 64 keys and the block's
// 32 query rows are staged through shared memory 64 features at a time,
// and each thread carries the cross terms of its 8 keys of the tile (lane
// l: keys l, l+8, ..., l+56, ascending, so the strict-< tie rule holds as
// above) and the key norms across the chunks.
// Key types (the reference's fused_bf16 / fused_int8 shortlist): every
// kernel is templated on the key type KT (f32, bf16, or int8 with
// per-feature scale and zero point); queries are f32 (the wrapper widens
// bf16 queries, which is exact). A bf16 key element is read at 2 bytes and
// an int8 one at 1 byte, and each is widened to f32 in registers (key_at)
// as it is staged; no f32 copy of the key set exists. An int8 key
// dequantizes as q * scale + zero with the multiply and the add rounded
// separately (__fmul_rn, __fadd_rn): nvcc would otherwise contract them
// into one FMA, which rounds once and gives other bits than the plain
// version's multiply-then-add. Everything after the widening (distance,
// merge, tie rule) is the f32 kernel's, so each key type takes the same
// routes: the tensor-core route (d <= 32, k <= 8), the CUDA-core split
// route (d > 32, k <= 8) and, for k > 8, the kernels above (K in {16, 32};
// the first k of a top-K list are the top-k).
//
// The tensor-core route (topk_tc_kernel; d <= 32, k <= 8: the fit's and the
// stream's TC, k = t - 1, the serve assign, k = 1, K2 at the fit's last
// levels, and the bf16/int8 shortlist of the quantized assign, k = 8). At d <= 32 the pair loop above reads a
// whole key row from shared memory for one query and so is held near the
// shared-memory bandwidth (about 0.9e12 pairs/s on the card), far below
// the f32 FMA rate. Here the tensor cores form the whole distance of a
// 16-query x 8-key tile: with A = [q, 1, xn] and B = [-2 y, yn, 1] (xn, yn
// the CUDA-core kernel's fmaf chains; features zero-padded to a multiple
// of 8, which is exact) A.B = xn + yn - 2 q.y, one mma.sync.m16n8k8 TF32
// product per 8 features in the 3xTF32 split: a = big + small with big =
// cvt.rna.tf32(a), small = cvt.rna.tf32(a - big), and A.B ~ small.big' +
// big.small' + big.big' accumulated in f32, about 2^-21 relative to the
// terms (the tensor core's accumulation is not IEEE-rounded, so the
// distance of a near pair may be off by a few 1e-4 at |x|^2 ~ 200). So
// that distance only chooses candidates: the pair loop keeps a few more
// than k per query (tc_list_len: 4 for k <= 2), and topk_merge_kernel
// rescores them in the CUDA-core kernel's arithmetic, dist = fmaxf(xn +
// yn - 2 cross, 0) with the cross term an fmaf chain too, and keeps the k
// best: the distances returned are the CUDA-core kernel's bits, and a true
// top-k key is lost only if a rounding of ~1e-4 moved more candidates than
// the margin past it (on dyadic grids every split and sum is exact, so the
// answer is bitwise the plain version's, ties included). A warp owns 16
// queries: their big and small A fragments stay in registers for the whole
// key loop. Key tiles (256 rows up to d = 14, 128 above) are split once as
// they are staged into shared memory as (big, small) pairs, rows padded by
// 4 pairs so that the B-fragment loads of a warp fall in distinct banks;
// the next tile's global loads are issued before the current tile is
// computed (a register double buffer; cp.async would copy the raw floats
// and leave the split and the yn column to every warp). The keys come as
// (p, d) rows of d floats: at d = 6 the 24-byte row stride is not a
// multiple of 16 bytes, so a 2-D TMA tensor map cannot describe them. An
// invalid key (or one past the range) gets yn = 3e38, and a list starts
// full of kTcEmpty = 1e38 distances, so it never enters (a valid pair whose
// squared distance reaches 1e38 would overflow the f32 formula anyway).
// bf16 and int8 keys are widened or dequantized by key_at as they are
// loaded for the staging, and the merge's rescore reads them through the
// same key_at, so the distances returned are those of the CUDA-core
// kernel on the same keys (for bf16 the small part of -2 y is 0: a bf16
// value is exact in TF32).
// Each thread owns 2 query rows x 2 key columns of the accumulator per
// tile and keeps a candidate list per row; the mma chains of 4 tiles are
// issued together, then each pair is compared with a bound on its row's
// K-th best from the row's 4 lists (quad_bound: the least last entry, or
// the largest of the lanes' ceil(K / 4)-th entries when lower; a pair above
// it cannot be among the row's K best), and only a pair at or below it is
// offered to the own list. The lists set the pace at this width: the
// inserts of 32 lanes come at random slots, and a warp runs an insert as
// long as any lane has one, so each lane queues its offers of the 4 tiles
// as bits and the warp takes one offer a row per pass, every lane in the
// same pass (lists of 12, k > 4; the short lists offer slot by slot: with
// few slots a pass costs more than the divergence it saves). Keys arrive in
// ascending g, so the strict-< insert keeps the tie rule (insert_ascending:
// no serial chain of swaps), and the 4 lanes of a row merge by shuffles
// under (dist, g).
// wgmma would be the full-rate route, but at d <= 32 the per-pair work on
// the CUDA cores (the compares and the list) sets the pace, not the tensor
// cores, so mma.sync serves. The key axis is split across blocks so that a
// launch of 8192 queries fills the card several times over: each (128-query
// tile, key range) block writes its partial lists to scratch and
// topk_merge_kernel merges the lists of each query. (dist, g) is a total
// order, so the merged list does not depend on the split: no atomics, the
// same answer for every split.
//
// The CUDA-core split route (topk_split_kernel; d > 32, k <= 8: K2 at the
// LM's compression, 2208 keys of d = 256, k = 1, and K1 of any key type at
// that width).
// What bounds it: the f32 FMAs of the cross term, nq * p * d (1.25e9 at
// the compression, 37 us at 67 TFLOP/s); no tensor-core route, because the
// distances must be the fma chain's bits. topk_chunked_kernel ran it at
// 30x that: 69 blocks of 32 queries on 132 SMs, 8 FMAs for 9 shared-memory
// loads, the query rows restaged for every key tile, no overlap of staging
// and arithmetic. Here a block owns 64 queries and a range of keys (the key
// axis split across blocks as on the tensor-core route: sp_splits aims at
// one wave of two blocks an SM, 35 x 7 = 245 blocks at 2208 rows), walked
// 256 keys at a time. Features come 32 at a time, the query and key rows
// of the next chunk copied by cp.async into the second of two buffers while
// this chunk is computed, so the query tile is staged once per chunk for 4
// key tiles. Each of 256 threads owns 4 queries x 4 keys of every 64-key
// tile: per 4 features it reads 4 float4 query rows once and 4 float4 key
// rows a tile (rows padded to 36 floats, so a phase of 8 threads hits 8
// bank quads), 20 loads for 256 FMAs. Shared memory hands an SM 32 floats
// a clock against its 128 FMA lanes, so these loads, not the FMAs, set the
// pace; an 8 x 8 micro-tile (16 loads) would need more than the 128
// registers that two blocks an SM leave (its operands and 64 sums). The
// per-pair arithmetic is topk_chunked_kernel's exactly: xn, yn and the cross
// term are fmaf chains in ascending feature order across the chunks
// (zero-padded features add exactly 0), dist = fmaxf(xn + yn - 2 cross, 0)
// written the same way, an invalid key yn = +inf, so the distances are that
// kernel's bits. The 64 x 256 distances go to shared memory (over the key
// buffers), 4 threads scan a query's row in ascending key order with the
// strict-< insert (lane l: keys l, l + 4, ...), the 4 lists merge by
// shuffles under (dist, g), and each block writes its partial lists;
// topk_split_merge_kernel merges the splits' lists under the same total
// order, so the answer does not depend on the split. No atomics.
// bf16 and int8 keys: cp.async copies raw bytes, so the key chunks are
// copied as they are (2 or 1 bytes an element, double-buffered) into a
// staging buffer, and one pass of the block widens or dequantizes the
// chunk (key_at) into the single f32 key tile just before it is computed:
// 32 conversions a thread against 2,048 FMAs, and the pair loop, the norms
// and the distance tile stay the f32 kernel's (converting at every read
// would repeat each dequantization for the 16 threads that read a key row).
//
// Build: REPRO_TOPK_KEYS selects the key type whose C entry point (and so
// whose template instances) a build of this file holds: 0 f32, 1 bf16,
// 2 int8. The three are compiled by three nvcc processes at once, which
// splits the compile time of the instances.
//
// Later work: wgmma (the tensor-core route issues mma.sync a warp at a
// time) and TMA-fed key tiles; at d = 6 the 24-byte key rows (6 bytes for
// int8) are not a layout a 2-D tensor map takes.

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

template <typename KT, int K, int D>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ q, const KT* __restrict__ keys,
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

template <typename KT, int K>
__global__ void __launch_bounds__(kThreads)
    topk_chunked_kernel(const float* __restrict__ q,
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
      const float v = q[(size_t)qi * d + f];
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
        sq[r][f] = (g < nq && f < cw) ? q[(size_t)g * d + c0 + f] : 0.f;
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

// the tensor-core route's range
constexpr int kTcMaxD = 32;
constexpr int kTcMaxK = 8;

constexpr int kTcGroup = 4;                 // n8 tiles whose mma chains run together
constexpr int kTcWarps = 8;                 // 16 queries a warp
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcQ = 16 * kTcWarps;         // queries per block
// (query tile, key range) blocks a launch aims at: about 2.7 waves of 3
// blocks on each of the 132 SMs (more, shorter blocks ran slower)
constexpr int kTcBlocksWanted = 132 * 8;
constexpr int kTcMinKeys = 1024;            // keys a split holds at least
constexpr float kTcEmpty = 1e38f;           // an unfilled candidate slot
constexpr float kTcFar = 3e38f;             // yn of an invalid key

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// c += A (16x8, row) * B (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the candidate list the pair loop keeps for an output of k: k plus a
// margin, so that a tensor-core rounding near a tie cannot push a true
// top-k key out before the exact rescore
int tc_list_len(int k) { return k <= 2 ? 4 : k <= 4 ? 8 : 12; }

// [features, 1, xn] padded to a multiple of 8
int tc_width(int d) { return d + 2 <= 8 ? 8 : d + 2 <= 16 ? 16 : d + 2 <= 32 ? 32 : 40; }

// key axis splits of a launch: enough (query tile, key range) blocks for
// a few waves, each range at least kTcMinKeys keys
int tc_splits(int nq, int p) {
  const int qtiles = (nq + kTcQ - 1) / kTcQ;
  int want = (kTcBlocksWanted + qtiles - 1) / qtiles;
  const int most = (p + kTcMinKeys - 1) / kTcMinKeys;
  if (want > most) want = most;
  return want < 1 ? 1 : want;
}

int tc_keys_per_split(int p, int splits) {
  const int per = (p + splits - 1) / splits;
  return (per + 255) / 256 * 256;  // whole staged tiles
}

// Place (dv, iv) into the sorted list of a lane whose keys arrive in
// ascending index: the list holds only smaller indices, so (dv, iv) goes
// after every entry with a distance <= dv, as insert's bubble would place
// it. The K compares are independent, so the shift carries no serial chain
// of compare-and-swaps (which held the pair loop's lists of 8 and 12).
template <int K>
__device__ __forceinline__ void insert_ascending(float (&bd)[K], int (&bi)[K], float dv,
                                                 int iv) {
  bool gt[K];
#pragma unroll
  for (int s = 0; s < K; ++s) gt[s] = bd[s] > dv;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    bd[s] = gt[s - 1] ? bd[s - 1] : gt[s] ? dv : bd[s];
    bi[s] = gt[s - 1] ? bi[s - 1] : gt[s] ? iv : bi[s];
  }
  bd[0] = gt[0] ? dv : bd[0];
  bi[0] = gt[0] ? iv : bi[0];
}

template <int K>
__device__ __forceinline__ void tc_offer(float (&bd)[K], int (&bi)[K], float dist,
                                         int g, int self) {
  if (dist < bd[K - 1] && g != self) insert_ascending<K>(bd, bi, dist, g);
}

// A bound on a row's K-th best distance from the 4 lists of its quad
// (lanes 4 grp .. 4 grp + 3, each K entries sorted): the least last entry
// (one lane holds K pairs at or below it), and the largest of the lanes'
// ceil(K / 4)-th entries (the 4 lanes hold 4 ceil(K / 4) >= K pairs at or
// below it). A pair above the bound cannot be among the row's K best
// under (dist, g): the pairs the lists hold come from earlier key tiles,
// so they have lower indices too.
template <int K>
__device__ __forceinline__ float quad_bound(const float (&bd)[K]) {
  constexpr int kQ = (K + 3) / 4 - 1;
  float last = bd[K - 1], quarter = bd[kQ];
  last = fminf(last, __shfl_xor_sync(0xffffffffu, last, 1));
  quarter = fmaxf(quarter, __shfl_xor_sync(0xffffffffu, quarter, 1));
  last = fminf(last, __shfl_xor_sync(0xffffffffu, last, 2));
  quarter = fmaxf(quarter, __shfl_xor_sync(0xffffffffu, quarter, 2));
  return fminf(last, quarter);
}

// merge the lists of the 4 lanes of a quad (lanes 4g .. 4g + 3)
template <int K>
__device__ __forceinline__ void quad_merge(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
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
}

// The pair loop: K candidates per query and key range by the 3xTF32
// distance. DP: [features, 1, xn] padded to a multiple of 8 (KS = DP / 8
// mma k-steps). 3 blocks an SM (registers <= 80) for the short lists at
// narrow d (the fit, the stream, the serve assign); 2 for the rest, which
// need more registers.
template <typename KT, int K, int DP>
__global__ void __launch_bounds__(kTcThreads, (K <= 4 && DP <= 16) ? 3 : 2)
    topk_tc_kernel(const float* __restrict__ q, const KT* __restrict__ keys,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ q_gidx, float* __restrict__ part_d,
                   int* __restrict__ part_i, int nq, int p, int d,
                   int keys_per_split, int splits) {
  constexpr int KS = DP / 8;
  constexpr int kKeys = DP <= 16 ? 256 : 128;  // keys per staged tile
  constexpr int kTpr = kTcThreads / kKeys;     // threads that stage one key row
  constexpr int kPart = DP / kTpr;             // columns a staging thread holds
  constexpr int kStride = DP + 4;              // (big, small) pairs a key row
  static_assert(kPart * kTpr == DP && kKeys % 64 == 0, "tile shape");
  __shared__ float2 sb[kKeys][kStride];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int split = blockIdx.y;
  const int kbeg = split * keys_per_split;
  const int kend = min(p, kbeg + keys_per_split);

  // the warp's 16 queries: rows r0 (grp) and r1 (grp + 8) of its tile
  const int r0 = blockIdx.x * kTcQ + warp * 16 + grp;
  const int r1 = r0 + 8;
  float xn0 = 0.f, xn1 = 0.f;  // the CUDA-core kernel's fmaf chains
  for (int f = 0; f < d; ++f) {
    const float v0 = r0 < nq ? q[(size_t)r0 * d + f] : 0.f;
    const float v1 = r1 < nq ? q[(size_t)r1 * d + f] : 0.f;
    xn0 = fmaf(v0, v0, xn0);
    xn1 = fmaf(v1, v1, xn1);
  }
  // A fragments a0..a3 = (r0, tig), (r1, tig), (r0, tig + 4), (r1, tig + 4)
  // of A = [q, 1, xn]
  uint32_t ab[KS][4], as[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = (h & 1) ? r1 : r0;
      const int f = ks * 8 + tig + ((h & 2) ? 4 : 0);
      float v = 0.f;
      if (row < nq) {
        v = f < d ? q[(size_t)row * d + f] : f == d ? 1.f : f == d + 1 ? ((h & 1) ? xn1 : xn0) : 0.f;
      }
      ab[ks][h] = tf32_rna(v);
      as[ks][h] = tf32_rna(__fsub_rn(v, __uint_as_float(ab[ks][h])));
    }
  }
  const int self0 = (r0 < nq && q_gidx != nullptr) ? q_gidx[r0] : -1;
  const int self1 = (r1 < nq && q_gidx != nullptr) ? q_gidx[r1] : -1;

  float bd0[K], bd1[K];
  int bi0[K], bi1[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd0[s] = bd1[s] = kTcEmpty;
    bi0[s] = bi1[s] = -1;
  }

  // staging: thread tid holds columns [sf, sf + kPart) of key row
  // tid / kTpr of the tile, widened or dequantized as they are loaded
  const int srow = tid / kTpr, spart = tid % kTpr, sf = spart * kPart;
  float pre[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    const int g = kbeg + srow, f = sf + i;
    pre[i] = (g < kend && f < d) ? key_at<KT>(keys, (size_t)g * d + f, f, scale, zero) : 0.f;
  }
  for (int base = kbeg; base < kend; base += kKeys) {
    // yn of the staged row: one fmaf chain over its features in order,
    // passed along the row's kTpr threads
    float yn = 0.f;
#pragma unroll
    for (int j = 0; j < kTpr; ++j) {
      if (spart == j) {
#pragma unroll
        for (int i = 0; i < kPart; ++i) yn = fmaf(pre[i], pre[i], yn);
      }
      if (kTpr > 1) yn = __shfl_sync(0xffffffffu, yn, (lane & ~(kTpr - 1)) | j);
    }
    const int gs = base + srow;
    if (!(gs < kend && (valid == nullptr || valid[gs]))) yn = kTcFar;
    // B = [-2 y, yn, 1] (the factor -2 is exact), split
    float2 st[kPart];
#pragma unroll
    for (int i = 0; i < kPart; ++i) {
      const int f = sf + i;
      const float v = f < d ? -2.f * pre[i] : f == d ? yn : f == d + 1 ? 1.f : 0.f;
      const uint32_t big = tf32_rna(v);
      st[i] = make_float2(__uint_as_float(big),
                          __uint_as_float(tf32_rna(__fsub_rn(v, __uint_as_float(big)))));
    }
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < kPart; ++i) sb[srow][sf + i] = st[i];
    __syncthreads();
    // the next tile's loads are in flight while this one is computed
#pragma unroll
    for (int i = 0; i < kPart; ++i) {
      const int g = base + kKeys + srow, f = sf + i;
      pre[i] = (g < kend && f < d) ? key_at<KT>(keys, (size_t)g * d + f, f, scale, zero) : 0.f;
    }

#pragma unroll 1
    for (int j0 = 0; j0 < kKeys / 8; j0 += kTcGroup) {
      // a row's threshold (quad_bound): only pairs at or below it are
      // offered to the own list
      const float t0 = quad_bound<K>(bd0), t1 = quad_bound<K>(bd1);
      // kTcGroup independent mma chains, then their compares
      float c[kTcGroup][4];
#pragma unroll
      for (int jj = 0; jj < kTcGroup; ++jj) {
        const int kr = (j0 + jj) * 8 + grp;  // this thread's B column: key row kr
        c[jj][0] = c[jj][1] = c[jj][2] = c[jj][3] = 0.f;
        uint32_t bb[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float2 e0 = sb[kr][ks * 8 + tig];
          const float2 e1 = sb[kr][ks * 8 + tig + 4];
          bb[ks][0] = __float_as_uint(e0.x);
          bb[ks][1] = __float_as_uint(e1.x);
          mma_tf32(c[jj], as[ks], bb[ks][0], bb[ks][1]);                          // small . big'
          mma_tf32(c[jj], ab[ks], __float_as_uint(e0.y), __float_as_uint(e1.y));  // big . small'
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) mma_tf32(c[jj], ab[ks], bb[ks][0], bb[ks][1]);  // big . big'
      }
      // c[jj][0], [1]: row r0, columns 2 tig, 2 tig + 1 of tile j0 + jj;
      // [2], [3]: row r1
      if constexpr (K <= 8) {
        // short lists: each slot's pairs offered in turn
#pragma unroll
        for (int jj = 0; jj < kTcGroup; ++jj) {
          const int g0 = base + (j0 + jj) * 8 + 2 * tig, g1 = g0 + 1;
          if (fminf(c[jj][0], c[jj][1]) <= t0) {
            tc_offer<K>(bd0, bi0, c[jj][0], g0, self0);
            tc_offer<K>(bd0, bi0, c[jj][1], g1, self0);
          }
          if (fminf(c[jj][2], c[jj][3]) <= t1) {
            tc_offer<K>(bd1, bi1, c[jj][2], g0, self1);
            tc_offer<K>(bd1, bi1, c[jj][3], g1, self1);
          }
        }
      } else {
        // long lists: the pairs each row offers (at or below its bound, not
        // the query itself) as bits 2 jj + column, so ascending bits are
        // ascending key indices; then one offer a row per pass, every lane in
        // the same pass (offered one slot at a time, the insert ran whenever
        // any of the warp's 32 lanes had a pair in that slot)
        unsigned pend0 = 0, pend1 = 0;
#pragma unroll
        for (int jj = 0; jj < kTcGroup; ++jj) {
          const int g0 = base + (j0 + jj) * 8 + 2 * tig;
#pragma unroll
          for (int col = 0; col < 2; ++col) {
            if (c[jj][col] <= t0 && g0 + col != self0) pend0 |= 1u << (2 * jj + col);
            if (c[jj][2 + col] <= t1 && g0 + col != self1) pend1 |= 1u << (2 * jj + col);
          }
        }
        while (__any_sync(0xffffffffu, (pend0 | pend1) != 0)) {
          if (pend0 != 0) {
            const int b = __ffs(pend0) - 1;
            pend0 &= pend0 - 1;
            float dv = c[0][0];
#pragma unroll
            for (int t = 1; t < 2 * kTcGroup; ++t) dv = b == t ? c[t >> 1][t & 1] : dv;
            if (dv < bd0[K - 1])
              insert_ascending<K>(bd0, bi0, dv, base + (j0 + (b >> 1)) * 8 + 2 * tig + (b & 1));
          }
          if (pend1 != 0) {
            const int b = __ffs(pend1) - 1;
            pend1 &= pend1 - 1;
            float dv = c[0][2];
#pragma unroll
            for (int t = 1; t < 2 * kTcGroup; ++t) dv = b == t ? c[t >> 1][2 + (t & 1)] : dv;
            if (dv < bd1[K - 1])
              insert_ascending<K>(bd1, bi1, dv, base + (j0 + (b >> 1)) * 8 + 2 * tig + (b & 1));
          }
        }
      }
    }
  }

  quad_merge<K>(bd0, bi0);
  quad_merge<K>(bd1, bi1);
  if (tig == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (r0 < nq) {
        part_d[((size_t)r0 * splits + split) * K + s] = bd0[s];
        part_i[((size_t)r0 * splits + split) * K + s] = bi0[s];
      }
      if (r1 < nq) {
        part_d[((size_t)r1 * splits + split) * K + s] = bd1[s];
        part_i[((size_t)r1 * splits + split) * K + s] = bi1[s];
      }
    }
  }
}

// the K best of query qi's partial lists (splits of K each), under (dist, g)
template <int K>
__device__ __forceinline__ void merge_parts(const float* __restrict__ part_d,
                                            const int* __restrict__ part_i,
                                            int splits, int qi, float (&bd)[K],
                                            int (&bi)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = ((size_t)qi * splits + sp) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int iv = part_i[o + s];
      const float dv = part_d[o + s];
      if (iv >= 0 && before(dv, iv, bd[K - 1], bi[K - 1])) insert<K>(bd, bi, dv, iv);
    }
  }
}

// Per query: merge the splits' candidate lists (3xTF32 distances) into its
// K best, rescore those in the CUDA-core kernel's arithmetic (xn, yn and
// the cross term as fmaf chains over the features in order, then
// fmaxf(xn + yn - 2 cross, 0), the keys read through key_at) and keep the
// k best under (dist, g). So the distances returned are the CUDA-core
// kernel's bits.
template <typename KT, int K, int DP>
__global__ void topk_merge_kernel(const float* __restrict__ q,
                                  const KT* __restrict__ keys,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ zero,
                                  const float* __restrict__ part_d,
                                  const int* __restrict__ part_i, int splits,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i, int nq, int d, int k) {
  constexpr int kF = DP - 2 < 32 ? DP - 2 : 32;  // features at most (d <= kF)
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float bd[K];
  int bi[K];
  merge_parts<K>(part_d, part_i, splits, qi, bd, bi);
  float xq[kF];
  float xn = 0.f;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    xq[f] = f < d ? q[(size_t)qi * d + f] : 0.f;
    xn = fmaf(xq[f], xq[f], xn);
  }
  float ed[K];
  int ei[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ed[s] = CUDART_INF_F;
    ei[s] = -1;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int g = bi[s];
    if (g < 0) continue;  // an unfilled slot
    float yn = 0.f, cross = 0.f;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float y = f < d ? key_at<KT>(keys, (size_t)g * d + f, f, scale, zero) : 0.f;
      yn = fmaf(y, y, yn);
      cross = fmaf(xq[f], y, cross);
    }
    const float dist = fmaxf(xn + yn - 2.f * cross, 0.f);
    if (before(dist, g, ed[K - 1], ei[K - 1])) insert<K>(ed, ei, dist, g);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[(size_t)qi * k + s] = ed[s];
      out_i[(size_t)qi * k + s] = isinf(ed[s]) ? -1 : ei[s];
    }
  }
}

bool tc_route(int d, int k) { return d >= 1 && d <= kTcMaxD && k >= 1 && k <= kTcMaxK; }

long long tc_scratch_bytes(int nq, int p, int d, int k) {
  if (!tc_route(d, k) || nq < 1) return 0;
  return (long long)nq * tc_splits(nq, p) * tc_list_len(k) * 8;
}

#define REPRO_ROUTE_ARGS \
  q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k, scratch, stream
#define REPRO_ROUTE_PARAMS                                                         \
  const float *q, const KT *keys, const float *scale, const float *zero,           \
      const unsigned char *valid, const int *q_gidx, float *out_d, int *out_i,     \
      int nq, int p, int d, int k, void *scratch, cudaStream_t stream

template <typename KT, int K, int DP>
cudaError_t launch_tc(REPRO_ROUTE_PARAMS) {
  const int splits = tc_splits(nq, p);
  const int per = tc_keys_per_split(p, splits);
  float* part_d = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_d + (size_t)nq * splits * K);
  const dim3 grid((nq + kTcQ - 1) / kTcQ, splits);
  topk_tc_kernel<KT, K, DP><<<grid, kTcThreads, 0, stream>>>(
      q, keys, scale, zero, valid, q_gidx, part_d, part_i, nq, p, d, per, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a thread per query; blocks of 64 spread a serve-sized launch (5,000
  // queries) over most SMs
  topk_merge_kernel<KT, K, DP><<<(nq + 63) / 64, 64, 0, stream>>>(
      q, keys, scale, zero, part_d, part_i, splits, out_d, out_i, nq, d, k);
  return cudaGetLastError();
}

template <typename KT, int DP>
cudaError_t launch_tc_k(REPRO_ROUTE_PARAMS) {
  switch (tc_list_len(k)) {
    case 4: return launch_tc<KT, 4, DP>(REPRO_ROUTE_ARGS);
    case 8: return launch_tc<KT, 8, DP>(REPRO_ROUTE_ARGS);
    default: return launch_tc<KT, 12, DP>(REPRO_ROUTE_ARGS);
  }
}

// ------------------------------------------- the CUDA-core split route

constexpr int kSpQ = 64;                     // queries a block
constexpr int kSpKT = 4;                     // 64-key tiles a pass
constexpr int kSpKeys = 64 * kSpKT;          // keys a pass
constexpr int kSpF = 32;                     // features a staged chunk
constexpr int kSpStride = kSpF + 4;          // floats a staged row
constexpr int kSpDStride = kSpKeys + 4;      // floats a row of the distance tile
constexpr int kSpLanes = 4;                  // threads that scan a query's row
constexpr int kSpBlocksWanted = 132 * 2;     // one wave of two blocks an SM

// Shared memory of a split block, in floats: the query chunks [2][kSpQ]
// [kSpStride], then a region that holds the f32 key tiles (f32 keys: two,
// double-buffered; bf16 and int8 keys: one, then the raw chunks [2]
// [kSpKeys][kSpF] of KT) and, between passes, the distance tile [kSpQ]
// [kSpDStride]; then the key and query norms.
template <typename KT>
struct SpSmem {
  static constexpr bool kRaw = !std::is_same<KT, float>::value;
  static constexpr size_t kQ = 2 * kSpQ * kSpStride;
  static constexpr size_t kKeyTiles = (kRaw ? 1 : 2) * (size_t)kSpKeys * kSpStride;
  static constexpr size_t kRawFloats = kRaw ? 2 * kSpKeys * kSpF * sizeof(KT) / 4 : 0;
  static constexpr size_t kDist = (size_t)kSpQ * kSpDStride;
  static constexpr size_t kRegion =
      kKeyTiles + kRawFloats > kDist ? kKeyTiles + kRawFloats : kDist;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kRegion + kSpKeys + kSpQ);
};

bool sp_route(int d, int k) { return d > kTcMaxD && k >= 1 && k <= kTcMaxK; }

// key axis splits: enough (64-query tile, key range) blocks for one wave,
// each range whole 64-key tiles, none empty
int sp_splits(int nq, int p) {
  const int qtiles = (nq + kSpQ - 1) / kSpQ;
  const int tiles = (p + 63) / 64;
  if (tiles < 1 || qtiles < 1) return 1;
  int want = (kSpBlocksWanted + qtiles - 1) / qtiles;
  if (want > tiles) want = tiles;
  const int per = (tiles + want - 1) / want;
  return (tiles + per - 1) / per;
}

int sp_keys_per_split(int p, int splits) {
  const int tiles = (p + 63) / 64;
  return (tiles + splits - 1) / splits * 64;
}

int sp_list_len(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy features [c0, c0 + kSpF) of rows [g0, g0 + rows) of src (n rows of
// d floats) into dst ([rows][kSpStride]); features past d and rows past
// g_end are zero-filled (a copy of 0 source bytes). ``vec``: d % 4 == 0
// and src 16-byte aligned, so 16-byte copies; else 4-byte ones.
__device__ __forceinline__ void sp_stage(float* dst, const float* src, int rows, int g0,
                                         int g_end, int c0, int d, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kSpF / 4); e += kThreads) {
      const int r = e / (kSpF / 4), f = 4 * (e % (kSpF / 4));
      const int g = g0 + r;
      const bool ok = g < g_end && c0 + f < d;
      cp_async16(dst + r * kSpStride + f, ok ? src + (size_t)g * d + c0 + f : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kSpF; e += kThreads) {
      const int r = e / kSpF, f = e % kSpF;
      const int g = g0 + r;
      const bool ok = g < g_end && c0 + f < d;
      cp_async4(dst + r * kSpStride + f, ok ? src + (size_t)g * d + c0 + f : src, ok ? 4 : 0);
    }
  }
}

// Copy the raw elements [c0, c0 + kSpF) of rows [g0, g0 + rows) of src (n
// rows of d elements of KT) into dst ([rows][kSpF]); rows past g_end and
// elements past d are left as they are or zero-filled (the conversion
// writes 0 there). ``vec``: d * sizeof(KT) % 16 == 0 and src 16-byte
// aligned, so 16-byte cp.async copies; else the elements are loaded and
// stored one by one.
template <typename KT>
__device__ __forceinline__ void sp_stage_raw(KT* dst, const KT* src, int rows, int g0,
                                             int g_end, int c0, int d, bool vec) {
  constexpr int kPer = 16 / (int)sizeof(KT);  // elements a 16-byte copy
  if (vec) {
    for (int e = threadIdx.x; e < rows * (kSpF / kPer); e += kThreads) {
      const int r = e / (kSpF / kPer), f = kPer * (e % (kSpF / kPer));
      const int g = g0 + r;
      const bool ok = g < g_end && c0 + f < d;
      const unsigned a = (unsigned)__cvta_generic_to_shared(dst + r * kSpF + f);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
                   "l"(ok ? src + (size_t)g * d + c0 + f : src), "r"(ok ? 16 : 0));
    }
  } else {
    for (int e = threadIdx.x; e < rows * kSpF; e += kThreads) {
      const int r = e / kSpF, f = e % kSpF;
      const int g = g0 + r;
      if (g < g_end && c0 + f < d) dst[r * kSpF + f] = src[(size_t)g * d + c0 + f];
    }
  }
}

// Widen or dequantize a raw chunk (rows [0, rows), features [c0, c0 +
// kSpF)) into the f32 key tile; rows past ``rows`` and features past d
// become 0, as the f32 staging zero-fills them.
template <typename KT>
__device__ __forceinline__ void sp_convert(float* dst, const KT* raw, int rows, int c0,
                                           int d, const float* scale, const float* zero) {
  for (int e = threadIdx.x; e < kSpKeys * kSpF; e += kThreads) {
    const int r = e / kSpF, f = e % kSpF;
    dst[r * kSpStride + f] = (r < rows && c0 + f < d)
                                 ? key_at<KT>(raw, (size_t)r * kSpF + f, c0 + f, scale, zero)
                                 : 0.f;
  }
}

// One block per (64-query tile, key range): the K best keys of the range
// for each query, under (dist, g), to part_d / part_i [nq][splits][K].
// ``vec``: the queries take 16-byte copies; ``kvec``: the keys do.
template <typename KT, int K>
__global__ void __launch_bounds__(kThreads, 2)
    topk_split_kernel(const float* __restrict__ q, const KT* __restrict__ keys,
                      const float* __restrict__ scale, const float* __restrict__ zero,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ q_gidx, float* __restrict__ part_d,
                      int* __restrict__ part_i, int nq, int p, int d,
                      int keys_per_split, int splits, int vec, int kvec) {
  using L = SpSmem<KT>;
  extern __shared__ __align__(16) float sp_smem[];
  float* sQ = sp_smem;                       // [2][kSpQ][kSpStride]
  float* sK = sQ + L::kQ;                    // f32 key tile(s) [kSpKeys][kSpStride]
  KT* sRaw = reinterpret_cast<KT*>(sK + L::kKeyTiles);  // [2][kSpKeys][kSpF]
  float* sYn = sK + L::kRegion;              // [kSpKeys]
  float* sXn = sYn + kSpKeys;                // [kSpQ]
  float* sD = sK;                            // [kSpQ][kSpDStride] between passes

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // queries ty + 16 i, keys tx + 16 j
  const int q0 = blockIdx.x * kSpQ;
  const int split = blockIdx.y;
  const int kbeg = split * keys_per_split;
  const int kend = min(p, kbeg + keys_per_split);
  const int nchunks = (d + kSpF - 1) / kSpF;
  const bool v16 = vec != 0, k16 = kvec != 0;

  // the scan: thread tid offers keys l, l + 4, ... of query q0 + tid / 4
  const int sq = tid / kSpLanes, sl = tid % kSpLanes;
  const int sqi = q0 + sq;
  const int self = (sqi < nq && q_gidx != nullptr) ? q_gidx[sqi] : -1;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = -1;
  }
  float xn = 0.f;  // threads tid < kSpQ: the norm of query q0 + tid

  for (int base = kbeg; base < kend; base += kSpKeys) {
    const int nk = min(kSpKeys, kend - base);
    const int ntiles = (nk + 63) / 64;
    const bool first = base == kbeg;
    float acc[kSpKT][4][4];
#pragma unroll
    for (int t = 0; t < kSpKT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
    float yn = 0.f;  // the norm of key base + tid

    // the key chunk c: f32 keys straight into the tile buffer c & 1,
    // other types raw into the staging buffer c & 1
    auto stage_keys = [&](int c) {
      if constexpr (L::kRaw)
        sp_stage_raw<KT>(sRaw + (c & 1) * kSpKeys * kSpF, keys, ntiles * 64, base,
                         base + nk, c * kSpF, d, k16);
      else
        sp_stage(sK + (c & 1) * kSpKeys * kSpStride, keys, ntiles * 64, base, base + nk,
                 c * kSpF, d, k16);
    };
    sp_stage(sQ, q, kSpQ, q0, nq, 0, d, v16);
    stage_keys(0);
    cp_async_commit();
    for (int c = 0; c < nchunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < nchunks) {
        // the other buffer was last read before the previous iteration's
        // closing barrier
        sp_stage(sQ + (buf ^ 1) * kSpQ * kSpStride, q, kSpQ, q0, nq, (c + 1) * kSpF, d, v16);
        stage_keys(c + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* cq = sQ + buf * kSpQ * kSpStride;
      const float* ck = sK;
      if constexpr (L::kRaw) {
        // the single f32 tile was last read before the previous closing
        // barrier
        sp_convert<KT>(sK, sRaw + buf * kSpKeys * kSpF, nk, c * kSpF, d, scale, zero);
        __syncthreads();
      } else {
        ck = sK + buf * kSpKeys * kSpStride;
      }
      // norms: fmaf chains in ascending feature order
      if (tid < ntiles * 64) {
        const float4* row = reinterpret_cast<const float4*>(ck + tid * kSpStride);
#pragma unroll
        for (int f4 = 0; f4 < kSpF / 4; ++f4) {
          const float4 y = row[f4];
          yn = fmaf(y.x, y.x, yn);
          yn = fmaf(y.y, y.y, yn);
          yn = fmaf(y.z, y.z, yn);
          yn = fmaf(y.w, y.w, yn);
        }
      }
      if (first && tid < kSpQ) {
        const float4* row = reinterpret_cast<const float4*>(cq + tid * kSpStride);
#pragma unroll
        for (int f4 = 0; f4 < kSpF / 4; ++f4) {
          const float4 x = row[f4];
          xn = fmaf(x.x, x.x, xn);
          xn = fmaf(x.y, x.y, xn);
          xn = fmaf(x.z, x.z, xn);
          xn = fmaf(x.w, x.w, xn);
        }
      }
      // the cross terms: per pair one fmaf chain in ascending feature order
#pragma unroll 2
      for (int f4 = 0; f4 < kSpF / 4; ++f4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = reinterpret_cast<const float4*>(cq + (ty + 16 * i) * kSpStride)[f4];
#pragma unroll
        for (int t = 0; t < kSpKT; ++t) {
          if (t < ntiles) {
            float4 b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = reinterpret_cast<const float4*>(ck + (t * 64 + tx + 16 * j) * kSpStride)[f4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float c2 = acc[t][i][j];
                c2 = fmaf(a[i].x, b[j].x, c2);
                c2 = fmaf(a[i].y, b[j].y, c2);
                c2 = fmaf(a[i].z, b[j].z, c2);
                c2 = fmaf(a[i].w, b[j].w, c2);
                acc[t][i][j] = c2;
              }
          }
        }
      }
      __syncthreads();  // this buffer is free for the chunk after next
    }

    // an invalid key (or one past the range) gets yn = +inf: its distance
    // is +inf and never enters a list
    sYn[tid] = (tid < nk && (valid == nullptr || valid[base + tid])) ? yn : CUDART_INF_F;
    if (first && tid < kSpQ) sXn[tid] = xn;
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kSpKT; ++t) {
      if (t < ntiles) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qa = ty + 16 * i, kb = t * 64 + tx + 16 * j;
            sD[qa * kSpDStride + kb] = fmaxf(sXn[qa] + sYn[kb] - 2.f * acc[t][i][j], 0.f);
          }
      }
    }
    __syncthreads();
    if (sqi < nq) {
      const float* row = sD + sq * kSpDStride;
      for (int c = sl; c < nk; c += kSpLanes) {
        const float dist = row[c];
        const int g = base + c;
        // keys arrive in ascending g within a lane: strict < keeps the
        // earlier index on a tie
        if (dist < bd[K - 1] && g != self) insert<K>(bd, bi, dist, g);
      }
    }
    __syncthreads();  // the tile's space is staged over by the next pass
  }

  quad_merge<K>(bd, bi);
  if (sl == 0 && sqi < nq) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[((size_t)sqi * splits + split) * K + s] = bd[s];
      part_i[((size_t)sqi * splits + split) * K + s] = bi[s];
    }
  }
}

// Per query: the splits' lists merged under (dist, g), the first k kept
// (the distances are already the CUDA-core arithmetic's)
template <int K>
__global__ void topk_split_merge_kernel(const float* __restrict__ part_d,
                                        const int* __restrict__ part_i, int splits,
                                        float* __restrict__ out_d,
                                        int* __restrict__ out_i, int nq, int k) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float bd[K];
  int bi[K];
  merge_parts<K>(part_d, part_i, splits, qi, bd, bi);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      out_d[(size_t)qi * k + s] = bd[s];
      out_i[(size_t)qi * k + s] = isinf(bd[s]) ? -1 : bi[s];
    }
  }
}

// the split kernels stage features kSpF at a time and zero-fill the rest,
// so they take any d >= 1; sp_route is where the default rule sends them
bool sp_ok(int d, int k) { return d >= 1 && k >= 1 && k <= kTcMaxK; }

long long sp_scratch_bytes(int nq, int p, int d, int k) {
  if (!sp_ok(d, k) || nq < 1) return 0;
  return (long long)nq * sp_splits(nq, p) * sp_list_len(k) * 8;
}

template <typename KT, int K>
cudaError_t launch_sp(REPRO_ROUTE_PARAMS) {
  const int splits = sp_splits(nq, p);
  const int per = sp_keys_per_split(p, splits);
  float* part_d = static_cast<float*>(scratch);
  int* part_i = reinterpret_cast<int*>(part_d + (size_t)nq * splits * K);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool kvec = (d * sizeof(KT)) % 16 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  constexpr size_t smem = SpSmem<KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      topk_split_kernel<KT, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kSpQ - 1) / kSpQ, splits);
  topk_split_kernel<KT, K><<<grid, kThreads, smem, stream>>>(
      q, keys, scale, zero, valid, q_gidx, part_d, part_i, nq, p, d, per, splits,
      vec ? 1 : 0, kvec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_split_merge_kernel<K><<<(nq + 127) / 128, 128, 0, stream>>>(
      part_d, part_i, splits, out_d, out_i, nq, k);
  return cudaGetLastError();
}


// D == 0 selects the chunked kernel (any d)
template <typename KT, int K, int D>
cudaError_t launch(const float* q, const KT* keys, const float* scale,
                   const float* zero, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, cudaStream_t stream) {
  const int blocks = (nq + kQPB - 1) / kQPB;
  if constexpr (D == 0)
    topk_chunked_kernel<KT, K><<<blocks, kThreads, 0, stream>>>(
        q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k);
  else
    topk_kernel<KT, K, D><<<blocks, kThreads, 0, stream>>>(
        q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k);
  return cudaGetLastError();
}

#define REPRO_TOPK_ARGS q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k, stream

template <typename KT, int D>
cudaError_t launch_k(const float* q, const KT* keys, const float* scale,
                     const float* zero, const unsigned char* valid,
                     const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                     int d, int k, cudaStream_t stream) {
  // the first k of a top-K list (K >= k) are the top-k under the same order
  if (k <= 16) return launch<KT, 16, D>(REPRO_TOPK_ARGS);
  return launch<KT, 32, D>(REPRO_TOPK_ARGS);
}

// the CUDA-core kernels: any k <= 32 (the default rule sends k <= 8 to the
// tensor-core route at d <= 32 and to the split route above)
template <typename KT>
cudaError_t launch_d(const float* q, const KT* keys, const float* scale,
                     const float* zero, const unsigned char* valid,
                     const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                     int d, int k, cudaStream_t stream) {
  if (nq < 0 || p < 0 || d < 1 || k < 1 || k > 32) return cudaErrorInvalidValue;
  if (nq == 0) return cudaSuccess;
  if (d <= 4) return launch_k<KT, 4>(REPRO_TOPK_ARGS);
  if (d <= 8) return launch_k<KT, 8>(REPRO_TOPK_ARGS);
  if (d <= 32) return launch_k<KT, 32>(REPRO_TOPK_ARGS);
  if (d <= 128) return launch_k<KT, 128>(REPRO_TOPK_ARGS);
  return launch_k<KT, 0>(REPRO_TOPK_ARGS);
}

// route codes: 0 the CUDA-core kernels, 1 the tensor-core route, 2 the
// CUDA-core split route; -1 asks for the default rule (default_route)
constexpr int kRouteCudaCore = 0, kRouteTc = 1, kRouteSplit = 2;

int default_route(int d, int k) {
  return tc_route(d, k) ? kRouteTc : sp_route(d, k) ? kRouteSplit : kRouteCudaCore;
}

// whether route r can run (d, k): the tensor-core route at d <= 32, k <= 8;
// the split route at k <= 8, any d; the CUDA-core kernels at k <= 32
bool route_ok(int r, int d, int k) {
  if (r == kRouteTc) return tc_route(d, k);
  if (r == kRouteSplit) return sp_ok(d, k);
  if (r == kRouteCudaCore) return d >= 1 && k >= 1 && k <= 32;
  return false;
}

// Every route of one key type: the default rule sends d <= 32, k <= 8 to
// the tensor-core route, d > 32, k <= 8 to the split route and k > 8 to the
// CUDA-core kernels; a route asked for by name runs wherever route_ok
// allows it, and an illegal one is refused, never rerouted.
template <typename KT>
cudaError_t launch_route(REPRO_ROUTE_PARAMS, int route) {
  if (route < 0) route = default_route(d, k);
  if (!route_ok(route, d, k)) return cudaErrorInvalidValue;
  if (nq > 0 && route == kRouteTc) {
    if (p < 0 || scratch == nullptr) return cudaErrorInvalidValue;
    switch (tc_width(d)) {
      case 8: return launch_tc_k<KT, 8>(REPRO_ROUTE_ARGS);
      case 16: return launch_tc_k<KT, 16>(REPRO_ROUTE_ARGS);
      case 32: return launch_tc_k<KT, 32>(REPRO_ROUTE_ARGS);
      default: return launch_tc_k<KT, 40>(REPRO_ROUTE_ARGS);
    }
  }
  if (nq > 0 && route == kRouteSplit) {
    if (p < 0 || scratch == nullptr) return cudaErrorInvalidValue;
    switch (sp_list_len(k)) {
      case 1: return launch_sp<KT, 1>(REPRO_ROUTE_ARGS);
      case 2: return launch_sp<KT, 2>(REPRO_ROUTE_ARGS);
      case 4: return launch_sp<KT, 4>(REPRO_ROUTE_ARGS);
      default: return launch_sp<KT, 8>(REPRO_ROUTE_ARGS);
    }
  }
  return launch_d<KT>(q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq, p, d, k,
                      stream);
}

#undef REPRO_ROUTE_PARAMS
#undef REPRO_ROUTE_ARGS

#undef REPRO_TOPK_ARGS

}  // namespace

#ifndef REPRO_TOPK_KEYS
#define REPRO_TOPK_KEYS 0
#endif

extern "C" {

int repro_topk_max_k() { return 32; }

// the default route of (d, k), the same for every key type: 1 the
// tensor-core route (3xTF32 cross term), 2 the CUDA-core split route, 0 the
// CUDA-core kernels
int repro_topk_route(int d, int k) { return default_route(d, k); }

// 1 when route (a code above) can run (d, k), else 0
int repro_topk_route_ok(int route, int d, int k) { return route_ok(route, d, k) ? 1 : 0; }

// key axis splits of the CUDA-core split route for nq queries and p keys
int repro_topk_split_count(int nq, int p) { return sp_splits(nq, p); }

// bytes of scratch this build's entry point needs on route (-1: the
// default): the TC and split routes' partial lists, 0 on the CUDA-core
// kernels or an illegal route
long long repro_topk_scratch_bytes(int nq, int p, int d, int k, int route) {
  if (route < 0) route = default_route(d, k);
  if (!route_ok(route, d, k)) return 0;
  if (route == kRouteTc) return tc_scratch_bytes(nq, p, d, k);
  if (route == kRouteSplit) return sp_scratch_bytes(nq, p, d, k);
  return 0;
}

#if REPRO_TOPK_KEYS == 0
// q (nq, d) f32, keys (p, d) f32, valid (p,) u8 or null, q_gidx (nq,) i32 or
// null, route (-1: the default), scratch of repro_topk_scratch_bytes on
// that route -> out_d (nq, k) f32, out_i (nq, k) i32. Returns a
// cudaError_t (cudaErrorInvalidValue for a route illegal at (d, k)).
int repro_topk_f32(const float* q, const float* keys, const unsigned char* valid,
                   const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                   int d, int k, int route, void* scratch, void* stream) {
  return (int)launch_route<float>(q, keys, nullptr, nullptr, valid, q_gidx, out_d, out_i,
                                  nq, p, d, k, scratch, static_cast<cudaStream_t>(stream),
                                  route);
}
#endif

#if REPRO_TOPK_KEYS == 1
// q (nq, d) f32 (bf16 queries widened), keys (p, d) bf16. As above.
int repro_topk_bf16(const float* q, const __nv_bfloat16* keys,
                    const unsigned char* valid, const int* q_gidx, float* out_d,
                    int* out_i, int nq, int p, int d, int k, int route, void* scratch,
                    void* stream) {
  return (int)launch_route<__nv_bfloat16>(q, keys, nullptr, nullptr, valid, q_gidx, out_d,
                                          out_i, nq, p, d, k, scratch,
                                          static_cast<cudaStream_t>(stream), route);
}
#endif

#if REPRO_TOPK_KEYS == 2
// int8 keys (p, d) with per-feature scale (d,) and zero (d,) f32: key value
// q8 * scale + zero. q (nq, d) f32. As above.
int repro_topk_int8(const float* q, const int8_t* keys, const float* scale,
                    const float* zero, const unsigned char* valid,
                    const int* q_gidx, float* out_d, int* out_i, int nq, int p,
                    int d, int k, int route, void* scratch, void* stream) {
  if (scale == nullptr || zero == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_route<int8_t>(q, keys, scale, zero, valid, q_gidx, out_d, out_i, nq,
                                   p, d, k, scratch, static_cast<cudaStream_t>(stream),
                                   route);
}
#endif

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
