// Flash-attention forward with logit softcap and a per-key bias: K5 of the
// port.
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel
// (flash_attention; the GQA repeat of src/repro/kernels/ops.py:288-294 is
// replaced by indexing kv head h / (hq / hkv)).
//
// Computes, for every batch b, query head h (kv head hk = h / (hq / hkv)),
// query row i (global position qpos = i + lk - lq) and key j < lk:
//   s    = scale * (q[b,h,i] . k[b,hk,j])
//   s    = softcap * tanh(s / softcap)            if softcap > 0
//   s   += bias[b, hk or h, j]                      if a bias is given
//   s    = -1e30                                    if causal and j > qpos
//   out  = sum_j exp(s - m) v[b,hk,j] / max(sum_j exp(s - m), 1e-30)
// in f32 whatever the input type, and stores out in q's type. Masked logits
// are replaced by the finite -1e30, as the Pallas kernel does; the running
// max starts at -1e30, so a tile whose logits are all masked yields no NaN,
// and a later real key wipes what it added through alpha = exp(m - m_new).
//
// What bounds it on an H100: the operations. A prefill call of gemma2-2b
// (q 4 x 8 x 2048 x 256, causal) needs ~69 GFLOP for the visible half
// against ~67 MB of q, k, v and out; decode (one query row per head against
// the cache) is bound by reading k and v: 20.2 MB at kv 1232, 6 us.
//
// Three routes, chosen by the packed row count g * lq (g = hq / hkv) of a
// kv head, the type and head_dim: at most kSplitMaxRows rows (every decode
// call) take the split-kv route; the others the tensor-core tiled route
// when q, k and v are bf16 at head_dim 64, 96, 128 or 256 (every prefill of the
// served LM), else the tiled kernel.
//
// The split-kv route (split_kv_kernel, then split_combine_kernel). One
// block per (batch, kv head) leaves 16 blocks on 132 SMs at decode, with
// one warp in eight working, so the key axis is split across blocks: the
// grid is (b * hkv, splits), each split a range of split_keys(lk) keys (64,
// doubled until there are at most 32 splits: 20 splits of 64 at lk = 1232,
// 320 blocks). A block serves all g * lq rows of its kv head; each of its 4
// warps walks its own quarter of the split's keys, a few keys at a time,
// reading k and v rows straight from device memory, a lane its dh / 32
// consecutive features (one 16-byte load a lane, 512 bytes a warp, for a
// bf16 row of 256), with the rows' q in f32 registers. A logit is the
// lanes' partial dot products summed by a xor butterfly (every lane ends
// with the same bits), then scale, softcap, bias and the causal -1e30 as
// below, -inf past the warp's range; an online softmax (m from -1e30, l,
// acc) runs per warp. The 4 warps' partials meet in shared memory in warp
// order and one partial (m, l, acc[dh], f32) per (row, split) goes to a
// scratch the wrapper allocates. The combine kernel then takes, per row and
// in split order, M = max m_s, L = sum l_s exp(m_s - M), out = sum acc_s
// exp(m_s - M) / max(L, 1e-30), stored in q's type. No atomics anywhere, so
// a repeat is bitwise. Masked splits drop out exactly: a split whose
// logits are all -1e30 (a masked middle or tail of the cache) ends with m_s
// = -1e30 and l_s = its key count, and a warp or split with no key at all
// keeps m = -1e30, l = 0, acc = 0; as soon as any split has a key with a
// finite bias, M is finite and exp(-1e30 - M) = 0 in f32, so either weighs
// nothing. A row whose every key carries -1e30 has no defined answer (M =
// -1e30 and all keys weigh 1: the average of v over the whole range, as the
// one-block kernel averages over the keys it visits); the LM forms no such
// row, since the slot being decoded is always visible with a finite bias.
//
// The lse entry (repro_flash_attention_lse) runs the same split-kv route and
// returns the softmax statistics the Pallas kernel keeps in m_ref and l_ref
// (its wrapper drops them): the combine also writes lse = M + log L per row
// and the output in f32. A row with no unmasked key (M <= kNoKey, or no key
// at all) gets lse = -inf, so a merge of several such (out, lse) pairs can
// weigh it 0. A model axis that splits the decode cache along the sequence
// attends each rank's slots through it and merges the ranks in rank order.
//
// The tiled route (flash_kernel; prefill and every call with more rows).
// Design (simple and right first): the hq / hkv query heads that share a kv
// head are packed with their rows into one row space of g * lq rows, so a
// block owns 64 rows of one (batch, kv head) and every kv tile it stages
// serves all of them.
// The block's q tile (64 x dh) and each kv tile (32 keys of k and v) are
// staged in f32 in dynamic shared memory (140 KB at dh = 256, hence
// cudaFuncSetAttribute). 256 threads: a group of 8 threads owns 2 rows; each
// thread computes 2 x 4 logits of a tile and carries 2 x dh/8 output columns
// in registers, with the rows' running max and sum replicated in the 8
// threads and reduced by shuffles inside the group. Rows are padded by one
// float in shared memory so the 8 threads of a group read 8 banks. kv tiles
// wholly in the causal future of every row of the block are skipped: that
// equals processing them whenever a row has a visible key whose bias is not
// -1e30 (its logit then sets m, and exp(-1e30 - m) = 0). A row with no such
// key has no defined answer (every logit it sees is -1e30, and each version
// averages v over the keys it visits); the wrapper refuses causal calls
// with lq > lk, whose first rows see no key at all. Warps whose rows
// all lie past the end of the row space skip the arithmetic. Both routes
// run on the CUDA cores in f32 with accurate expf and tanhf; no atomics, so
// a launch is repeatable bit for bit.
//
// The tensor-core tiled route (flash_mma_kernel; bf16, dh 64/96/128/256). The
// tiled kernel above stages bf16 as f32 (140 KB at dh 256) and runs both
// products on the CUDA cores, where q.k and p.v (4 * dh flops a visible
// pair) set its pace. Here the rows are packed and the causal future
// skipped as above, a block owns 128 packed rows with 8 warps of 16, and
// the block's q tile and 64-key tiles of k and v stay bf16 in shared
// memory (rows padded by 16 bytes, so an ldmatrix phase of 8 rows hits 8
// bank quads; 203 KB at dh 256 with two k and two v buffers, so one block
// an SM), the next kv tile copied by cp.async while this one is computed.
// A block of 4 warps (64 rows, 165 KB) ran slower: 4 warps an SM hide
// too little of the mma and softmax latency, and each kv tile served half
// the rows (PERF.md). q.k is
// mma.sync.m16n8k16 with bf16 operands from ldmatrix and f32 accumulation:
// each product of two bf16 is exact in f32, as in the reference's f32 dot of
// widened bf16 (the tensor core's order of the sums is its own). The logit
// rules (scale, softcap with accurate tanhf, bias, the causal -1e30, -inf
// past lk) and the online softmax with accurate expf run in f32 on the
// accumulator fragments, each row's max over the 4 threads of its quad.
// p is f32 in the reference, so it is not rounded to one bf16: p = p_hi +
// p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi) (about 16 significant
// bits), and two mma with the same v fragment (ldmatrix.trans; v is exact
// bf16) add p_hi.v and p_lo.v into the f32 output; the accumulator's
// layout is the next A fragment's, so p never goes to shared memory. The
// sum l is taken of the f32 p. A warp carries 16 x dh f32 outputs (128
// registers a thread at dh 256) and a 16 x 64 logit tile (32). The row
// tiles run heaviest first. No atomics: a repeat is bitwise. At dh 96
// (phi-3-vision's MHA 32 x 96) q.k takes 6 k-steps of 16 and p.v 12 n8
// tiles, 48 output registers a thread, 78 KB of shared memory a block; the
// padded row of 104 elements keeps the ldmatrix phases conflict-free. The
// split-kv route serves dh 96 with its DH 128 instance (a lane's 4
// features, element loads: dh != DH).
//
// Later work: wgmma over a 64-row warpgroup and TMA-fed kv tiles with a
// producer warp (mma.sync issues a warp's 16 rows at a time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                       // threads that share a row pair
constexpr int kRowsPerThread = 2;
constexpr int kBQ = kThreads / kGroup * kRowsPerThread;  // 64 rows a block
constexpr int kBK = 32;                         // keys a kv tile
constexpr int kColsPerThread = kBK / kGroup;    // 4 logits per row a thread
constexpr float kMasked = -1e30f;
// a row's max logit at or below this saw no unmasked key (lse -inf)
constexpr float kNoKey = -1e29f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (DH + 1) + (size_t)kBK * (DH + 1) +
                          (size_t)kBK * DH + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int hq, int hkv, int lq, int lk, int dh,
                 int bias_heads, int causal, float scale, float softcap) {
  constexpr int NJ = DH / kGroup;  // output columns a thread carries per row
  extern __shared__ float smem[];
  float* sQ = smem;                          // [kBQ][DH + 1]
  float* sK = sQ + kBQ * (DH + 1);           // [kBK][DH + 1]
  float* sV = sK + kBK * (DH + 1);           // [kBK][DH]
  float* sP = sV + kBK * DH;                 // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int rg = tid / kGroup;
  const int cl = tid % kGroup;
  const int bh = blockIdx.x;           // batch * hkv + kv head
  const int bb = bh / hkv, hk = bh % hkv;
  const int g = hq / hkv;
  const int n_rows = g * lq;           // packed (query head in group, row)
  const int row0 = blockIdx.y * kBQ;
  const int rows_here = min(kBQ, n_rows - row0);
  // the warp's rows: rg 4w .. 4w+3, rows 8w .. 8w+7 of the block
  const bool warp_live = (tid / 32) * (32 / kGroup) * kRowsPerThread < rows_here;

  // ---- the q tile, f32, zero-padded to DH columns and kBQ rows
  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, f = e % DH;
    const int rho = row0 + r;
    float val = 0.f;
    if (r < rows_here && f < dh) {
      const int h = hk * g + rho / lq, i = rho % lq;
      val = to_f32(q[(((size_t)bb * hq + h) * lq + i) * dh + f]);
    }
    sQ[r * (DH + 1) + f] = val;
  }

  int head[kRowsPerThread], qpos[kRowsPerThread];
  bool row_ok[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = rg * kRowsPerThread + t;
    row_ok[t] = r < rows_here;
    const int rho = row_ok[t] ? row0 + r : row0;
    head[t] = hk * g + rho / lq;
    qpos[t] = rho % lq + lk - lq;
  }

  // causal: the last key any row of the block can see
  int kv_end = lk;
  if (causal) {
    const int last = row0 + rows_here - 1;
    const int max_i = (last / lq != row0 / lq) ? lq - 1 : last % lq;
    kv_end = min(lk, max_i + lk - lq + 1);
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][NJ];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    m[t] = kMasked;
    l[t] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[t][j] = 0.f;
  }

  const size_t kv_base = ((size_t)bb * hkv + hk) * lk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH, f = e % DH;
      const int kp = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < lk && f < dh) {
        kv = to_f32(k[(kv_base + kp) * dh + f]);
        vv = to_f32(v[(kv_base + kp) * dh + f]);
      }
      sK[c * (DH + 1) + f] = kv;
      sV[c * DH + f] = vv;
    }
    __syncthreads();
    if (warp_live) {
      float s[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[t][j] = 0.f;
      const float* q0 = sQ + (rg * kRowsPerThread) * (DH + 1);
#pragma unroll 4
      for (int f = 0; f < dh; ++f) {
        float qv[kRowsPerThread];
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t) qv[t] = q0[t * (DH + 1) + f];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const float kv = sK[(cl + kGroup * j) * (DH + 1) + f];
#pragma unroll
          for (int t = 0; t < kRowsPerThread; ++t) s[t][j] = fmaf(qv[t], kv, s[t][j]);
        }
      }
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) {
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int kp = k0 + cl + kGroup * j;
          float x = s[t][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (kp >= lk || !row_ok[t]) {
            x = -CUDART_INF_F;  // past the end: no weight at all
          } else {
            if (bias != nullptr)
              x += bias[((size_t)bb * bias_heads + (bias_heads == hq ? head[t] : hk)) * lk + kp];
            if (causal && kp > qpos[t]) x = kMasked;
          }
          s[t][j] = x;
          mt = fmaxf(mt, x);
        }
#pragma unroll
        for (int off = 1; off < kGroup; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[t], mt);
        const float alpha = expf(m[t] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const float p = expf(s[t][j] - m_new);
          rs += p;
          sP[(rg * kRowsPerThread + t) * (kBK + 1) + cl + kGroup * j] = p;
        }
#pragma unroll
        for (int off = 1; off < kGroup; off <<= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[t] = l[t] * alpha + rs;
        m[t] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[t][j] *= alpha;
      }
    }
    __syncthreads();  // sP complete
    if (warp_live) {
      const int nk = min(kBK, lk - k0);
      for (int c = 0; c < nk; ++c) {
        float p[kRowsPerThread];
#pragma unroll
        for (int t = 0; t < kRowsPerThread; ++t)
          p[t] = sP[(rg * kRowsPerThread + t) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = sV[c * DH + cl + kGroup * j];
#pragma unroll
          for (int t = 0; t < kRowsPerThread; ++t) acc[t][j] = fmaf(p[t], vv, acc[t][j]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    if (!row_ok[t]) continue;
    const int r = rg * kRowsPerThread + t;
    const int i = (row0 + r) % lq;
    const float inv = 1.f / fmaxf(l[t], 1e-30f);
    T* o = out + (((size_t)bb * hq + head[t]) * lq + i) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = cl + kGroup * j;
      if (col < dh) store(o + col, acc[t][j] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, int b, int hq, int hkv, int lq, int lk, int dh,
                   int bias_heads, int causal, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long row_tiles = ((long long)(hq / hkv) * lq + kBQ - 1) / kBQ;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * hkv), (unsigned)row_tiles);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), hq, hkv, lq, lk, dh, bias_heads, causal, scale,
      softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const float* bias,
                      void* out, int b, int hq, int hkv, int lq, int lk, int dh,
                      int bias_heads, int causal, float scale, float softcap,
                      cudaStream_t s) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
  return launch<T, 256>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
}

// ---------------------------------------------------------------- tiled_mma

constexpr int kMmaThreads = 256;  // 8 warps, 16 packed rows each
constexpr int kMmaRows = 128;     // packed rows a block
constexpr int kMmaKeys = 64;      // keys a kv tile

// bf16 q, k and v at a head_dim the tensor-core tiles take whole
bool mma_route(int dtype, int dh) {
  return dtype == 1 && (dh == 64 || dh == 96 || dh == 128 || dh == 256);
}

// bf16 elements a staged row: DH plus 16 bytes, so the 8 rows an ldmatrix
// phase reads start in 8 different bank quads (row r at 4-byte word
// r * (DH + 8) / 2: mod 32 that is 4 r, 20 r, 4 r and 4 r at DH 64, 96,
// 128 and 256, eight distinct multiples of 4 for r = 0..7)
template <int DH>
__host__ __device__ constexpr int mma_stride() { return DH + 8; }

// the q tile and two buffers each of the k and v tiles
template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_stride<DH>() * (kMmaRows + 4 * kMmaKeys);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory (lane l gives the row address
// of matrix l / 8), plain or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += A (16x16, row) * B (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 t;
  t.x = lo;  // the lower column sits in the low half
  t.y = hi;
  return *reinterpret_cast<uint32_t*>(&t);
}

// p (f32) as p_hi + p_lo, two bf16: p_hi = bf16(p), p_lo = bf16(p - p_hi)
// (the difference is exact in f32), together about 16 significant bits;
// (a, b) two neighbouring columns of one row
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  hi = pack_bf16(ah, bh);
  lo = pack_bf16(__float2bfloat16_rn(a - __bfloat162float(ah)),
                 __float2bfloat16_rn(b - __bfloat162float(bh)));
}

// One block per (batch * kv head, 128 packed rows), 8 warps of 16 rows.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int hq, int hkv, int lq, int lk,
                     int bias_heads, int causal, float scale, float softcap) {
  constexpr int S = mma_stride<DH>();
  constexpr int CPR = DH / 8;  // 16-byte pieces a row
  constexpr int NO = DH / 8;   // n8 column tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [kMmaRows][S]
  __nv_bfloat16* sK = sQ + kMmaRows * S;                             // [2][kMmaKeys][S]
  __nv_bfloat16* sV = sK + 2 * kMmaKeys * S;                         // [2][kMmaKeys][S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x;
  const int bb = bh / hkv, hk = bh % hkv;
  const int g = hq / hkv;
  const int n_rows = g * lq;
  // the row tiles with the most visible keys first (a causal call's last
  // rows), so the short ones fill the tail of the grid
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int rows_here = min(kMmaRows, n_rows - row0);

  int kv_end = lk;  // causal: the last key any row of the block sees, + 1
  if (causal) {
    const int last = row0 + rows_here - 1;
    const int max_i = (last / lq != row0 / lq) ? lq - 1 : last % lq;
    kv_end = min(lk, max_i + lk - lq + 1);
  }
  const int ntiles = (kv_end + kMmaKeys - 1) / kMmaKeys;
  const size_t kv_base = ((size_t)bb * hkv + hk) * lk;

  // the q tile (rows past the row space zero-filled) and kv tile 0
  for (int e = tid; e < kMmaRows * CPR; e += kMmaThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool ok = r < rows_here;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int rho = row0 + r, h = hk * g + rho / lq, i = rho % lq;
      src = q + (((size_t)bb * hq + h) * lq + i) * DH + c;
    }
    cp_async16(sQ + r * S + c, src, ok ? 16 : 0);
  }
  // kv tile t into buffer t & 1; keys past lk zero-filled (v must not
  // carry garbage into 0 * v)
  auto stage_kv = [&](int t) {
    __nv_bfloat16* dk = sK + (t & 1) * kMmaKeys * S;
    __nv_bfloat16* dv = sV + (t & 1) * kMmaKeys * S;
    const int k0 = t * kMmaKeys;
    for (int e = tid; e < kMmaKeys * CPR; e += kMmaThreads) {
      const int r = e / CPR, c = (e % CPR) * 8;
      const bool ok = k0 + r < lk;
      const size_t off = (kv_base + k0 + r) * DH + c;
      cp_async16(dk + r * S + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(dv + r * S + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) stage_kv(0);
  cp_async_commit();

  // this thread's rows of the accumulator: warp * 16 + grp and + 8
  int head[2], qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = warp * 16 + grp + 8 * t;
    row_ok[t] = r < rows_here;
    const int rho = row_ok[t] ? row0 + r : row0;
    head[t] = hk * g + rho / lq;
    qpos[t] = rho % lq + lk - lq;
  }
  const bool warp_live = warp * 16 < rows_here;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // l: this thread's part

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      // buffer (t + 1) & 1 was last read before the previous closing barrier
      stage_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const __nv_bfloat16* cK = sK + (t & 1) * kMmaKeys * S;
      const __nv_bfloat16* cV = sV + (t & 1) * kMmaKeys * S;
      // s = q . k for the warp's 16 rows and the tile's 64 keys: products
      // of bf16 exact, summed in f32; s[n]: keys 8 n + 2 tig (+1), rows
      // grp ([0], [1]) and grp + 8 ([2], [3])
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * S + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[4];
          ldsm_x4(b, cK + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * S + ks * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * j], a, b[0], b[1]);
          mma_bf16(s[2 * j + 1], a, b[2], b[3]);
        }
      }
      // logits: scale, softcap, bias, the causal -1e30, -inf past lk or
      // the row space; then the online softmax (m from -1e30) of each row,
      // its max over the 4 threads of the row's quad
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = e >> 1;
          const int kp = t * kMmaKeys + 8 * n + 2 * tig + (e & 1);
          float x = s[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (kp >= lk || !row_ok[tr]) {
            x = -CUDART_INF_F;  // past the end: no weight at all
          } else {
            if (bias != nullptr)
              x += bias[((size_t)bb * bias_heads + (bias_heads == hq ? head[tr] : hk)) * lk + kp];
            if (causal && kp > qpos[tr]) x = kMasked;
          }
          s[n][e] = x;
          mx[tr] = fmaxf(mx[tr], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int tr = 0; tr < 2; ++tr) {
        mx[tr] = fmaxf(mx[tr], __shfl_xor_sync(0xffffffffu, mx[tr], 1));
        mx[tr] = fmaxf(mx[tr], __shfl_xor_sync(0xffffffffu, mx[tr], 2));
        const float m_new = fmaxf(m[tr], mx[tr]);
        alpha[tr] = expf(m[tr] - m_new);
        m[tr] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = expf(s[n][e] - m[e >> 1]);
          s[n][e] = pv;
          rs[e >> 1] += pv;
        }
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // o += p . v, 16 keys a step: the accumulator's layout is the A
      // fragment's (keys 16 kk .. + 15 are tiles 2 kk and 2 kk + 1), p
      // split into p_hi + p_lo, two mma with the same v fragment
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
          uint32_t b[4];
          ldsm_x4_t(b, cV + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S + 16 * j +
                           (lane >> 4) * 8);
          mma_bf16(o[2 * j], ph, b[0], b[1]);
          mma_bf16(o[2 * j], pl, b[0], b[1]);
          mma_bf16(o[2 * j + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * j + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is free for tile t + 2
  }

#pragma unroll
  for (int tr = 0; tr < 2; ++tr) {
    l[tr] += __shfl_xor_sync(0xffffffffu, l[tr], 1);
    l[tr] += __shfl_xor_sync(0xffffffffu, l[tr], 2);
    if (!row_ok[tr]) continue;
    const int rho = row0 + warp * 16 + grp + 8 * tr;
    const float inv = 1.f / fmaxf(l[tr], 1e-30f);
    __nv_bfloat16* o_row = out + (((size_t)bb * hq + head[tr]) * lq + rho % lq) * DH;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(o_row + 8 * j + 2 * tig) =
          pack_bf16(__float2bfloat16(o[j][2 * tr] * inv), __float2bfloat16(o[j][2 * tr + 1] * inv));
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       void* out, int b, int hq, int hkv, int lq, int lk, int bias_heads,
                       int causal, float scale, float softcap, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorMisalignedAddress;  // the wrapper hands over aligned copies
  constexpr size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long row_tiles = ((long long)(hq / hkv) * lq + kMmaRows - 1) / kMmaRows;
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  flash_mma_kernel<DH><<<dim3((unsigned)(b * hkv), (unsigned)row_tiles), kMmaThreads, smem,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), hq, hkv,
      lq, lk, bias_heads, causal, scale, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- split-kv

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitMaxRows = 8;    // g * lq a call may have on this route
constexpr int kSplitMinKeys = 64;   // keys a split holds at least
constexpr int kSplitMaxSplits = 32;
constexpr int kCombineThreads = 128;

bool split_route(int hq, int hkv, int lq) {
  return hkv >= 1 && hq % hkv == 0 && (long long)(hq / hkv) * lq <= kSplitMaxRows;
}

// keys of a split: kSplitMinKeys, doubled until at most kSplitMaxSplits
// splits cover lk
int split_keys(int lk) {
  long long s = kSplitMinKeys;
  while ((lk + s - 1) / s > kSplitMaxSplits) s *= 2;
  return (int)s;
}

int split_count(int lk) {
  const int s = split_keys(lk);
  const int n = (int)(((long long)lk + s - 1) / s);
  return n < 1 ? 1 : n;
}

// the partials: acc [b * hkv][rows][splits][dh], then m and l, each
// [b * hkv][rows][splits]
long long split_scratch_bytes(int b, int hq, int hkv, int lq, int lk, int dh) {
  if (!split_route(hq, hkv, lq) || b < 1 || lq < 1) return 0;
  const long long parts = (long long)b * hkv * (hq / hkv) * lq * split_count(lk);
  return parts * (dh + 2) * (long long)sizeof(float);
}

// FPL consecutive features of a row (features lane * FPL ...) as f32. With
// ``vec`` the row has exactly 32 * FPL features and 16-byte aligned rows,
// so they come as whole 4-, 8- or 16-byte words; else one element at a
// time, zero past dh.
template <typename T, int FPL>
__device__ __forceinline__ void load_feats(const T* __restrict__ row, int lane, int dh,
                                           bool vec, float (&x)[FPL]) {
  constexpr int kEpw = 4 / (int)sizeof(T);   // elements a 32-bit word
  constexpr int kWords = FPL / kEpw;
  const int f0 = lane * FPL;
  if (vec) {
    uint32_t w[kWords];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(row + f0);
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      w[0] = u.x; w[1] = u.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = src[i];
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (kEpw == 1) {
        x[i] = __uint_as_float(w[i]);
      } else {  // bf16: the low half is the earlier element
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < FPL; ++e) x[e] = f0 + e < dh ? to_f32(row[f0 + e]) : 0.f;
  }
}

// One block per (batch * kv head, split): the partial (m, l, acc) of every
// packed row of the kv head over the split's keys. R >= g * lq rows, DH >=
// dh a multiple of 64 (a lane owns DH / 32 features).
template <typename T, int DH, int R>
__global__ void __launch_bounds__(kSplitThreads)
    split_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ part, int hq, int hkv, int lq, int lk,
                    int dh, int bias_heads, int causal, float scale, float softcap,
                    int keys_per_split, int splits, int vec) {
  constexpr int FPL = DH / 32;
  constexpr int KG = R <= 2 ? 4 : 2;  // keys a warp takes at once
  __shared__ float s_m[kSplitWarps][R], s_l[kSplitWarps][R];
  __shared__ float s_acc[kSplitWarps][R][DH];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int bb = bh / hkv, hk = bh % hkv;
  const int split = blockIdx.y;
  const int g = hq / hkv;
  const int n_rows = g * lq;

  float qf[R][FPL];
  int head[R], qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = r < n_rows ? r : 0;
    head[r] = hk * g + rr / lq;
    qpos[r] = rr % lq + lk - lq;
    if (r < n_rows) {
      load_feats<T, FPL>(q + (((size_t)bb * hq + head[r]) * lq + rr % lq) * dh, lane, dh,
                         vec != 0, qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < FPL; ++e) qf[r][e] = 0.f;
    }
  }

  const int per_warp = keys_per_split / kSplitWarps;
  const int k_end = min(lk, (split + 1) * keys_per_split);
  const int w0 = split * keys_per_split + warp * per_warp;
  const int w1 = min(k_end, w0 + per_warp);
  const size_t kv_base = ((size_t)bb * hkv + hk) * lk;

  float m[R], l[R], acc[R][FPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < FPL; ++e) acc[r][e] = 0.f;
  }

  for (int c0 = w0; c0 < w1; c0 += KG) {
    float kf[KG][FPL], vf[KG][FPL];
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (c0 + j < w1) {
        load_feats<T, FPL>(k + (kv_base + c0 + j) * dh, lane, dh, vec != 0, kf[j]);
        load_feats<T, FPL>(v + (kv_base + c0 + j) * dh, lane, dh, vec != 0, vf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < FPL; ++e) kf[j][e] = vf[j][e] = 0.f;
      }
    }
    float s[R][KG];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < FPL; ++e) a = fmaf(qf[r][e], kf[j][e], a);
        s[r][j] = a;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < KG; ++j) s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], off);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        const int kp = c0 + j;
        float x = s[r][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (kp >= w1 || r >= n_rows) {
          x = -CUDART_INF_F;  // past the range: no weight at all
        } else {
          if (bias != nullptr)
            x += bias[((size_t)bb * bias_heads + (bias_heads == hq ? head[r] : hk)) * lk + kp];
          if (causal && kp > qpos[r]) x = kMasked;
        }
        s[r][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      float p[KG], rs = 0.f;
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        p[j] = expf(s[r][j] - m_new);
        rs += p[j];
      }
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < FPL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int j = 0; j < KG; ++j) a = fmaf(p[j], vf[j][e], a);
        acc[r][e] = a;
      }
    }
  }

  // the warps' partials, combined in warp order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < FPL; ++e) s_acc[warp][r][lane * FPL + e] = acc[r][e];
  }
  __syncthreads();
  const size_t row0 = (size_t)bh * n_rows;
  const size_t n_parts = (size_t)gridDim.x * n_rows * splits;
  float* part_acc = part;
  float* part_m = part + n_parts * dh;
  float* part_l = part_m + n_parts;
  for (int e = threadIdx.x; e < n_rows * dh; e += kSplitThreads) {
    const int r = e / dh, f = e % dh;
    float mm = kMasked;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mm = fmaxf(mm, s_m[w][r]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(s_m[w][r] - mm);
      a = fmaf(s_acc[w][r][f], wt, a);
      ll = fmaf(s_l[w][r], wt, ll);
    }
    const size_t pi = (row0 + r) * splits + split;
    part_acc[pi * dh + f] = a;
    if (f == 0) {
      part_m[pi] = mm;
      part_l[pi] = ll;
    }
  }
}

// One block per (batch * kv head, packed row): the splits' partials in
// split order, stored in TO (q's type, or f32 for the lse entry); with
// ``lse`` also the row's log-sum-exp M + log L, -inf for a row whose every
// logit is masked (M at or below kNoKey) or that has no key.
template <typename TO>
__global__ void __launch_bounds__(kCombineThreads)
    split_combine_kernel(const float* __restrict__ part, TO* __restrict__ out,
                         float* __restrict__ lse, int hq, int hkv, int lq, int dh,
                         int splits, long long n_parts) {
  __shared__ float s_w[kSplitMaxSplits];
  const int g = hq / hkv;
  const int n_rows = g * lq;
  const long long rid = blockIdx.x;  // (batch * kv head) * n_rows + row
  const int bh = (int)(rid / n_rows), r = (int)(rid % n_rows);
  const int bb = bh / hkv, hk = bh % hkv;
  const int h = hk * g + r / lq, i = r % lq;
  const float* part_acc = part + rid * splits * dh;
  const float* pm = part + n_parts * dh + rid * splits;
  const float* pl = pm + n_parts;
  float mm = kMasked;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, pm[s]);
  if (threadIdx.x < splits) s_w[threadIdx.x] = expf(pm[threadIdx.x] - mm);
  __syncthreads();
  float ll = 0.f;
  for (int s = 0; s < splits; ++s) ll = fmaf(pl[s], s_w[s], ll);
  const float den = fmaxf(ll, 1e-30f);
  const size_t row = ((size_t)bb * hq + h) * lq + i;
  TO* o = out + row * dh;
  for (int f = threadIdx.x; f < dh; f += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a = fmaf(part_acc[(size_t)s * dh + f], s_w[s], a);
    store(o + f, a / den);
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[row] = (mm <= kNoKey || ll <= 0.f) ? -CUDART_INF_F : mm + logf(ll);
}

template <typename T, int DH, int R>
cudaError_t launch_split(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, int b, int hq, int hkv, int lq, int lk,
                         int dh, int bias_heads, int causal, float scale, float softcap,
                         void* scratch, cudaStream_t stream) {
  const int keys = split_keys(lk), splits = split_count(lk);
  const int n_rows = (hq / hkv) * lq;
  const long long blocks = (long long)b * hkv;
  const long long n_parts = blocks * n_rows * splits;
  if (blocks * n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = dh == DH && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                 reinterpret_cast<uintptr_t>(v)) % 16 == 0);
  float* part = static_cast<float*>(scratch);
  split_kv_kernel<T, DH, R><<<dim3((unsigned)blocks, (unsigned)splits), kSplitThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      part, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, keys, splits,
      vec ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (lse != nullptr)  // the lse entry: the output in f32 beside the statistics
    split_combine_kernel<float><<<(unsigned)(blocks * n_rows), kCombineThreads, 0, stream>>>(
        part, static_cast<float*>(out), lse, hq, hkv, lq, dh, splits, n_parts);
  else
    split_combine_kernel<T><<<(unsigned)(blocks * n_rows), kCombineThreads, 0, stream>>>(
        part, static_cast<T*>(out), nullptr, hq, hkv, lq, dh, splits, n_parts);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_split_dh(const void* q, const void* k, const void* v, const float* bias,
                            void* out, float* lse, int b, int hq, int hkv, int lq, int lk,
                            int dh, int bias_heads, int causal, float scale, float softcap,
                            void* scratch, cudaStream_t s) {
  if (dh <= 64)
    return launch_split<T, 64, R>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
  if (dh <= 128)
    return launch_split<T, 128, R>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
  return launch_split<T, 256, R>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
}

template <typename T>
cudaError_t launch_split_rows(const void* q, const void* k, const void* v, const float* bias,
                              void* out, float* lse, int b, int hq, int hkv, int lq, int lk,
                              int dh, int bias_heads, int causal, float scale, float softcap,
                              void* scratch, cudaStream_t s) {
  if ((hq / hkv) * lq <= 2)
    return launch_split_dh<T, 2>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
  return launch_split_dh<T, kSplitMaxRows>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
}

}  // namespace

extern "C" {

int repro_flash_attention_max_dh() { return 256; }

// the route of a call: 1 split-kv (at most kSplitMaxRows packed rows a kv
// head), 2 tiled_mma (bf16, head_dim 64, 96, 128 or 256), 0 tiled
int repro_flash_attention_route(int hq, int hkv, int lq, int dtype, int dh) {
  return split_route(hq, hkv, lq) ? 1 : mma_route(dtype, dh) ? 2 : 0;
}

// keys of a split of the split-kv route at kv length lk
int repro_flash_attention_split_keys(int lk) { return split_keys(lk); }

// bytes of scratch repro_flash_attention needs (the split-kv partials; 0 on
// the tiled route)
long long repro_flash_attention_scratch_bytes(int b, int hq, int hkv, int lq, int lk,
                                              int dh) {
  return split_scratch_bytes(b, hq, hkv, lq, lk, dh);
}

// q (b, hq, lq, dh), k and v (b, hkv, lk, dh), out (b, hq, lq, dh), all
// contiguous in one type: dtype 0 = f32, 1 = bf16. bias (b, bias_heads, lk)
// f32 or null, bias_heads = hkv or hq. scratch: the bytes
// repro_flash_attention_scratch_bytes asks for. Returns a cudaError_t.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          const float* bias, void* out, int dtype, int b, int hq,
                          int hkv, int lq, int lk, int dh, int bias_heads,
                          int causal, float scale, float softcap, void* scratch,
                          void* stream) {
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv != 0 || lq < 0 || lk < 0 || dh < 1 ||
      dh > 256 || (bias != nullptr && bias_heads != hkv && bias_heads != hq) ||
      (dtype != 0 && dtype != 1) || (long long)b * hkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || lq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_route(hq, hkv, lq)) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)launch_split_rows<float>(q, k, v, bias, out, nullptr, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
    return (int)launch_split_rows<__nv_bfloat16>(q, k, v, bias, out, nullptr, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
  }
  if (mma_route(dtype, dh)) {
    if (dh == 64)
      return (int)launch_mma<64>(q, k, v, bias, out, b, hq, hkv, lq, lk, bias_heads, causal, scale, softcap, s);
    if (dh == 96)
      return (int)launch_mma<96>(q, k, v, bias, out, b, hq, hkv, lq, lk, bias_heads, causal, scale, softcap, s);
    if (dh == 128)
      return (int)launch_mma<128>(q, k, v, bias, out, b, hq, hkv, lq, lk, bias_heads, causal, scale, softcap, s);
    return (int)launch_mma<256>(q, k, v, bias, out, b, hq, hkv, lq, lk, bias_heads, causal, scale, softcap, s);
  }
  if (dtype == 0)
    return (int)launch_dh<float>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
  return (int)launch_dh<__nv_bfloat16>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
}

// The split-kv route with its softmax statistics: out (b, hq, lq, dh) f32
// (the normalised output, not rounded to q's type) and lse (b, hq, lq) f32,
// M + log L of each row, -inf where every logit the row sees is masked
// (M <= -1e29: positions past the decode position, or a row with no key).
// The arguments are repro_flash_attention's; only calls of the split-kv
// route (at most 8 packed rows a kv head) are taken. A model axis whose
// decode cache is split along the sequence merges the ranks' (out, lse).
int repro_flash_attention_lse(const void* q, const void* k, const void* v,
                              const float* bias, float* out, float* lse, int dtype, int b,
                              int hq, int hkv, int lq, int lk, int dh, int bias_heads,
                              int causal, float scale, float softcap, void* scratch,
                              void* stream) {
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv != 0 || lq < 0 || lk < 0 || dh < 1 ||
      dh > 256 || (bias != nullptr && bias_heads != hkv && bias_heads != hq) ||
      (dtype != 0 && dtype != 1) || (long long)b * hkv > 0x7fffffffLL || lse == nullptr ||
      !split_route(hq, hkv, lq))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || lq == 0) return (int)cudaSuccess;
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_split_rows<float>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
  return (int)launch_split_rows<__nv_bfloat16>(q, k, v, bias, out, lse, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, scratch, s);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
