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
// the cache) is bound by reading k and v.
//
// Design (simple and right first): the hq / hkv query heads that share a kv
// head are packed with their rows into one row space of g * lq rows, so a
// block owns 64 rows of one (batch, kv head) and every kv tile it stages
// serves all of them (decode: both query heads of a kv head in one block).
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
// all lie past the end of the row space skip the arithmetic (decode: one
// warp of eight works). Everything runs on the CUDA cores in f32 with
// accurate expf and tanhf; no atomics, so a launch is repeatable bit for bit.
// Later work: wgmma with bf16 operands, TMA-fed kv tiles, and split-kv for
// decode, where b * hkv = 16 blocks leave most SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;                       // threads that share a row pair
constexpr int kRowsPerThread = 2;
constexpr int kBQ = kThreads / kGroup * kRowsPerThread;  // 64 rows a block
constexpr int kBK = 32;                         // keys a kv tile
constexpr int kColsPerThread = kBK / kGroup;    // 4 logits per row a thread
constexpr float kMasked = -1e30f;

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

}  // namespace

extern "C" {

int repro_flash_attention_max_dh() { return 256; }

// q (b, hq, lq, dh), k and v (b, hkv, lk, dh), out (b, hq, lq, dh), all
// contiguous in one type: dtype 0 = f32, 1 = bf16. bias (b, bias_heads, lk)
// f32 or null, bias_heads = hkv or hq. Returns a cudaError_t.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          const float* bias, void* out, int dtype, int b, int hq,
                          int hkv, int lq, int lk, int dh, int bias_heads,
                          int causal, float scale, float softcap, void* stream) {
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv != 0 || lq < 0 || lk < 0 || dh < 1 ||
      dh > 256 || (bias != nullptr && bias_heads != hkv && bias_heads != hq) ||
      (dtype != 0 && dtype != 1) || (long long)b * hkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || lq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dh<float>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
  return (int)launch_dh<__nv_bfloat16>(q, k, v, bias, out, b, hq, hkv, lq, lk, dh, bias_heads, causal, scale, softcap, s);
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
