// Blocked weighted segment sum: K3 of the port.
//
// Replaces: src/repro/kernels/segment_sum.py:_segsum_kernel (segment_sum),
// always reached through repro.kernels.ops.blocked_segment_sum's fold.
//
// Computes sums[s, f] = sum over rows i with id_i == s of w_i * x[i, f] and
// mass[s] = sum of w_i over the same rows; ids outside [0, S) are dropped.
// The order of the sum is the reference's fixed tree: the rows fall into
// n_blocks contiguous blocks of nb = ceil(n / n_blocks) rows (row r in
// block r / nb, the reference's right-padding without the copy); a block's
// partial is the fold, in ascending row order from +0.0, of
// __fmul_rn(x, w) with __fadd_rn (never contracted to an FMA), and of w;
// the partials are added left to right in block order. So the bits are the
// CPU plain version's. No float atomics; integer atomics only count and
// place rows, which does not depend on their order.
//
// What bounds it on an H100: the bytes. It reads x, the ids and the weights
// once and writes (S, d) + (S,) floats, a handful of flops per byte. The TPU
// kernel contracts a one-hot (rows x segments) tile on the MXU, which is
// O(n * S * d) work; that is not carried over. What costs time on the card
// is the grouping of rows by segment, the dependent chain of each
// segment's fold, and the launches, so the design is about those. The
// products w * x of a run are independent of the order, so they are formed
// in parallel and staged in shared memory; only the adds run in order.
//
// Few segments (S <= 64, the k-means statistics: long runs, a handful of
// segments): no grouping. A block per (block b, segment s) walks block b's
// rows 256 at a time, each thread loading its row's id, weight and
// features a step ahead: a block-wide exclusive scan compacts the rows with
// id s in row order, their products go to shared memory, and one thread
// per feature (and one for the mass) folds them. A second tiny kernel adds
// the n_blocks partials of each segment in block order.
//
// Many segments (the prototype reduce, S ~ n / t; the KV compression): a
// counting grouping. hist counts the rows of each segment (integer
// atomics); scan turns the counts into run starts (tiles of 1024; the last
// tile block to finish scans the tile sums); place puts row r at
// atomicAdd(&start[id_r], 1), which leaves start[s] at the end of run s, so
// run s is [end(s - 1), end(s)). A run's order after placement is
// arbitrary, so fold first sorts each run: a group of G lanes per segment
// (4 up to d = 32, 32 above) loads its run (up to 2048 / (256 / G) rows)
// into shared memory and ranks each row by counting the smaller ones; then
// the G lanes fold the features G apart in that order, four rows' loads in
// flight, flushing the partial into the total where the block changes. A
// longer run is taken by the whole block once its groups are done: runs up
// to 2048 rows are sorted in shared memory (bitonic) and folded, narrow
// rows through staged products with a thread per feature, wide rows (d >
// 32: a recompressed KV head puts ~300 empty slots into one cluster) by
// every thread folding its own columns straight from the rows; a longer
// run walks all n rows in order, 256 at a time (bounded by n per such
// segment).
//
// An empty block's partial is +0.0; a fold that starts at +0.0 never yields
// -0.0 under round-to-nearest, so adding it or skipping it gives the same
// bits, and both paths just flush where the block changes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanTile = 1024;   // counts per scan tile (256 threads x 4)
constexpr int kChunk = 128;       // rows whose products are staged at once
constexpr int kCols = 32;         // feature columns staged per pass (+ the mass)
constexpr int kRareCap = 2048;    // longest run a block sorts in shared memory
constexpr int kGroupInts = 2048;  // a fold block's run buffers, each
constexpr int kUnroll = 4;        // rows whose loads are in flight

__device__ __forceinline__ long long load_id(const void* ids, int ids64,
                                             long long r) {
  return ids64 ? static_cast<const long long*>(ids)[r]
               : (long long)static_cast<const int*>(ids)[r];
}

// The fold of one column (a feature, or the mass) over rows in ascending
// order, given each row's block b: the partial is flushed into the total
// where the block changes.
struct Fold {
  float total = 0.f, part = 0.f;
  int blk = -1;
  __device__ __forceinline__ void add(float v, int b) {
    if (b != blk) {
      total = __fadd_rn(total, part);
      part = 0.f;
      blk = b;
    }
    part = __fadd_rn(part, v);
  }
  __device__ __forceinline__ float done() const { return __fadd_rn(total, part); }
};

// exclusive prefix of a block's values (every thread calls it); returns the
// thread's offset, *total the block's sum
template <int T>
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < T / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += t;
    }
    if (lane < T / 32) warp_sums[lane] = ws;  // inclusive
  }
  __syncthreads();
  const int off = (wid ? warp_sums[wid - 1] : 0) + inc - v;
  *total = warp_sums[T / 32 - 1];
  __syncthreads();  // warp_sums may be reused
  return off;
}

// shared memory of the block-wide fold: a chunk's products and blocks
struct Staged {
  float vals[kChunk][kCols + 1];
  int blk[kChunk];
};

// The block folds rows[0..cnt) (ascending, in shared memory), columns
// [f0, f0 + 32) and, on the pass f0 == 0, the mass: the products of a
// chunk are formed by all threads, then thread t (t <= 32) folds column t.
// Every thread of the block calls it.
__device__ __forceinline__ void fold_rows(const int* rows, int cnt,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w, int d,
                                          int f0, int nb, Staged& st, Fold& fo) {
  const int tid = threadIdx.x;
  const bool owner = tid < kCols ? f0 + tid < d : (tid == kCols && f0 == 0);
  for (int c0 = 0; c0 < cnt; c0 += kChunk) {
    const int m = min(kChunk, cnt - c0);
    for (int e = tid; e < m * (kCols + 1); e += kThreads) {
      const int i = e / (kCols + 1), t = e % (kCols + 1);
      const int row = rows[c0 + i];
      float v;
      if (t < kCols) {
        const int f = f0 + t;
        v = f < d ? __fmul_rn(x[(long long)row * d + f], w[row]) : 0.f;
      } else {
        v = w[row];
        st.blk[i] = row / nb;
      }
      st.vals[i][t] = v;
    }
    __syncthreads();
    if (owner) {
#pragma unroll 8
      for (int i = 0; i < m; ++i) fo.add(st.vals[i][tid], st.blk[i]);
    }
    __syncthreads();  // the chunk buffers are rewritten next
  }
}

// The block folds rows[0..cnt) (ascending, in shared memory) for wide
// rows (d > 32): thread t folds columns f0 + t and f0 + t + 256 straight
// from the rows (coalesced across the block), four rows' loads in flight,
// and thread 0 also the mass on the pass f0 == 0. No barrier inside.
__device__ __forceinline__ void fold_rows_direct(const int* rows, int cnt,
                                                 const float* __restrict__ x,
                                                 const float* __restrict__ w,
                                                 int d, int f0, int nb,
                                                 Fold (&fo)[2], Fold& fm) {
  const int tid = threadIdx.x;
  const bool mass = tid == 0 && f0 == 0;
  for (int k0 = 0; k0 < cnt; k0 += kUnroll) {
    int row[kUnroll];
    float wv[kUnroll], xv[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = k0 + u < cnt ? rows[k0 + u] : -1;
      wv[u] = row[u] >= 0 ? w[row[u]] : 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = f0 + tid + kThreads * c;
        xv[u][c] = (row[u] >= 0 && f < d) ? x[(long long)row[u] * d + f] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row[u] < 0) break;
      const int b = row[u] / nb;
      if (mass) fm.add(wv[u], b);
#pragma unroll
      for (int c = 0; c < 2; ++c) fo[c].add(__fmul_rn(xv[u][c], wv[u]), b);
    }
  }
}

__device__ __forceinline__ void write_direct(const Fold (&fo)[2], const Fold& fm,
                                             int f0, int d, float* sums_row,
                                             float* mass_at) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int f = f0 + tid + kThreads * c;
    if (f < d) sums_row[f] = fo[c].done();
  }
  if (tid == 0 && f0 == 0) *mass_at = fm.done();
}

// the results of the column threads of a block-wide fold
__device__ __forceinline__ void write_cols(const Fold& fo, int f0, int d,
                                           float* sums_row, float* mass_at) {
  const int tid = threadIdx.x;
  if (tid < kCols && f0 + tid < d) sums_row[f0 + tid] = fo.done();
  if (tid == kCols && f0 == 0) *mass_at = fo.done();
}

// ------------------------------------------------------------- few segments

// block (b, s): the partial of segment s over block b's rows ->
// part[(s * nblk + b) * (d + 1) + f], the mass at f = d. Thread t takes row
// base + t of each step of 256 rows; its id, weight and features are
// loaded a step ahead, so a step is one compaction and one fold.
__global__ void __launch_bounds__(kThreads)
    few_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const void* __restrict__ ids, int ids64, long long n, int d,
               int nb, int nblk, float* __restrict__ part) {
  __shared__ float vals[kThreads][kCols + 1];
  __shared__ int ws[kThreads / 32];
  const int tid = threadIdx.x, b = blockIdx.x, s = blockIdx.y;
  const long long r0 = (long long)b * nb;
  const long long r1 = min(n, r0 + nb);
  float* out = part + ((long long)s * nblk + b) * (d + 1);
  for (int f0 = 0; f0 < d; f0 += kCols) {
    const int nc = min(kCols, d - f0);
    const bool owner = tid < nc || (tid == kCols && f0 == 0);
    float total = 0.f;  // one block: the fold from +0.0 is its partial
    long long r = r0 + tid;
    bool in = r < r1;
    long long id = in ? load_id(ids, ids64, r) : -1;
    float wv = in ? w[r] : 0.f;
    float xv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) xv[j] = (in && j < nc) ? x[r * d + f0 + j] : 0.f;
    for (long long base = r0; base < r1; base += kThreads) {
      const int hit = id == s;
      float pv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[j] = __fmul_rn(xv[j], wv);
      const float pw = wv;
      r = base + kThreads + tid;  // the next step's row, in flight meanwhile
      in = r < r1;
      id = in ? load_id(ids, ids64, r) : -1;
      wv = in ? w[r] : 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) xv[j] = (in && j < nc) ? x[r * d + f0 + j] : 0.f;
      int cnt;
      const int pos = block_exclusive<kThreads>(hit, ws, &cnt);
      if (hit) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < nc) vals[pos][j] = pv[j];
        vals[pos][kCols] = pw;
      }
      __syncthreads();
      if (owner) {
#pragma unroll 8
        for (int i = 0; i < cnt; ++i) total = __fadd_rn(total, vals[i][tid]);
      }
      __syncthreads();  // vals is rewritten by the next step
    }
    if (tid < nc) out[f0 + tid] = total;
    if (tid == kCols && f0 == 0) out[d] = total;
  }
}

// part (S, nblk, d + 1) -> sums, mass: the partials added in block order
__global__ void combine_kernel(const float* __restrict__ part,
                               float* __restrict__ sums,
                               float* __restrict__ mass, int num_segments,
                               int d, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)num_segments * (d + 1)) return;
  const long long s = i / (d + 1);
  const int f = (int)(i % (d + 1));
  float total = 0.f;
  for (int b = 0; b < nblk; ++b)
    total = __fadd_rn(total, part[(s * nblk + b) * (d + 1) + f]);
  if (f < d) sums[s * d + f] = total;
  else mass[s] = total;
}

// ------------------------------------------------------------ many segments

__global__ void hist_kernel(const void* __restrict__ ids, int ids64,
                            long long n, int num_segments, int* __restrict__ cnt) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const long long id = load_id(ids, ids64, r);
    if (id >= 0 && id < num_segments) atomicAdd(&cnt[id], 1);
  }
}

// cnt (len) -> in place, the exclusive prefix within its tile of 1024;
// tile[t] -> the exclusive prefix of the tile sums (the last block to
// finish scans them; done counts the finished blocks)
__global__ void __launch_bounds__(kThreads)
    scan_kernel(int* __restrict__ cnt, int len, int* __restrict__ tile,
                int ntiles, int* __restrict__ done) {
  __shared__ int ws[kThreads / 32];
  __shared__ bool last;
  const long long i0 = (long long)blockIdx.x * kScanTile + threadIdx.x * 4;
  int v[4], sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = i0 + j < len ? cnt[i0 + j] : 0;
    sum += v[j];
  }
  int total;
  int off = block_exclusive<kThreads>(sum, ws, &total);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j < len) cnt[i0 + j] = off;
    off += v[j];
  }
  if (threadIdx.x == 0) {
    tile[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;  // the whole block
  __threadfence();
  int carry = 0;
  for (int base = 0; base < ntiles; base += kThreads) {
    const int t = base + threadIdx.x;
    const int tv = t < ntiles ? ((volatile int*)tile)[t] : 0;
    int tt;
    const int toff = block_exclusive<kThreads>(tv, ws, &tt);
    if (t < ntiles) tile[t] = carry + toff;
    carry += tt;
  }
}

// row r to start[id_r] (counted up as the run fills): start[s] ends at the
// end of run s
__global__ void place_kernel(const void* __restrict__ ids, int ids64, long long n,
                             int num_segments, int* __restrict__ loc,
                             const int* __restrict__ tile, int* __restrict__ perm) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const long long id = load_id(ids, ids64, r);
    if (id >= 0 && id < num_segments)
      perm[atomicAdd(&loc[id], 1) + tile[id / kScanTile]] = (int)r;
  }
}

__device__ __forceinline__ int run_end(const int* loc, const int* tile, long long s) {
  return loc[s] + tile[s / kScanTile];
}

// G lanes per segment; NC features a lane per pass
template <int G, int NC>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const void* __restrict__ ids, int ids64, long long n,
                const int* __restrict__ loc, const int* __restrict__ tile,
                const int* __restrict__ perm, int num_segments, int d, int nb,
                float* __restrict__ sums, float* __restrict__ mass) {
  constexpr int kGroups = kThreads / G;
  constexpr int kShort = kGroupInts / kGroups;  // longest run of the group path
  struct Short {
    int buf[kGroups][kShort];
    int srt[kGroups][kShort];
  };
  struct Rare {
    int rows[kRareCap];
    Staged st;
  };
  union Smem {
    Short sh;
    Rare rare;
  };
  __shared__ Smem sm;
  __shared__ int rare_n;
  __shared__ int rare_s[kGroups];
  __shared__ int ws[kThreads / 32];
  const int tid = threadIdx.x, gi = tid / G, lane = tid % G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << (G % 32)) - 1u) << ((tid % 32) / G * G));
  if (tid == 0) rare_n = 0;
  __syncthreads();

  const long long s = (long long)blockIdx.x * kGroups + gi;
  if (s < num_segments) {
    const int lo = s ? run_end(loc, tile, s - 1) : 0;
    const int L = run_end(loc, tile, s) - lo;
    if (L > kShort) {
      if (lane == 0) rare_s[atomicAdd(&rare_n, 1)] = (int)s;
    } else {
      int* buf = sm.sh.buf[gi];
      int* srt = sm.sh.srt[gi];
      for (int i = lane; i < L; i += G) buf[i] = perm[lo + i];
      __syncwarp(gmask);
      for (int i = lane; i < L; i += G) {  // rank = rows before it; rows differ
        const int e = buf[i];
        int r = 0;
        for (int j = 0; j < L; ++j) r += buf[j] < e;
        srt[r] = e;
      }
      __syncwarp(gmask);
      for (int f0 = 0; f0 < d; f0 += G * NC) {
        Fold fx[NC], fm;
        for (int k0 = 0; k0 < L; k0 += kUnroll) {
          int row[kUnroll];
          float wv[kUnroll], xv[kUnroll][NC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            row[u] = k0 + u < L ? srt[k0 + u] : -1;
            wv[u] = row[u] >= 0 ? w[row[u]] : 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = f0 + lane + G * c;
              xv[u][c] = (row[u] >= 0 && f < d) ? x[(long long)row[u] * d + f] : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (row[u] < 0) break;
            const int b = row[u] / nb;
            fm.add(wv[u], b);
#pragma unroll
            for (int c = 0; c < NC; ++c) fx[c].add(__fmul_rn(xv[u][c], wv[u]), b);
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int f = f0 + lane + G * c;
          if (f < d) sums[s * d + f] = fx[c].done();
        }
        if (f0 == 0 && lane == 0) mass[s] = fm.done();
      }
    }
  }
  __syncthreads();  // the group buffers are free; the rare list is complete

  // the runs longer than kShort: the whole block, one segment at a time
  const int nr = rare_n;
  for (int i = 0; i < nr; ++i) {
    const long long sr = rare_s[i];
    const int lo = sr ? run_end(loc, tile, sr - 1) : 0;
    const int L = run_end(loc, tile, sr) - lo;
    int* rows = sm.rare.rows;
    if (L <= kRareCap) {
      int P = 1;
      while (P < L) P <<= 1;
      for (int k = tid; k < P; k += kThreads) rows[k] = k < L ? perm[lo + k] : 0x7fffffff;
      __syncthreads();
      for (int kk = 2; kk <= P; kk <<= 1) {  // bitonic sort, ascending
        for (int j = kk >> 1; j > 0; j >>= 1) {
          for (int a = tid; a < P; a += kThreads) {
            const int b = a ^ j;
            if (b > a) {
              const int va = rows[a], vb = rows[b];
              if ((va > vb) == ((a & kk) == 0)) {
                rows[a] = vb;
                rows[b] = va;
              }
            }
          }
          __syncthreads();
        }
      }
      if (d > kCols) {
        for (int f0 = 0; f0 < d; f0 += 2 * kThreads) {
          Fold fo[2], fm;
          fold_rows_direct(rows, L, x, w, d, f0, nb, fo, fm);
          write_direct(fo, fm, f0, d, sums + sr * d, mass + sr);
        }
      } else {
        Fold fo;
        fold_rows(rows, L, x, w, d, 0, nb, sm.rare.st, fo);
        write_cols(fo, 0, d, sums + sr * d, mass + sr);
      }
    } else {
      // walk every row in order, 256 at a time, compacting this segment's
      const int step = d > kCols ? 2 * kThreads : kCols;
      for (int f0 = 0; f0 < d; f0 += step) {
        Fold fo, fo2[2], fm;
        for (long long base = 0; base < n; base += kThreads) {
          const long long r = base + tid;
          const int hit = r < n && load_id(ids, ids64, r) == sr;
          int total;
          const int pos = block_exclusive<kThreads>(hit, ws, &total);
          if (hit) rows[pos] = (int)r;
          __syncthreads();
          if (d > kCols) {
            fold_rows_direct(rows, total, x, w, d, f0, nb, fo2, fm);
            __syncthreads();  // rows is rewritten by the next step
          } else {
            fold_rows(rows, total, x, w, d, f0, nb, sm.rare.st, fo);
          }
        }
        if (d > kCols) write_direct(fo2, fm, f0, d, sums + sr * d, mass + sr);
        else write_cols(fo, f0, d, sums + sr * d, mass + sr);
      }
    }
    __syncthreads();  // rows is reused by the next segment
  }
}

template <int G, int NC>
void launch_fold(const float* x, const float* w, const void* ids, int ids64,
                 long long n, const int* loc, const int* tile, const int* perm,
                 int S, int d, int nb, float* sums, float* mass, cudaStream_t st) {
  constexpr int kGroups = kThreads / G;
  const int blocks = (int)(((long long)S + kGroups - 1) / kGroups);
  fold_kernel<G, NC><<<blocks, kThreads, 0, st>>>(x, w, ids, ids64, n, loc, tile,
                                                  perm, S, d, nb, sums, mass);
}

long long n_tiles(int S) { return ((long long)S + kScanTile - 1) / kScanTile; }

// int32 scratch of the many-segments path: the scan's done count, the
// counts (S), the tile sums, perm (n)
long long many_scratch_ints(long long n, int S) { return 1 + (long long)S + n_tiles(S) + n; }

}  // namespace

extern "C" {

// Bytes of scratch repro_segment_sum_f32 needs: mode 0 (few segments) the
// partials, (S, nblk, d + 1) f32; mode 1 (many) int32 counts and rows.
long long repro_segment_sum_scratch_bytes(long long n, int num_segments, int d,
                                          int nblk, int mode) {
  if (mode == 0) return (long long)num_segments * nblk * (d + 1) * 4;
  return many_scratch_ints(n, num_segments) * 4;
}

// x (n, d) f32, w (n,) f32, ids (n,) i32 or i64 (ids64), rows per block nb,
// nblk blocks (nb * nblk >= n), mode 0 few / 1 many, scratch of
// repro_segment_sum_scratch_bytes -> sums (S, d) f32, mass (S,) f32.
// Returns a cudaError_t.
int repro_segment_sum_f32(const float* x, const float* w, const void* ids,
                          int ids64, float* sums, float* mass, long long n,
                          int num_segments, int d, long long nb, int nblk,
                          int mode, void* scratch, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || num_segments < 1 || d < 1 || nb < 1 ||
      nblk < 1 || nb * nblk < n || nblk > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbi = (int)(nb < n ? nb : n);  // a block never holds more than n rows
  cudaError_t err;
  if (mode == 0) {
    if (num_segments > 65535) return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(scratch);
    few_kernel<<<dim3(nblk, num_segments), kThreads, 0, st>>>(x, w, ids, ids64, n, d,
                                                             nbi, nblk, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long outs = (long long)num_segments * (d + 1);
    combine_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
        part, sums, mass, num_segments, d, nblk);
    return (int)cudaGetLastError();
  }
  const int S = num_segments;
  int* done = static_cast<int*>(scratch);
  int* loc = done + 1;  // S counts, then run starts, then run ends
  int* tile = loc + S;
  int* perm = tile + n_tiles(S);
  if ((err = cudaMemsetAsync(done, 0, (size_t)(S + 1) * 4, st)) != cudaSuccess)
    return (int)err;
  const long long want_blocks = (n + 255) / 256;
  const int rows_blocks = (int)(want_blocks < 132 * 16 ? want_blocks : 132 * 16);
  hist_kernel<<<rows_blocks, 256, 0, st>>>(ids, ids64, n, S, loc);
  scan_kernel<<<(unsigned)n_tiles(S), kThreads, 0, st>>>(loc, S, tile,
                                                         (int)n_tiles(S), done);
  place_kernel<<<rows_blocks, 256, 0, st>>>(ids, ids64, n, S, loc, tile, perm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (d <= 4)
    launch_fold<4, 1>(x, w, ids, ids64, n, loc, tile, perm, S, d, nbi, sums, mass, st);
  else if (d <= 8)
    launch_fold<4, 2>(x, w, ids, ids64, n, loc, tile, perm, S, d, nbi, sums, mass, st);
  else if (d <= 16)
    launch_fold<4, 4>(x, w, ids, ids64, n, loc, tile, perm, S, d, nbi, sums, mass, st);
  else if (d <= 32)
    launch_fold<4, 8>(x, w, ids, ids64, n, loc, tile, perm, S, d, nbi, sums, mass, st);
  else
    launch_fold<32, 8>(x, w, ids, ids64, n, loc, tile, perm, S, d, nbi, sums, mass, st);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
