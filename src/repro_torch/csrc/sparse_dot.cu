// Sparse-query fused retrieve for Hopper (sm_90a): (Q, kq) query codes against
// (N, k) fp32 candidate codes -> per-query top-n (norm-folded score, id).
//
// Replaces the TPU kernel
// repro/kernels/sparse_dot/kernel.py::fused_retrieve_sparse_q_pallas, which
// densifies an 8-row query panel on chip and walks the candidate axis
// serially for it.  At Q = 64 that is 8 blocks on a 132-SM card, each
// reading the whole catalog.  Here:
//
//   retrieve_tiles: grid (ceil(Q/BQ), S), BQ up to 64 query rows a block.
//     The block builds its query panel in shared memory, not dense but as
//     the (row, value) entries of each latent its queries hold, stored
//     contiguously per latent; each value is the row's slots of that
//     latent summed in slot order (as densify sums duplicates).  It then
//     streams its 1/S of the catalog in tiles of 256 candidates, one a
//     thread, with 16-byte loads of the codes.  For each code slot j in
//     order, the candidate adds v[j] * value to its sum for every entry of
//     latent idx[j], each product and sum rounded on its own
//     (__fmul_rn/__fadd_rn; the file builds with -fmad=false), and the
//     sum is multiplied by the candidate's 1/||c||: the plain PyTorch
//     version's arithmetic, so the two agree bit for bit (latents no query
//     holds would add exact zeros, so skipping them changes nothing).  One
//     warp a row merges the tile into the row's running top-n: the first
//     tile by n rounds of warp argmax, later ones by a ballot for the
//     scores above the bar (usually none), each inserted at its rank.
//     Candidates past the split's end are masked in the kernel; nothing is
//     padded.
//   retrieve_merge: one block a query merges the S sorted partial lists by
//     score descending, then id ascending (the rule of
//     core/retrieval.py::sharded_top_n), so ties go to the lowest id.
//
// The splits of a query share a bar: a score below the n-th best any
// split holds cannot be among the top n.  Splits advance in step, so the
// bar is seeded first by running both launches over a 32,768-candidate
// prefix of the catalog (catalogs of at least 4x that), whose n-th best
// score is a lower bound of the final one.  The (Q, N) score matrix never
// exists, and a request of up to 64 queries reads the catalog once.
//
// What bounds it: at Q = 64, N = 2^20, k = 32 the candidates and norms are
// 272.6 MB, 81.4 us at 3.35 TB/s, against 4.3 GFLOP (64.1 us at 67 TFLOP/s),
// so bytes.  This version takes about 9x that; a profile shows its time in
// the scan of retrieve_tiles, which does little arithmetic (a candidate
// meets about 12 query entries) and waits on its loads.  The wrapper
// (kernels/sparse_dot/kernel.py) checks 1 <= n <= 256 and picks BQ so the
// shared memory fits.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int TN = 256;                  // candidates per tile = threads
constexpr int THREADS = 256;
constexpr int MAX_N = 256;               // top-n cap
constexpr int MAX_LISTS = 4;             // split lists per merge thread: S <= 1024
constexpr unsigned FULL = 0xffffffffu;

// Selection order: live entries first, then score desc, id asc, slot asc.
__device__ __forceinline__ bool better(int ha, float sa, int ia, int la,
                                       int hb, float sb, int ib, int lb) {
  if (ha != hb) return ha > hb;
  if (sa != sb) return sa > sb;
  if (ia != ib) return ia < ib;
  return la < lb;
}

// Order-preserving map of a float to an unsigned key (0 sorts below every
// float), so atomicMax on keys is a max on scores and memset(0) is "none".
__device__ __forceinline__ unsigned score_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned k) {
  return k == 0u ? -INFINITY
                 : __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The query panel of a block: for each latent c, the (query row, value)
// pairs of the panel's queries that hold c, stored contiguously (CSR) so a
// code slot loads its entries independently; each value is the row's slots
// of that latent summed in slot order, as densify sums duplicates.  Latent
// c's entries are ent[c ? seg_end[c - 1] : 0 .. seg_end[c]).
constexpr int ROW_BITS = 7;
constexpr int MAX_ROWS = 64;             // rows a block: one bit each in `touched`
constexpr int SAMPLE = 32768;            // catalog prefix that seeds the bar

// The warp of one panel row merges the tile's scores of that row (s[m] for
// tile position 32*m + lane, id t0 + 32*m + lane) into the row's running
// top-n (best_v/best_i in shared memory, sorted by score desc, id asc).
//
// A score enters only if it is at least the row's bar shared by all splits
// (gbar: the best n-th score any split has held, so at least n scores
// beat anything below it) and beats this split's n-th best (the tile's ids
// exceed every id already in the list, so an equal score never enters).
// The first tile of a split fills its empty list by n rounds of warp
// argmax; later tiles insert each entering score at its rank, found with
// one warp sum, and shift the tail down.
__device__ void merge_row(float* best_v, int* best_i, const float (&s)[TN / 32],
                          int t0, bool first, int n, float gbar, int lane) {
  if (first) {
    unsigned used = 0;
#pragma unroll
    for (int m = 0; m < TN / 32; ++m)
      if (!(s[m] >= gbar) || s[m] == -INFINITY) used |= 1u << m;
    for (int r = 0; r < n; ++r) {
      int bh = 0, bi = INT_MAX, bm = 0;
      float bs = -INFINITY;
#pragma unroll
      for (int m = 0; m < TN / 32; ++m) {
        if (!((used >> m) & 1u) && !bh) { bh = 1; bs = s[m]; bi = t0 + 32 * m + lane; bm = m; }
        else if (!((used >> m) & 1u) && s[m] > bs) { bs = s[m]; bi = t0 + 32 * m + lane; bm = m; }
      }
      int wh = bh, wi = bi;
      float ws = bs;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int oh = __shfl_xor_sync(FULL, wh, off);
        const float os = __shfl_xor_sync(FULL, ws, off);
        const int oi = __shfl_xor_sync(FULL, wi, off);
        if (better(oh, os, oi, 0, wh, ws, wi, 0)) { wh = oh; ws = os; wi = oi; }
      }
      if (!wh) break;                     // nothing left: the rest stays empty
      if (wi == bi && bh) used |= 1u << bm;
      if (lane == 0) { best_v[r] = ws; best_i[r] = wi; }
    }
    __syncwarp();
    return;
  }
  float thr = best_v[n - 1];
#pragma unroll
  for (int m = 0; m < TN / 32; ++m) {
    unsigned bal = __ballot_sync(FULL, s[m] > thr && s[m] >= gbar);
    while (bal) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const float ns = __shfl_sync(FULL, s[m], src);
      if (!(ns > thr)) continue;          // the bar rose since the ballot
      const int ni = t0 + 32 * m + src;
      int ahead = 0;
      for (int p = lane; p < n; p += 32)
        ahead += better(1, best_v[p], best_i[p], 0, 1, ns, ni, 0);
      const int pos = __reduce_add_sync(FULL, ahead);
      float mv[MAX_N / 32];
      int mi[MAX_N / 32];
#pragma unroll
      for (int q = 0; q < MAX_N / 32; ++q) {
        const int p = lane + 32 * q;
        if (p > pos && p < n) { mv[q] = best_v[p - 1]; mi[q] = best_i[p - 1]; }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < MAX_N / 32; ++q) {
        const int p = lane + 32 * q;
        if (p > pos && p < n) { best_v[p] = mv[q]; best_i[p] = mi[q]; }
      }
      if (lane == 0) { best_v[pos] = ns; best_i[pos] = ni; }
      __syncwarp();
      thr = best_v[n - 1];
    }
  }
}

// Shared-memory layout of retrieve_tiles, in 4-byte words; the wrapper
// (kernels/sparse_dot/kernel.py::smem_bytes) mirrors it.  `scratch` holds
// the (bq, TN) tile sums while scoring and, while the panel is built, the
// latent counts and the unsorted entries.
__host__ __device__ inline int scratch_words(int bq, int kq, int h) {
  return (max(bq * TN, (h + 2) + 2 * bq * kq) + 1) & ~1;   // even: keeps int2 aligned
}

__global__ void __launch_bounds__(THREADS)
retrieve_tiles(const float* __restrict__ values, const int* __restrict__ indices,
               const float* __restrict__ inv_norms, const float* __restrict__ qv,
               const int* __restrict__ qi, float* __restrict__ part_v,
               int* __restrict__ part_i, unsigned* __restrict__ gbar_key, int N,
               int k, int Q, int kq, int h, int n, int bq, int per_split, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* touched_s = reinterpret_cast<unsigned long long*>(smem_raw);  // TN
  float* inv_s = reinterpret_cast<float*>(touched_s + TN);        // TN
  float* acc = inv_s + TN;                                         // scratch
  float* best_v = acc + scratch_words(bq, kq, h);                  // bq x n
  int* best_i = reinterpret_cast<int*>(best_v + bq * n);           // bq x n
  int2* ent = reinterpret_cast<int2*>(best_i + bq * n);            // bq*kq entries
  unsigned short* seg_end = reinterpret_cast<unsigned short*>(ent + bq * kq);  // h
  int* cnt = reinterpret_cast<int*>(acc);                          // h + 1, build only
  int2* raw = reinterpret_cast<int2*>(cnt + h + 1 + ((h + 1) & 1));  // build only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Q - q0);
  const int split = blockIdx.y, S = gridDim.y;

  for (int e = tid; e <= h; e += THREADS) cnt[e] = 0;
  for (int e = tid; e < bq * n; e += THREADS) { best_v[e] = -INFINITY; best_i[e] = INT_MAX; }
  __syncthreads();
  // One thread a (row, slot): the first slot of each latent in a row sums
  // the row's slots of that latent in slot order and counts an entry.
  for (int e = tid; e < rows * kq; e += THREADS) {
    const int r = e / kq, l = e % kq;
    const float* v = qv + (size_t)(q0 + r) * kq;
    const int* ix = qi + (size_t)(q0 + r) * kq;
    const int c = ix[l];
    bool first = (unsigned)c < (unsigned)h;
    for (int m = 0; m < l && first; ++m) first = ix[m] != c;
    raw[e] = make_int2(0, -1);
    if (!first) continue;
    float val = __fadd_rn(0.f, v[l]);
    for (int m = l + 1; m < kq; ++m)
      if (ix[m] == c) val = __fadd_rn(val, v[m]);
    raw[e] = make_int2(__float_as_int(val), (c << ROW_BITS) | r);
    atomicAdd(&cnt[c + 1], 1);
  }
  __syncthreads();
  // Inclusive scan of cnt[1..h]: cnt[c + 1] becomes the end of latent c's
  // segment and cnt[c] its start.  Warp w scans its chunk, then adds the
  // totals of the chunks before it.
  {
    __shared__ int chunk_total[THREADS / 32];
    const int per = (h + THREADS - 1) / THREADS;
    const int lo = 1 + tid * per, hi = min(h + 1, lo + per);
    int sum = 0;
    for (int c = lo; c < hi; ++c) sum += cnt[c];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) chunk_total[warp] = incl;
    __syncthreads();
    int base = incl - sum;
    for (int w = 0; w < warp; ++w) base += chunk_total[w];
    for (int c = lo; c < hi; ++c) { base += cnt[c]; cnt[c] = base; }
  }
  __syncthreads();
  // Place each entry in its latent's segment; cnt[c] advances from the
  // segment's start to its end.  The order inside a segment is free: its
  // entries belong to different rows.
  for (int e = tid; e < rows * kq; e += THREADS) {
    const int2 en = raw[e];
    if (en.y < 0) continue;
    const int pos = atomicAdd(&cnt[en.y >> ROW_BITS], 1);
    ent[pos] = make_int2(en.x, en.y & ((1 << ROW_BITS) - 1));
  }
  __syncthreads();
  for (int c = tid; c < h; c += THREADS) seg_end[c] = (unsigned short)cnt[c];
  __syncthreads();

  const long long start_ll = (long long)split * per_split;
  const int start = start_ll < N ? (int)start_ll : N;
  const int end = (long long)start + per_split < N ? start + per_split : N;
  for (int t0 = start; t0 < end; t0 += TN) {
    const int c = t0 + tid;
    float* mine = acc + tid;                      // this candidate's column
    unsigned long long touched = 0;               // rows with a sum in `mine`
    if (c < end) {
      // Score = sum over slots j in order of v[j] * q_r[idx[j]], each
      // product and sum rounded alone.  Latents no query holds add exact
      // zeros (a sum starts at +0 and never becomes -0), so they are
      // skipped, and a row no slot touched sums to +0.
      auto add = [&](int2 en, float v) {
        const unsigned long long bit = 1ull << en.y;
        const float prod = __fmul_rn(__int_as_float(en.x), v);
        mine[en.y * TN] = __fadd_rn((touched & bit) ? mine[en.y * TN] : 0.f, prod);
        touched |= bit;
      };
      auto slot = [&](float v, int ix) {
        if ((unsigned)ix >= (unsigned)h) return;
        int p = ix ? seg_end[ix - 1] : 0;
        const int e = seg_end[ix];
        for (; p + 1 < e; p += 2) {         // two rows at a time: independent loads
          const int2 e0 = ent[p], e1 = ent[p + 1];
          add(e0, v);
          add(e1, v);
        }
        if (p < e) add(ent[p], v);
      };
      if (vec) {  // k % 4 == 0 and 16-byte aligned rows: 16-byte loads
        const float4* cv = reinterpret_cast<const float4*>(values + (size_t)c * k);
        const int4* ci = reinterpret_cast<const int4*>(indices + (size_t)c * k);
        for (int j4 = 0; j4 < k / 4; ++j4) {
          const float4 v = __ldg(cv + j4);
          const int4 ix = __ldg(ci + j4);
          slot(v.x, ix.x); slot(v.y, ix.y); slot(v.z, ix.z); slot(v.w, ix.w);
        }
      } else {
        const float* cv = values + (size_t)c * k;
        const int* ci = indices + (size_t)c * k;
        for (int j = 0; j < k; ++j) slot(cv[j], ci[j]);
      }
      inv_s[tid] = inv_norms[c];
    }
    touched_s[tid] = touched;
    __syncthreads();
    // Warp w merges rows w, w + 8, ...: the score of a candidate is its
    // sum (+0 where untouched) times its 1/||c||, -inf past the split's end.
    unsigned long long tm[TN / 32];
    float inv[TN / 32];
#pragma unroll
    for (int m = 0; m < TN / 32; ++m) {
      tm[m] = touched_s[32 * m + lane];
      inv[m] = inv_s[32 * m + lane];
    }
    const int bar_row = warp + (THREADS / 32) * lane;   // lane i holds row w + 8i's bar
    const unsigned bar_keys = bar_row < rows ? *reinterpret_cast<volatile unsigned*>(
                                                   gbar_key + q0 + bar_row) : 0u;
    for (int r = warp; r < rows; r += THREADS / 32) {
      float sc[TN / 32];
#pragma unroll
      for (int m = 0; m < TN / 32; ++m) {
        const float sum = ((tm[m] >> r) & 1ull) ? acc[r * TN + 32 * m + lane] : 0.f;
        sc[m] = t0 + 32 * m + lane < end ? __fmul_rn(sum, inv[m]) : -INFINITY;
      }
      const float gbar = key_score(__shfl_sync(FULL, bar_keys, (r - warp) / (THREADS / 32)));
      merge_row(best_v + r * n, best_i + r * n, sc, t0, t0 == start, n, gbar, lane);
      const float nth = best_v[r * n + n - 1];
      if (lane == 0 && nth > gbar) atomicMax(gbar_key + q0 + r, score_key(nth));
    }
    __syncthreads();
  }
  for (int e = tid; e < rows * n; e += THREADS) {
    const int r = e / n, j = e % n;
    const size_t o = ((size_t)(q0 + r) * S + split) * n + j;
    part_v[o] = best_v[e];
    part_i[o] = best_i[e];
  }
}

__global__ void __launch_bounds__(256)
retrieve_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
               float* __restrict__ out_v, int* __restrict__ out_i, int S, int n) {
  __shared__ int w_h[8], w_i[8], w_l[8];
  __shared__ float w_s[8];
  __shared__ int win_list;
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pv = part_v + (size_t)q * S * n;
  const int* pi = part_i + (size_t)q * S * n;
  int head[MAX_LISTS], hh[MAX_LISTS], hi[MAX_LISTS];
  float hv[MAX_LISTS];
#pragma unroll
  for (int m = 0; m < MAX_LISTS; ++m) {
    const int s = tid + 256 * m;
    head[m] = 0;
    hh[m] = s < S;
    hv[m] = s < S ? pv[(size_t)s * n] : -INFINITY;
    hi[m] = s < S ? pi[(size_t)s * n] : INT_MAX;
  }
  for (int r = 0; r < n; ++r) {
    int bh = 0, bi = INT_MAX, bl = INT_MAX;
    float bs = -INFINITY;
#pragma unroll
    for (int m = 0; m < MAX_LISTS; ++m) {
      const int s = tid + 256 * m;
      if (better(hh[m], hv[m], hi[m], s, bh, bs, bi, bl)) {
        bh = hh[m]; bs = hv[m]; bi = hi[m]; bl = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oh = __shfl_xor_sync(FULL, bh, off);
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (better(oh, os, oi, ol, bh, bs, bi, bl)) { bh = oh; bs = os; bi = oi; bl = ol; }
    }
    if (lane == 0) { w_h[warp] = bh; w_s[warp] = bs; w_i[warp] = bi; w_l[warp] = bl; }
    __syncthreads();
    if (warp == 0) {
      bh = lane < 8 ? w_h[lane] : 0;
      bs = lane < 8 ? w_s[lane] : -INFINITY;
      bi = lane < 8 ? w_i[lane] : INT_MAX;
      bl = lane < 8 ? w_l[lane] : INT_MAX;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const int oh = __shfl_xor_sync(FULL, bh, off);
        const float os = __shfl_xor_sync(FULL, bs, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        const int ol = __shfl_xor_sync(FULL, bl, off);
        if (better(oh, os, oi, ol, bh, bs, bi, bl)) { bh = oh; bs = os; bi = oi; bl = ol; }
      }
      if (lane == 0) {
        out_v[(size_t)q * n + r] = bs;
        out_i[(size_t)q * n + r] = bi;
        win_list = bl;
      }
    }
    __syncthreads();
    const int wlist = win_list;
#pragma unroll
    for (int m = 0; m < MAX_LISTS; ++m) {
      if (tid + 256 * m == wlist) {
        head[m] += 1;
        const bool live = head[m] < n;
        hh[m] = live;
        hv[m] = live ? pv[(size_t)wlist * n + head[m]] : -INFINITY;
        hi[m] = live ? pi[(size_t)wlist * n + head[m]] : INT_MAX;
      }
    }
  }
}

// The bar of query q: the key of its n-th best score over the prefix.
__global__ void seed_bar(const float* __restrict__ out_v, unsigned* __restrict__ gbar_key,
                         int Q, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < Q && out_v[(size_t)q * n + n - 1] > -INFINITY)
    gbar_key[q] = max(gbar_key[q], score_key(out_v[(size_t)q * n + n - 1]));
}

cudaError_t scan(const float* values, const int* indices, const float* inv_norms,
                 const float* q_values, const int* q_indices, float* part_v, int* part_i,
                 unsigned* gbar_key, float* out_v, int* out_i, int N, int k, int Q,
                 int kq, int h, int n, int bq, int S, int vec, size_t smem,
                 cudaStream_t s) {
  const int per_split = (N + S - 1) / S;
  retrieve_tiles<<<dim3((Q + bq - 1) / bq, S), THREADS, smem, s>>>(
      values, indices, inv_norms, q_values, q_indices, part_v, part_i, gbar_key, N, k,
      Q, kq, h, n, bq, per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  retrieve_merge<<<Q, 256, 0, s>>>(part_v, part_i, out_v, out_i, S, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// values/indices (N, k), inv_norms (N,), q_values/q_indices (Q, kq); scratch
// part_v/part_i (Q, S, n) and gbar_key (Q,); out_v/out_i (Q, n).
// 1 <= bq <= 64 query rows a block, S <= 1024 splits, 1 <= n <= 256.
// Returns the first CUDA error, or 0.
int fused_retrieve_sparse_q_launch(const float* values, const int* indices,
                                   const float* inv_norms, const float* q_values,
                                   const int* q_indices, float* part_v, int* part_i,
                                   unsigned* gbar_key, float* out_v, int* out_i,
                                   int N, int k, int Q,
                                   int kq, int h, int n, int bq, int S, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAX_N || S < 1 || S > 256 * MAX_LISTS || bq < 1 ||
      bq > MAX_ROWS || (long long)bq * kq >= 65535)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)TN * 12
                      + ((size_t)scratch_words(bq, kq, h) + 2 * (size_t)bq * (n + kq)) * 4
                      + ((size_t)h * 2 + 3) / 4 * 4;
  cudaError_t err = cudaMemsetAsync(gbar_key, 0, (size_t)Q * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      retrieve_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Seed each query's bar with its n-th best score over a catalog prefix
  // (a lower bound of its final n-th best), so that the splits of the full
  // scan keep only what can still be among the top n.
  if (N >= 4 * SAMPLE) {
    err = scan(values, indices, inv_norms, q_values, q_indices, part_v, part_i,
               gbar_key, out_v, out_i, SAMPLE, k, Q, kq, h, n, bq,
               min(S, SAMPLE / TN), vec, smem, s);
    if (err != cudaSuccess) return err;
    seed_bar<<<(Q + 255) / 256, 256, 0, s>>>(out_v, gbar_key, Q, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return scan(values, indices, inv_norms, q_values, q_indices, part_v, part_i, gbar_key,
              out_v, out_i, N, k, Q, kq, h, n, bq, S, vec, smem, s);
}

const char* sparse_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
