// Sparse-query fused retrieves for Hopper (sm_90a): (Q, kq) query codes
// against (N, k) candidate codes -> per-query top-n (norm-folded score, id).
// One kernel body, templated on the candidate format, replaces three TPU
// kernels of repro/kernels/sparse_dot/kernel.py:
//
//   FMT_F32   fp32 values, int32 indices:
//             fused_retrieve_sparse_q_pallas (:379).
//   FMT_DEQ   int8 values, int16/int32 indices, f32 row scales; each value
//             dequantized as float(q) * scale (one f32 multiply, the
//             `_dequant_tile` of :440), int16 indices widened by & 0xFFFF,
//             then scored exactly as FMT_F32, so the result is bit-identical
//             to FMT_F32 over the dequantized index:
//             fused_retrieve_quantized_sparse_q_pallas (:550).
//   FMT_INT8  the same codes scored in int8: each query row's densified
//             values are quantized (amax / 127 floored at 1e-12, round half
//             to even, clip to +-127), int8 x int8 products accumulate
//             exactly in int32, and the score is one f32 rescale,
//             (f32(acc) * q_scale) * (scale * 1/||c||):
//             fused_retrieve_quantized_mxu_sparse_q_pallas (:755).
//
// Launches of one request:
//
//   build_panel: one block of 1024 threads a query panel of up to 64 rows.  It builds the
//     panel in device memory as CSR: for each latent c, the (value, row)
//     entries of the panel's rows that hold c, ent[seg[c] .. seg[c + 1]);
//     each value is the row's slots of c summed in slot order (as densify
//     sums duplicates), quantized per row for FMT_INT8.  Nothing of it is
//     proportional to h in shared memory: seg has h + 1 entries in device
//     memory, and the scan copies it to shared memory only where it fits.
//   retrieve_tiles: grid (panels, S).  The block copies its panel's entries
//     (and seg where it fits) to shared memory and streams its 1/S of the
//     catalog in tiles of 256 candidates, one a thread.  For each code slot
//     j in order, the candidate adds v[j] * value to its sum for every entry
//     of latent idx[j], each product and sum rounded on its own
//     (__fmul_rn/__fadd_rn; the file builds with -fmad=false), and the sum
//     is multiplied by 1/||c||: the plain PyTorch version's arithmetic, so
//     the two agree bit for bit (latents no query holds would add exact
//     zeros, so skipping them changes nothing).  One warp a row merges the
//     tile into the row's running top-n: the first tile by rounds of warp
//     argmax, later ones by a ballot for the scores above the bar (usually
//     none), each inserted at its rank.  The running lists live in shared
//     memory where bq * n of them fit, else in the (Q, S, n) partial lists
//     in device memory, so n is bounded by the catalog alone.
//   retrieve_merge: one block a query merges the S sorted partial lists by
//     score descending, then id ascending (the rule of
//     core/retrieval.py::sharded_top_n), so ties go to the lowest id.
//
// Order: scores compare by a total order in which NaN ranks above every
// number (lax.top_k's order; the plain version's stable sort agrees), so a
// NaN query row ranks as on the CPU.
//
// The splits of a query share a bar: a score below the n-th best any split
// holds cannot be among the top n.  Splits advance in step, so the bar is
// seeded first by running both scan launches over a 32,768-candidate prefix
// of the catalog (catalogs of at least 4x that, n at most a quarter of it),
// whose n-th best score is a lower bound of the final one.  The (Q, N)
// score matrix never exists, and a request of up to 64 queries reads the
// catalog once.
//
// What bounds it: at Q = 64, N = 2^20, k = 32 the fp32 candidates and norms
// are 272.6 MB, 81.4 us at 3.35 TB/s, and the quantized ones (1 + 2) * 32
// + 4 + 4 = 104 B an item, 109.1 MB or 32.6 us, against 4.3 G operations
// (64.1 us at 67 TFLOP/s fp32), so bytes for fp32 and about even for the
// quantized formats.  A profile of the fp32 version shows its time in the
// scan, which does little arithmetic (a candidate meets about 12 query
// entries) and waits on its loads.  The wrapper
// (kernels/sparse_dot/kernel.py) picks the rows a block, where the lists
// and seg live, and the splits.
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int TN = 256;                  // candidates per tile = threads
constexpr int THREADS = 256;
constexpr int MAX_ROWS = 64;             // rows a block: one bit each in `touched`
constexpr int MAX_LISTS = 4;             // split lists per merge thread: S <= 1024
constexpr int SAMPLE = 32768;            // catalog prefix that seeds the bar
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0u;          // below the key of every score

enum { FMT_F32 = 0, FMT_DEQ = 1, FMT_INT8 = 2 };

// Order-preserving map of a score to an unsigned key: NaN above +inf
// (lax.top_k's order), -0 equal to +0, every key above NO_KEY, so
// atomicMax on keys is a max on scores and memset(0) is "no bar".
__device__ __forceinline__ unsigned okey(float f) {
  if (f != f) return 0xffffffffu;
  const unsigned b = f == 0.f ? 0u : __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Selection order: key desc, id asc, list asc.
__device__ __forceinline__ bool better(unsigned ka, int ia, int la,
                                       unsigned kb, int ib, int lb) {
  if (ka != kb) return ka > kb;
  if (ia != ib) return ia < ib;
  return la < lb;
}

template <int FMT> struct Val { typedef float T; };
template <> struct Val<FMT_INT8> { typedef int T; };

// Shared-memory layout of retrieve_tiles, in bytes (the segment starts as
// 16-bit values, where they live there); the wrapper
// (kernels/sparse_dot/kernel.py::smem_bytes) mirrors it.
struct Layout {
  long long acc, qs, best, ent, seg, total;
};
__host__ __device__ inline Layout layout(int bq, long long n, int kq, int h,
                                         int lists_smem, int seg_smem) {
  Layout L;
  L.acc = TN * 12;                                  // touched bits, candidate factors
  L.qs = L.acc + (long long)bq * TN * 4;            // (bq, TN) tile sums
  L.best = L.qs + (((long long)bq * 4 + 7) & ~7LL); // per-row query scales
  L.ent = L.best + (lists_smem ? (long long)bq * n * 8 : 0);
  L.seg = L.ent + (long long)bq * kq * 8;
  L.total = L.seg + (seg_smem ? (((long long)h + 1) * 2 + 3) / 4 * 4 : 0);
  return L;
}

// The warp of one panel row merges the tile's scores of that row (s[m] for
// tile position 32*m + lane, id t0 + 32*m + lane) into the row's running
// top-n (best_v/best_i, in shared or device memory, sorted by key desc, id
// asc, unfilled places (-inf, INT_MAX)).
//
// A score enters only if its key is at least the row's bar shared by all
// splits (gbar: the best n-th key any split has held) and beats this
// split's n-th best (the tile's ids exceed every id already in the list,
// so an equal score never enters); -inf (past the split's end) never
// enters.  The first tile of a split fills its empty list by rounds of warp
// argmax; later tiles insert each entering score at its rank, found with
// one warp sum, and shift the tail down 32 places at a time from its end.
__device__ void merge_row(float* best_v, int* best_i, const float (&s)[TN / 32],
                          int t0, bool first, int n, unsigned gbar, int lane) {
  unsigned key[TN / 32];
#pragma unroll
  for (int m = 0; m < TN / 32; ++m) key[m] = s[m] == -INFINITY ? NO_KEY : okey(s[m]);
  if (first) {
    unsigned used = 0;
#pragma unroll
    for (int m = 0; m < TN / 32; ++m)
      if (key[m] == NO_KEY || key[m] < gbar) used |= 1u << m;
    for (int r = 0; r < n; ++r) {
      unsigned bk = NO_KEY;
      int bi = INT_MAX, bm = 0;
      float bs = -INFINITY;
#pragma unroll
      for (int m = 0; m < TN / 32; ++m)
        if (!((used >> m) & 1u) && key[m] > bk) {
          bk = key[m]; bs = s[m]; bi = t0 + 32 * m + lane; bm = m;
        }
      unsigned wk = bk;
      int wi = bi;
      float ws = bs;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned ok = __shfl_xor_sync(FULL, wk, off);
        const int oi = __shfl_xor_sync(FULL, wi, off);
        const float os = __shfl_xor_sync(FULL, ws, off);
        if (better(ok, oi, 0, wk, wi, 0)) { wk = ok; wi = oi; ws = os; }
      }
      if (wk == NO_KEY) break;            // nothing left: the rest stays unfilled
      if (bk != NO_KEY && wi == bi) used |= 1u << bm;
      if (lane == 0) { best_v[r] = ws; best_i[r] = wi; }
    }
    __syncwarp();
    return;
  }
  unsigned tk = okey(best_v[n - 1]);
#pragma unroll
  for (int m = 0; m < TN / 32; ++m) {
    unsigned bal = __ballot_sync(FULL, key[m] > tk && key[m] >= gbar);
    while (bal) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const unsigned nk = __shfl_sync(FULL, key[m], src);
      const float ns = __shfl_sync(FULL, s[m], src);
      if (!(nk > tk)) continue;           // the list's end rose since the ballot
      const int ni = t0 + 32 * m + src;
      int ahead = 0;
      for (int p = lane; p < n; p += 32)
        ahead += better(okey(best_v[p]), best_i[p], 0, nk, ni, 0);
      const int pos = __reduce_add_sync(FULL, ahead);
      for (int top = n - 1; top > pos; top -= 32) {
        const int p = top - lane;
        const bool move = p > pos;
        float v = 0.f;
        int i = 0;
        if (move) { v = best_v[p - 1]; i = best_i[p - 1]; }
        __syncwarp();
        if (move) { best_v[p] = v; best_i[p] = i; }
        __syncwarp();
      }
      if (lane == 0) { best_v[pos] = ns; best_i[pos] = ni; }
      __syncwarp();
      tk = okey(best_v[n - 1]);
    }
  }
}

// One block of 1024 threads a query panel: the CSR panel in device
// memory.  cnt (the latent counts) and seg hold h + 1 ints a panel, raw
// and ent bq * kq (value, row / latent) pairs.  For FMT_INT8 each
// row's values are quantized by the arithmetic of
// core/quantized_codes.py::quantize_rows, its scale kept in qscale.
constexpr int BUILD_THREADS = 1024;

template <bool QUANT>
__global__ void __launch_bounds__(BUILD_THREADS)
build_panel(const float* __restrict__ qv, const int* __restrict__ qi, int Q, int kq,
            int h, int bq, int* __restrict__ cnt_g, int* __restrict__ seg_g,
            int2* __restrict__ raw_g, int2* __restrict__ ent_g,
            float* __restrict__ qscale) {
  __shared__ int chunk_total[BUILD_THREADS / 32];
  const int panel = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = panel * bq, rows = min(bq, Q - q0);
  int* cnt = cnt_g + (size_t)panel * (h + 1);
  int* seg = seg_g + (size_t)panel * (h + 1);
  int2* raw = raw_g + (size_t)panel * bq * kq;
  int2* ent = ent_g + (size_t)panel * bq * kq;
  for (int c = tid; c <= h; c += BUILD_THREADS) cnt[c] = 0;
  __syncthreads();
  // One thread a (row, slot): the first slot of each latent in a row sums
  // the row's slots of that latent in slot order and counts an entry.
  for (int e = tid; e < rows * kq; e += BUILD_THREADS) {
    const int r = e / kq, l = e % kq;
    const float* v = qv + (size_t)(q0 + r) * kq;
    const int* ix = qi + (size_t)(q0 + r) * kq;
    const int c = ix[l];
    bool first = (unsigned)c < (unsigned)h;
    for (int m = 0; m < l && first; ++m) first = ix[m] != c;
    if (!first) { raw[e] = make_int2(0, -1); continue; }
    float val = __fadd_rn(0.f, v[l]);
    for (int m = l + 1; m < kq; ++m)
      if (ix[m] == c) val = __fadd_rn(val, v[m]);
    raw[e] = make_int2(__float_as_int(val), c);
    atomicAdd(&cnt[c + 1], 1);
  }
  __syncthreads();
  if (QUANT) {
    // One warp a row: amax of |value| (NaN propagates, as jnp.max and
    // torch.amax do), scale = max(amax / 127, 1e-12), q = clip(rint(v /
    // scale), +-127).  A NaN value converts to 0; its row's scale is NaN,
    // so all of its scores are NaN either way.
    const float nan = __int_as_float(0x7fc00000);
    for (int r = warp; r < rows; r += BUILD_THREADS / 32) {
      float amax = 0.f;
      for (int l = lane; l < kq; l += 32) {
        const int2 en = raw[r * kq + l];
        if (en.y < 0) continue;
        const float a = fabsf(__int_as_float(en.x));
        amax = (a != a || amax != amax) ? nan : fmaxf(amax, a);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(FULL, amax, off);
        amax = (o != o || amax != amax) ? nan : fmaxf(amax, o);
      }
      float scale = __fdiv_rn(amax, 127.f);
      if (scale == scale) scale = fmaxf(scale, 1e-12f);
      if (lane == 0) qscale[q0 + r] = scale;
      for (int l = lane; l < kq; l += 32) {
        int2 en = raw[r * kq + l];
        if (en.y < 0) continue;
        const int q = __float2int_rn(__fdiv_rn(__int_as_float(en.x), scale));
        en.x = min(127, max(-127, q));
        raw[r * kq + l] = en;
      }
    }
    __syncthreads();
  }
  // Inclusive scan of cnt[1..h]: cnt[c + 1] becomes the end of latent c's
  // segment and cnt[c] its start.  Thread t scans its chunk, then adds the
  // totals of the chunks before it.
  {
    const int per = (h + BUILD_THREADS - 1) / BUILD_THREADS;
    const int lo = min(h + 1, 1 + tid * per), hi = min(h + 1, lo + per);
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
  for (int c = tid; c <= h; c += BUILD_THREADS) seg[c] = cnt[c];
  __syncthreads();
  // Place each entry in its latent's segment; cnt[c] advances from the
  // segment's start.  The order inside a segment is free: its entries
  // belong to different rows.
  for (int e = tid; e < rows * kq; e += BUILD_THREADS) {
    const int2 en = raw[e];
    if (en.y < 0) continue;
    const int pos = atomicAdd(&cnt[en.y], 1);
    ent[pos] = make_int2(en.x, e / kq);
  }
}

// acc + ex * v: ex is a panel entry's value (f32 bits, or the int8 code
// for FMT_INT8), each product and sum rounded alone for the f32 formats.
template <int FMT>
__device__ __forceinline__ typename Val<FMT>::T mac(typename Val<FMT>::T acc, int ex,
                                                    typename Val<FMT>::T v) {
  if constexpr (FMT == FMT_INT8) return acc + ex * v;
  else return __fadd_rn(acc, __fmul_rn(__int_as_float(ex), v));
}

__device__ __forceinline__ int widen(int ix) { return ix; }
__device__ __forceinline__ int widen(short ix) { return (int)(unsigned short)ix; }

template <typename IT> struct Idx4;
template <> struct Idx4<int> {
  __device__ static int4 load(const int* p) { return __ldg(reinterpret_cast<const int4*>(p)); }
};
template <> struct Idx4<short> {
  __device__ static short4 load(const short* p) {
    return __ldg(reinterpret_cast<const short4*>(p));
  }
};

template <int FMT, typename IT>
__global__ void __launch_bounds__(THREADS)
retrieve_tiles(const void* __restrict__ values_, const IT* __restrict__ indices,
               const float* __restrict__ scales, const float* __restrict__ inv_norms,
               const int* __restrict__ seg_g, const int2* __restrict__ ent_g,
               const float* __restrict__ qscale, float* __restrict__ part_v,
               int* __restrict__ part_i, unsigned* __restrict__ gbar_key, int N, int k,
               int Q, int kq, int h, int n, int bq, int per_split, int vec,
               int lists_smem, int seg_smem) {
  typedef typename Val<FMT>::T V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(bq, n, kq, h, lists_smem, seg_smem);
  unsigned long long* touched_s = reinterpret_cast<unsigned long long*>(smem_raw);  // TN
  float* cf_s = reinterpret_cast<float*>(smem_raw + TN * 8);       // TN candidate factors
  V* acc = reinterpret_cast<V*>(smem_raw + L.acc);                 // bq x TN
  float* qs_s = reinterpret_cast<float*>(smem_raw + L.qs);         // bq
  int2* ent = reinterpret_cast<int2*>(smem_raw + L.ent);           // the panel's entries
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int panel = blockIdx.x, q0 = panel * bq;
  const int rows = min(bq, Q - q0);
  const int split = blockIdx.y, S = gridDim.y;

  // Latent c's entries are ent[seg(c) .. seg(c + 1)): segment starts from
  // a 16-bit copy in shared memory where it fits (the panel has fewer than
  // 65,536 entries), else from device memory.
  const int* seg_p = seg_g + (size_t)panel * (h + 1);
  const int n_ent = seg_p[h];
  const int2* ent_p = ent_g + (size_t)panel * bq * kq;
  for (int e = tid; e < n_ent; e += THREADS) ent[e] = ent_p[e];
  unsigned short* seg_s = reinterpret_cast<unsigned short*>(smem_raw + L.seg);
  if (seg_smem)
    for (int c = tid; c <= h; c += THREADS) seg_s[c] = (unsigned short)seg_p[c];
  auto seg = [&](int c) -> int { return seg_smem ? (int)seg_s[c] : __ldg(seg_p + c); };
  float* lists_v = reinterpret_cast<float*>(smem_raw + L.best);
  int* lists_i = reinterpret_cast<int*>(lists_v + (lists_smem ? (size_t)bq * n : 0));
  auto row_v = [&](int r) -> float* {
    return lists_smem ? lists_v + (size_t)r * n : part_v + ((size_t)(q0 + r) * S + split) * n;
  };
  auto row_i = [&](int r) -> int* {
    return lists_smem ? lists_i + (size_t)r * n : part_i + ((size_t)(q0 + r) * S + split) * n;
  };
  for (size_t e = tid; e < (size_t)rows * n; e += THREADS) {
    const int r = (int)(e / n), j = (int)(e % n);
    row_v(r)[j] = -INFINITY;
    row_i(r)[j] = INT_MAX;
  }
  if (FMT == FMT_INT8)
    for (int r = tid; r < rows; r += THREADS) qs_s[r] = qscale[q0 + r];
  __syncthreads();

  const long long start_ll = (long long)split * per_split;
  const int start = start_ll < N ? (int)start_ll : N;
  const int end = (long long)start + per_split < N ? start + per_split : N;
  for (int t0 = start; t0 < end; t0 += TN) {
    const int c = t0 + tid;
    V* mine = acc + tid;                          // this candidate's column
    unsigned long long touched = 0;               // rows with a sum in `mine`
    if (c < end) {
      // Sum over slots j in order of v[j] * q_r[idx[j]], each product and
      // sum rounded alone (exact in int32 for FMT_INT8).  Latents no query
      // holds add exact zeros (a sum starts at +0 and never becomes -0),
      // so they are skipped, and a row no slot touched sums to +0.
      auto add = [&](int2 en, V v) {
        const unsigned long long bit = 1ull << en.y;
        mine[en.y * TN] = mac<FMT>((touched & bit) ? mine[en.y * TN] : V(0), en.x, v);
        touched |= bit;
      };
      auto slot = [&](V v, int ix) {
        if ((unsigned)ix >= (unsigned)h) return;
        int p = seg(ix);
        const int e = seg(ix + 1);
        for (; p + 1 < e; p += 2) {         // two rows at a time: independent loads
          const int2 e0 = ent[p], e1 = ent[p + 1];
          add(e0, v);
          add(e1, v);
        }
        if (p < e) add(ent[p], v);
      };
      if (FMT == FMT_F32) {
        const float* cv = reinterpret_cast<const float*>(values_) + (size_t)c * k;
        const IT* ci = indices + (size_t)c * k;
        if (vec) {  // k % 4 == 0 and aligned rows: 16-byte loads
          for (int j4 = 0; j4 < k / 4; ++j4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(cv) + j4);
            const auto ix = Idx4<IT>::load(ci + 4 * j4);
            slot(V(v.x), widen(ix.x)); slot(V(v.y), widen(ix.y));
            slot(V(v.z), widen(ix.z)); slot(V(v.w), widen(ix.w));
          }
        } else {
          for (int j = 0; j < k; ++j) slot(V(cv[j]), widen(ci[j]));
        }
        cf_s[tid] = inv_norms[c];
      } else {
        const signed char* cv = reinterpret_cast<const signed char*>(values_) + (size_t)c * k;
        const IT* ci = indices + (size_t)c * k;
        const float sc = scales[c];
        // FMT_DEQ: the dequantized value float(q) * scale; FMT_INT8: q.
        auto val = [&](signed char q) -> V {
          if (FMT == FMT_DEQ) return V(__fmul_rn((float)q, sc));
          return V(q);
        };
        if (vec) {  // k % 4 == 0 and aligned rows: 4-byte value, 8/16-byte index loads
          for (int j4 = 0; j4 < k / 4; ++j4) {
            const char4 v = __ldg(reinterpret_cast<const char4*>(cv) + j4);
            const auto ix = Idx4<IT>::load(ci + 4 * j4);
            slot(val(v.x), widen(ix.x)); slot(val(v.y), widen(ix.y));
            slot(val(v.z), widen(ix.z)); slot(val(v.w), widen(ix.w));
          }
        } else {
          for (int j = 0; j < k; ++j) slot(val(cv[j]), widen(ci[j]));
        }
        cf_s[tid] = FMT == FMT_INT8 ? __fmul_rn(sc, inv_norms[c]) : inv_norms[c];
      }
    }
    touched_s[tid] = touched;
    __syncthreads();
    // Warp w merges rows w, w + 8, ...: the score of a candidate is its
    // sum (+0 where untouched) times its 1/||c|| (FMT_INT8: f32 of the sum
    // times the row's query scale, times scale * 1/||c||), -inf past the
    // split's end.
    unsigned long long tm[TN / 32];
    float cf[TN / 32];
#pragma unroll
    for (int m = 0; m < TN / 32; ++m) {
      tm[m] = touched_s[32 * m + lane];
      cf[m] = cf_s[32 * m + lane];
    }
    const int bar_row = warp + (THREADS / 32) * lane;   // lane i holds row w + 8i's bar
    const unsigned bar_keys = bar_row < rows ? *reinterpret_cast<volatile unsigned*>(
                                                   gbar_key + q0 + bar_row) : 0u;
    for (int r = warp; r < rows; r += THREADS / 32) {
      float sc[TN / 32];
      const float qsr = FMT == FMT_INT8 ? qs_s[r] : 0.f;
#pragma unroll
      for (int m = 0; m < TN / 32; ++m) {
        const V sum = ((tm[m] >> r) & 1ull) ? acc[r * TN + 32 * m + lane] : V(0);
        float v;
        if (FMT == FMT_INT8)
          v = __fmul_rn(__fmul_rn(__int2float_rn((int)sum), qsr), cf[m]);
        else
          v = __fmul_rn((float)sum, cf[m]);
        sc[m] = t0 + 32 * m + lane < end ? v : -INFINITY;
      }
      const unsigned gbar = __shfl_sync(FULL, bar_keys, (r - warp) / (THREADS / 32));
      float* bv = row_v(r);
      merge_row(bv, row_i(r), sc, t0, t0 == start, n, gbar, lane);
      const unsigned nth = okey(bv[n - 1]);
      if (lane == 0 && nth > gbar) atomicMax(gbar_key + q0 + r, nth);
    }
    __syncthreads();
  }
  if (lists_smem) {
    for (size_t e = tid; e < (size_t)rows * n; e += THREADS) {
      const int r = (int)(e / n), j = (int)(e % n);
      const size_t o = ((size_t)(q0 + r) * S + split) * n + j;
      part_v[o] = lists_v[e];
      part_i[o] = lists_i[e];
    }
  }
}

__global__ void __launch_bounds__(256)
retrieve_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
               float* __restrict__ out_v, int* __restrict__ out_i, int S, int n) {
  __shared__ unsigned w_k[8];
  __shared__ int w_i[8], w_l[8];
  __shared__ float w_s[8];
  __shared__ int win_list;
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pv = part_v + (size_t)q * S * n;
  const int* pi = part_i + (size_t)q * S * n;
  int head[MAX_LISTS], hi[MAX_LISTS];
  unsigned hk[MAX_LISTS];
  float hv[MAX_LISTS];
#pragma unroll
  for (int m = 0; m < MAX_LISTS; ++m) {
    const int s = tid + 256 * m;
    head[m] = 0;
    hv[m] = s < S ? pv[(size_t)s * n] : -INFINITY;
    hk[m] = s < S ? okey(hv[m]) : NO_KEY;
    hi[m] = s < S ? pi[(size_t)s * n] : INT_MAX;
  }
  for (int r = 0; r < n; ++r) {
    unsigned bk = NO_KEY;
    int bi = INT_MAX, bl = INT_MAX;
    float bs = -INFINITY;
#pragma unroll
    for (int m = 0; m < MAX_LISTS; ++m) {
      const int s = tid + 256 * m;
      if (better(hk[m], hi[m], s, bk, bi, bl)) { bk = hk[m]; bs = hv[m]; bi = hi[m]; bl = s; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ok = __shfl_xor_sync(FULL, bk, off);
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (better(ok, oi, ol, bk, bi, bl)) { bk = ok; bs = os; bi = oi; bl = ol; }
    }
    if (lane == 0) { w_k[warp] = bk; w_s[warp] = bs; w_i[warp] = bi; w_l[warp] = bl; }
    __syncthreads();
    if (warp == 0) {
      bk = lane < 8 ? w_k[lane] : NO_KEY;
      bs = lane < 8 ? w_s[lane] : -INFINITY;
      bi = lane < 8 ? w_i[lane] : INT_MAX;
      bl = lane < 8 ? w_l[lane] : INT_MAX;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const unsigned ok = __shfl_xor_sync(FULL, bk, off);
        const float os = __shfl_xor_sync(FULL, bs, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        const int ol = __shfl_xor_sync(FULL, bl, off);
        if (better(ok, oi, ol, bk, bi, bl)) { bk = ok; bs = os; bi = oi; bl = ol; }
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
        hv[m] = live ? pv[(size_t)wlist * n + head[m]] : -INFINITY;
        hk[m] = live ? okey(hv[m]) : NO_KEY;
        hi[m] = live ? pi[(size_t)wlist * n + head[m]] : INT_MAX;
      }
    }
  }
}

// The bar of query q: the key of its n-th best score over the prefix.
__global__ void seed_bar(const float* __restrict__ out_v, const int* __restrict__ out_i,
                         unsigned* __restrict__ gbar_key, int Q, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < Q && out_i[(size_t)q * n + n - 1] != INT_MAX)
    gbar_key[q] = max(gbar_key[q], okey(out_v[(size_t)q * n + n - 1]));
}

struct Args {
  const void* values;
  const void* indices;
  const float* scales;
  const float* inv_norms;
  const float* q_values;
  const int* q_indices;
  int* cnt;
  int* seg;
  int2* raw;
  int2* ent;
  float* qscale;
  float* part_v;
  int* part_i;
  unsigned* gbar_key;
  float* out_v;
  int* out_i;
  int N, k, Q, kq, h, n, bq, S, vec, lists_smem, seg_smem;
};

template <int FMT, typename IT>
cudaError_t scan(const Args& a, int N, int S, size_t smem, cudaStream_t s) {
  const int per_split = (N + S - 1) / S;
  retrieve_tiles<FMT, IT><<<dim3((a.Q + a.bq - 1) / a.bq, S), THREADS, smem, s>>>(
      a.values, static_cast<const IT*>(a.indices), a.scales, a.inv_norms, a.seg, a.ent,
      a.qscale, a.part_v, a.part_i, a.gbar_key, N, a.k, a.Q, a.kq, a.h, a.n, a.bq,
      per_split, a.vec, a.lists_smem, a.seg_smem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  retrieve_merge<<<a.Q, 256, 0, s>>>(a.part_v, a.part_i, a.out_v, a.out_i, S, a.n);
  return cudaGetLastError();
}

template <int FMT, typename IT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem = (size_t)layout(a.bq, a.n, a.kq, a.h, a.lists_smem, a.seg_smem).total;
  cudaError_t err = cudaMemsetAsync(a.gbar_key, 0, (size_t)a.Q * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  build_panel<FMT == FMT_INT8><<<(a.Q + a.bq - 1) / a.bq, BUILD_THREADS, 0, s>>>(
      a.q_values, a.q_indices, a.Q, a.kq, a.h, a.bq, a.cnt, a.seg, a.raw, a.ent, a.qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(retrieve_tiles<FMT, IT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Seed each query's bar with its n-th best score over a catalog prefix
  // (a lower bound of its final n-th best), so that the splits of the full
  // scan keep only what can still be among the top n.
  if (a.N >= 4 * SAMPLE && 4 * a.n <= SAMPLE) {
    err = scan<FMT, IT>(a, SAMPLE, min(a.S, SAMPLE / TN), smem, s);
    if (err != cudaSuccess) return err;
    seed_bar<<<(a.Q + 255) / 256, 256, 0, s>>>(a.out_v, a.out_i, a.gbar_key, a.Q, a.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return scan<FMT, IT>(a, a.N, a.S, smem, s);
}

}  // namespace

extern "C" {

// fmt 0/1/2 = FMT_F32/FMT_DEQ/FMT_INT8; idx_bytes 4 (int32) or 2 (int16,
// quantized formats only).  values (N, k) f32 or int8, indices (N, k),
// scales (N,) (quantized formats), inv_norms (N,), q_values/q_indices
// (Q, kq) f32/i32.  Scratch: cnt and seg (panels, h + 1) i32, raw and ent
// (panels, bq * kq) int2, qscale (panels * bq,) f32, part_v/part_i
// (Q, S, n), gbar_key (Q,); out_v/out_i (Q, n).  1 <= bq <= 64,
// 1 <= S <= 1024, n >= 1; lists_smem/seg_smem say whether the running lists
// and seg fit shared memory (kernel.py::plan).  Returns the first CUDA
// error, or 0.
int sparse_dot_retrieve_launch(int fmt, int idx_bytes, const void* values,
                               const void* indices, const float* scales,
                               const float* inv_norms, const float* q_values,
                               const int* q_indices, int* cnt, int* seg, void* raw,
                               void* ent, float* qscale, float* part_v, int* part_i,
                               unsigned* gbar_key, float* out_v, int* out_i, int N, int k,
                               int Q, int kq, int h, int n, int bq, int S, int vec,
                               int lists_smem, int seg_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || S < 1 || S > 256 * MAX_LISTS || bq < 1 || bq > MAX_ROWS || h < 1 ||
      (idx_bytes != 2 && idx_bytes != 4) || (fmt == FMT_F32 && idx_bytes != 4))
    return cudaErrorInvalidValue;
  const Args a{values, indices, scales, inv_norms, q_values, q_indices, cnt, seg,
               static_cast<int2*>(raw), static_cast<int2*>(ent), qscale, part_v, part_i,
               gbar_key, out_v, out_i, N, k, Q, kq, h, n, bq, S, vec, lists_smem, seg_smem};
  switch (fmt * 8 + idx_bytes) {
    case FMT_F32 * 8 + 4: return launch<FMT_F32, int>(a, s);
    case FMT_DEQ * 8 + 2: return launch<FMT_DEQ, short>(a, s);
    case FMT_DEQ * 8 + 4: return launch<FMT_DEQ, int>(a, s);
    case FMT_INT8 * 8 + 2: return launch<FMT_INT8, short>(a, s);
    case FMT_INT8 * 8 + 4: return launch<FMT_INT8, int>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* sparse_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
