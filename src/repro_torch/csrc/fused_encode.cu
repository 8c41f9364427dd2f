// Fused CompresSAE encoder for Hopper (sm_90a): codes = abs-top-k(x̄ @ W + b).
//
// Replaces the TPU kernel repro/kernels/fused_encode/kernel.py::fused_encode_pallas.
// That kernel keeps a (128, h) fp32 accumulator on chip; at h = 4096 it is
// 2 MiB, far above the 227 KB a block may use here.  So this kernel runs the
// exact grouped algorithm of core/topk.py::abs_topk_sparse_grouped instead:
//
//   launch 1, encode_tiles: grid (ceil(B/BM), ceil(h/BH)), with (BM, BH) =
//     (64, 256) for large batches and (16, 128) where the large tiles would
//     leave SMs idle (a 64-query request: 128 blocks instead of 16).  A block
//     computes its (BM, BH) pre-activation tile x̄[rows] @ W[:, tile] +
//     b[tile] with a register-tiled fp32 FMA loop over d (SIMT fp32: no TF32,
//     no tensor cores; every tile sums over d in the same order, so both
//     shapes give the same bits), then keeps the kt = min(k, BH) largest |pre|
//     of each row of its tile by rounds of first-argmax, sorted.  Each row of
//     the tile lies across the 32 lanes of one warp, so the selection runs on
//     registers and warp shuffles alone.  Latents past h (a ragged last tile)
//     are masked in the loads and the selection; a tile with fewer than kt
//     latents ends its list with empty places (index INT_MAX).  Out go
//     (value, global index) lists, (B, G, kt).
//   launch 2.., encode_merge: one warp a row merges up to 256 sorted lists
//     into one by |v| descending, then index ascending: exactly lax.top_k's
//     order over the whole row.  Wider rows (more than 256 tiles) take more
//     passes, each merging groups of 256 lists, until one list of k is left.
//
// |v| is compared through an order key in which NaN ranks above every
// number, as lax.top_k ranks it, so a NaN pre-activation is selected first,
// lowest index first.  The (B, h) pre-activations never reach device
// memory; only the lists (G·kt·8 bytes a row) and the (B, k) codes do.
// Ragged B and a d that is no multiple of 16 are masked in the loads.
//
// What bounds it: at B = 64, d = 768, h = 4096 the product is 0.40 GFLOP,
// 6.0 us at the card's 67 TFLOP/s fp32, against 3.8 us for its 12.8 MB of
// bytes, so compute.  This version is plain SIMT fp32 with one shared-memory
// stage and no overlap of loads with FMAs; tensor cores (an exactness-checked
// 3xTF32 split) and pipelined loads are later work.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 16;           // depth of one shared-memory stage
constexpr int HEADS = 8;         // lists a lane holds in the merge
constexpr int GROUP = 32 * HEADS;  // lists one merge warp takes
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0u;  // an empty place: below every |v|

// Order key of |v| >= 0: NaN above every number (lax.top_k's order).
__device__ __forceinline__ unsigned akey(float v) {
  const float a = fabsf(v);
  return a != a ? 0xffffffffu : (__float_as_uint(a) | 0x80000000u);
}

// (key desc, index asc): the order of lax.top_k over |pre|.
__device__ __forceinline__ bool better(unsigned a, int ia, unsigned b, int ib) {
  return a > b || (a == b && ia < ib);
}

// TM rows per warp, CPL tile columns per lane: a block's tile is
// (8*TM, 32*CPL).  Lane l holds the columns 128*c4 + 4*l + (0..3) for
// c4 < CPL/4, increasing in its register index j.
template <int TM, int CPL>
__global__ void __launch_bounds__(THREADS)
encode_tiles(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ cand_v,
             int* __restrict__ cand_i, int B, int d, int h, int kt) {
  constexpr int BM = TM * WARPS, BH = CPL * 32;
  __shared__ float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int g = blockIdx.y, G = gridDim.y;
  const int col0 = g * BH;

  float acc[TM][CPL];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int u = 0; u < (BM * BK + THREADS - 1) / THREADS; ++u) {
      const int e = tid + u * THREADS;
      if (e < BM * BK) {
        const int r = e / BK, kk = e % BK;
        const int gr = m0 + r, gk = k0 + kk;
        As[kk][r] = (gr < B && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < (BK * BH) / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int kk = e / BH, c = e % BH;
      const int gk = k0 + kk;
      Bs[kk][c] = (gk < d && col0 + c < h) ? w[(size_t)gk * h + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[CPL];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][warp * TM + i];
#pragma unroll
      for (int c4 = 0; c4 < CPL / 4; ++c4) {
        const float4 bb = *reinterpret_cast<const float4*>(&Bs[kk][128 * c4 + lane * 4]);
        b[4 * c4] = bb.x; b[4 * c4 + 1] = bb.y; b[4 * c4 + 2] = bb.z; b[4 * c4 + 3] = bb.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  int col[CPL];
  float bj[CPL];
  unsigned outside = 0;          // columns past h never enter the selection
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    col[j] = col0 + 128 * (j / 4) + lane * 4 + (j % 4);
    bj[j] = col[j] < h ? bias[col[j]] : 0.f;
    if (col[j] >= h) outside |= 1u << j;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    float v[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = acc[i][j] + bj[j];
    unsigned used = outside;
    const size_t base = ((size_t)row * G + g) * kt;
    for (int r = 0; r < kt; ++r) {
      unsigned bk = NO_KEY;
      float bv = 0.f;
      int bc = INT_MAX, bjj = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const unsigned kj = akey(v[j]);
        if (!((used >> j) & 1u) && kj > bk) { bk = kj; bv = v[j]; bc = col[j]; bjj = j; }
      }
      unsigned wk = bk;
      int wc = bc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned ok = __shfl_xor_sync(FULL, wk, off);
        const int oc = __shfl_xor_sync(FULL, wc, off);
        if (better(ok, oc, wk, wc)) { wk = ok; wc = oc; }
      }
      const bool found = wk != NO_KEY;     // warp-uniform
      const int owner = found ? ((wc - col0) & 127) >> 2 : 0;
      const float sv = __shfl_sync(FULL, bv, owner);
      if (found && lane == owner) used |= 1u << bjj;
      if (lane == 0 && row < B) { cand_v[base + r] = found ? sv : 0.f; cand_i[base + r] = wc; }
    }
  }
}

// One warp a row merges the lists [g*GROUP, min(G, (g+1)*GROUP)) of its
// row, (B, G, L) sorted by (|v| desc, index asc) with empty places
// (index INT_MAX) last, into the first Lo entries of output list g of
// (B, Go, Lo).  Indices are distinct across a row's lists (the tiles are
// disjoint), so the order is total.
__global__ void __launch_bounds__(256)
encode_merge(const float* __restrict__ in_v, const int* __restrict__ in_i,
             float* __restrict__ out_v, int* __restrict__ out_i,
             int B, int G, int L, int Lo) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave together
  const int g = blockIdx.y, Go = gridDim.y;
  const int first = g * GROUP, lists = min(G - first, GROUP);
  const float* rv = in_v + ((size_t)row * G + first) * L;
  const int* ri = in_i + ((size_t)row * G + first) * L;
  int pos[HEADS], hc[HEADS];
  unsigned hk[HEADS];
  float hv[HEADS];
#pragma unroll
  for (int m = 0; m < HEADS; ++m) {
    const int l = lane + 32 * m;
    pos[m] = 0;
    hc[m] = l < lists ? ri[(size_t)l * L] : INT_MAX;
    hv[m] = l < lists ? rv[(size_t)l * L] : 0.f;
    hk[m] = hc[m] == INT_MAX ? NO_KEY : akey(hv[m]);
  }
  float* ov = out_v + ((size_t)row * Go + g) * Lo;
  int* oi = out_i + ((size_t)row * Go + g) * Lo;
  for (int r = 0; r < Lo; ++r) {
    unsigned bk = NO_KEY;
    int bc = INT_MAX, bm = 0;
    float bv = 0.f;
#pragma unroll
    for (int m = 0; m < HEADS; ++m)
      if (better(hk[m], hc[m], bk, bc)) { bk = hk[m]; bc = hc[m]; bv = hv[m]; bm = m; }
    unsigned wk = bk;
    int wc = bc, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ok = __shfl_xor_sync(FULL, wk, off);
      const int oc = __shfl_xor_sync(FULL, wc, off);
      const int ol = __shfl_xor_sync(FULL, wl, off);
      if (better(ok, oc, wk, wc) || (ok == wk && oc == wc && ol < wl)) {
        wk = ok; wc = oc; wl = ol;
      }
    }
    const float sv = __shfl_sync(FULL, bv, wl);
    if (lane == 0) { ov[r] = wk == NO_KEY ? 0.f : sv; oi[r] = wk == NO_KEY ? INT_MAX : wc; }
    if (wk == NO_KEY) continue;
    if (lane == wl) {
#pragma unroll
      for (int m = 0; m < HEADS; ++m) {
        if (m != bm) continue;
        const int l = lane + 32 * m;
        pos[m] += 1;
        const bool live = pos[m] < L;
        hc[m] = live ? ri[(size_t)l * L + pos[m]] : INT_MAX;
        hv[m] = live ? rv[(size_t)l * L + pos[m]] : 0.f;
        hk[m] = hc[m] == INT_MAX ? NO_KEY : akey(hv[m]);
      }
    }
  }
}

}  // namespace

extern "C" {

// x (B, d) already L2-normalised, w (d, h), b (h,); out_v/out_i (B, k).
// bh is the tile width: 256 (64-row tiles) or 128 (16-row tiles); G =
// ceil(h / bh) tiles keep kt = min(k, bh) each.  Scratch: list_v/list_i
// (B, G, kt) and, where G > 256, merge_v/merge_i (B, ceil(G / 256),
// min(k, 256 * kt)); where G == 1 the tiles write out_v/out_i directly.
// Returns the first CUDA error, or 0.
int fused_encode_launch(const float* x, const float* w, const float* b,
                        float* list_v, int* list_i, float* merge_v, int* merge_i,
                        float* out_v, int* out_i, int B, int d, int h, int k, int bh,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || d < 1 || k < 1 || k > h) return cudaErrorInvalidValue;
  int G = (h + bh - 1) / bh;
  int L = k < bh ? k : bh;
  float* tv = G == 1 ? out_v : list_v;
  int* ti = G == 1 ? out_i : list_i;
  if (bh == 256) {
    encode_tiles<8, 8><<<dim3((B + 63) / 64, G), THREADS, 0, s>>>(x, w, b, tv, ti, B, d, h, L);
  } else if (bh == 128) {
    encode_tiles<2, 4><<<dim3((B + 15) / 16, G), THREADS, 0, s>>>(x, w, b, tv, ti, B, d, h, L);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Merge passes, alternating between the two scratch pairs; each pass's
  // lists take no more room than the last, so each pair holds them.
  const float* src_v = tv;
  const int* src_i = ti;
  bool to_merge = true;
  while (G > 1) {
    const int Go = (G + GROUP - 1) / GROUP;
    const long long room = (long long)L * (G < GROUP ? G : GROUP);
    const int Lo = Go == 1 ? k : (int)(room < k ? room : k);
    float* dv = Go == 1 ? out_v : (to_merge ? merge_v : list_v);
    int* di = Go == 1 ? out_i : (to_merge ? merge_i : list_i);
    encode_merge<<<dim3((B + 7) / 8, Go), 256, 0, s>>>(src_v, src_i, dv, di, B, G, L, Lo);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_v = dv;
    src_i = di;
    to_merge = !to_merge;
    G = Go;
    L = Lo;
  }
  return cudaSuccess;
}

const char* fused_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
