// Fused CompresSAE encoder for Hopper (sm_90a): codes = abs-top-k(x̄ @ W + b).
//
// Replaces the TPU kernel repro/kernels/fused_encode/kernel.py::fused_encode_pallas.
// That kernel keeps a (128, h) fp32 accumulator on chip; at h = 4096 it is
// 2 MiB, far above the 227 KB a block may use here.  So this kernel runs the
// exact grouped algorithm of core/topk.py::abs_topk_sparse_grouped instead:
//
//   launch 1, encode_tiles: grid (ceil(B/BM), h/BH), with (BM, BH) = (64, 256)
//     for large batches and (16, 128) where the large tiles would leave SMs
//     idle (a 64-query request: 128 blocks instead of 16).  A block computes
//     its (BM, BH) pre-activation tile x̄[rows] @ W[:, tile] + b[tile] with a
//     register-tiled fp32 FMA loop over d (SIMT fp32: no TF32, no tensor
//     cores; every tile sums over d in the same order, so both shapes give
//     the same bits), then keeps the k largest |pre| of each row of its tile
//     by k rounds of first-argmax.  Each row of the tile lies across the 32
//     lanes of one warp, so the selection runs on registers and warp
//     shuffles alone.  Out go (value, global index) candidates, (B, h/BH, k).
//   launch 2, encode_merge: one warp a row merges the h/BH*k candidates into
//     the final k, by |v| descending, then index ascending: exactly
//     lax.top_k's order over the whole row.
//
// The (B, h) pre-activations never reach device memory; only the candidate
// scratch (h/BH*k*8 bytes a row) and the (B, k) codes do.  Ragged B and a d
// that is no multiple of 16 are masked in the loads.  The wrapper
// (kernels/fused_encode/kernel.py) checks h % 256 == 0, 1 <= k <= 256 and
// that a row's candidates fit the merge (at most 1024).
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
constexpr int MERGE_MAXC = 32;   // candidates per lane in the merge
constexpr unsigned FULL = 0xffffffffu;

// (|v| desc, index asc): the order of lax.top_k over |pre|.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// TM rows per warp, CPL tile columns per lane: a block's tile is
// (8*TM, 32*CPL).  Lane l holds the columns 128*c4 + 4*l + (0..3) for
// c4 < CPL/4, increasing in its register index j.
template <int TM, int CPL>
__global__ void __launch_bounds__(THREADS)
encode_tiles(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ cand_v,
             int* __restrict__ cand_i, int B, int d, int h, int k) {
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
      Bs[kk][c] = gk < d ? w[(size_t)gk * h + col0 + c] : 0.f;
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
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    col[j] = col0 + 128 * (j / 4) + lane * 4 + (j % 4);
    bj[j] = bias[col[j]];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    float v[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = acc[i][j] + bj[j];
    unsigned used = 0;
    const size_t base = ((size_t)row * G + g) * k;
    for (int r = 0; r < k; ++r) {
      float ba = -1.f, bv = 0.f;
      int bc = INT_MAX, bjj = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float a = fabsf(v[j]);
        if (!((used >> j) & 1u) && a > ba) { ba = a; bv = v[j]; bc = col[j]; bjj = j; }
      }
      float wa = ba;
      int wc = bc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float oa = __shfl_xor_sync(FULL, wa, off);
        const int oc = __shfl_xor_sync(FULL, wc, off);
        if (better(oa, oc, wa, wc)) { wa = oa; wc = oc; }
      }
      const int owner = ((wc - col0) & 127) >> 2;
      const float sv = __shfl_sync(FULL, bv, owner);
      if (lane == owner) used |= 1u << bjj;
      if (lane == 0 && row < B) { cand_v[base + r] = sv; cand_i[base + r] = wc; }
    }
  }
}

__global__ void __launch_bounds__(256)
encode_merge(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
             float* __restrict__ out_v, int* __restrict__ out_i,
             int B, int C, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave together
  const float* rv = cand_v + (size_t)row * C;
  const int* ri = cand_i + (size_t)row * C;
  float v[MERGE_MAXC];
  int c[MERGE_MAXC];
  unsigned used = 0;
#pragma unroll
  for (int j = 0; j < MERGE_MAXC; ++j) {
    const int p = lane + 32 * j;
    const bool ok = p < C;
    v[j] = ok ? rv[p] : 0.f;
    c[j] = ok ? ri[p] : INT_MAX;
    if (!ok) used |= 1u << j;
  }
  for (int r = 0; r < k; ++r) {
    float ba = -1.f, bv = 0.f;
    int bc = INT_MAX, bj = 0;
#pragma unroll
    for (int j = 0; j < MERGE_MAXC; ++j) {
      const float a = fabsf(v[j]);
      if (!((used >> j) & 1u) && better(a, c[j], ba, bc)) {
        ba = a; bv = v[j]; bc = c[j]; bj = j;
      }
    }
    float wa = ba;
    int wc = bc, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_xor_sync(FULL, wa, off);
      const int oc = __shfl_xor_sync(FULL, wc, off);
      const int ol = __shfl_xor_sync(FULL, wl, off);
      if (better(oa, oc, wa, wc) || (oa == wa && oc == wc && ol < wl)) {
        wa = oa; wc = oc; wl = ol;
      }
    }
    const float sv = __shfl_sync(FULL, bv, wl);
    if (lane == wl) used |= 1u << bj;
    if (lane == 0) { out_v[(size_t)row * k + r] = sv; out_i[(size_t)row * k + r] = wc; }
  }
}

}  // namespace

extern "C" {

// x (B, d) already L2-normalised, w (d, h), b (h,); scratch cand_v/cand_i
// (B, h/bh, k); out_v/out_i (B, k).  bh is the tile width: 256 (64-row
// tiles) or 128 (16-row tiles).  Returns cudaGetLastError().
int fused_encode_launch(const float* x, const float* w, const float* b,
                        float* cand_v, int* cand_i, float* out_v, int* out_i,
                        int B, int d, int h, int k, int bh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = h / bh;
  if (bh == 256) {
    encode_tiles<8, 8><<<dim3((B + 63) / 64, G), THREADS, 0, s>>>(
        x, w, b, cand_v, cand_i, B, d, h, k);
  } else if (bh == 128) {
    encode_tiles<2, 4><<<dim3((B + 15) / 16, G), THREADS, 0, s>>>(
        x, w, b, cand_v, cand_i, B, d, h, k);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  encode_merge<<<(B + 7) / 8, 256, 0, s>>>(cand_v, cand_i, out_v, out_i, B, G * k, k);
  return cudaGetLastError();
}

const char* fused_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
