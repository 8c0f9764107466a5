// Per-slot bounds stats: [count, xmin, xmax, ymin, ymax, 0, 0, 0] over the
// representative points of the wide-predicate hits of each candidate
// block (the point, or on an extent table the bbox centre, _rep_xy).
//
// Replaces the Pallas kernel _pallas_bounds
// (geomesa_tpu/scan/aggregations.py:358, body _make_bounds_kernel :322),
// every leg.
//
// Bound on the H100: memory; each row is read once and reduced in
// registers.
//
// Design: one CTA per slot. Each thread folds its 32 rows, then a warp
// shuffle and a shared-memory pass across warps reduce count (exact as
// f32 up to 2^24 rows), min and max. Pad slots (bid < 0) clamp to block
// 0, as the reference's index map does; the host reads [:n_real].

#include "masks.cuh"

#define GM_FULL_MASK 0xffffffffu

struct GmStats {
  int cnt;
  float xmin, xmax, ymin, ymax;
};

__device__ __forceinline__ void gm_fold(GmStats& a, int cnt, float xmin,
                                        float xmax, float ymin, float ymax) {
  a.cnt += cnt;
  a.xmin = fminf(a.xmin, xmin);
  a.xmax = fmaxf(a.xmax, xmax);
  a.ymin = fminf(a.ymin, ymin);
  a.ymax = fmaxf(a.ymax, ymax);
}

__device__ __forceinline__ void gm_warp_reduce(GmStats& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gm_fold(s, __shfl_down_sync(GM_FULL_MASK, s.cnt, off),
            __shfl_down_sync(GM_FULL_MASK, s.xmin, off),
            __shfl_down_sync(GM_FULL_MASK, s.xmax, off),
            __shfl_down_sync(GM_FULL_MASK, s.ymin, off),
            __shfl_down_sync(GM_FULL_MASK, s.ymax, off));
  }
}

template <bool EXT>
__global__ void __launch_bounds__(1024)
gm_bounds_kernel(GmCols c, const int* __restrict__ params, int m, int sub,
                 int flags, float* __restrict__ out) {
  __shared__ GmParams p;
  __shared__ GmStats part[32];
  gm_load_params(p, params, m);
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  const int bid = max(params[blockIdx.x], 0);
  const int pack = sub >> 5;
  const long long base = (long long)bid * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  GmStats s{0, inf, -inf, inf, -inf};
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    for (int b = 0; b < 32; ++b) {
      const long long r = gm_row(base, j, b, lane);
      if (gm_row_bits<EXT>(c, p, r, flags, n_box, n_win) & GM_WIDE) {
        float x, y;
        gm_rep_xy<EXT>(c, r, flags, x, y);
        gm_fold(s, 1, x, x, y, y);
      }
    }
  }
  gm_warp_reduce(s);
  const int tid = gm_tid();
  const int warp = tid >> 5, wl = tid & 31;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  if (wl == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    GmStats t = wl < n_warps ? part[wl] : GmStats{0, inf, -inf, inf, -inf};
    gm_warp_reduce(t);
    if (wl == 0) {
      float* o = out + (long long)blockIdx.x * 8;
      o[0] = (float)t.cnt;
      o[1] = t.xmin;
      o[2] = t.xmax;
      o[3] = t.ymin;
      o[4] = t.ymax;
      o[5] = 0.0f;
      o[6] = 0.0f;
      o[7] = 0.0f;
    }
  }
}

// out: f32 [m, 8]. params: bids[m] | boxes | wins | slot counts.
extern "C" int gm_bounds(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                         float* out, void* stream) {
  if (m <= 0) return 0;
  const GmCols c = GM_COLS;
  if (gm_extent(flags))
    gm_bounds_kernel<true><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, out);
  else
    gm_bounds_kernel<false><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, out);
  return (int)cudaGetLastError();
}
