// Probe P2, bounds: per-slot count, min/max x and y of the rows in any of
// 8 boxes.
//
// Replaces the Pallas kernel make_pallas(_bounds_kernel)
// (scripts/probe_agg.py:128, body _bounds_kernel :109, pallas_call
// :144), the chip-side probe of the bounds push-down: f32 x, y columns
// [n_blocks, SUB, 128], M slots, one [M, 128] f32 row per slot with lanes
// 0-4 = count, xmin, xmax, ymin, ymax and the other lanes 0. A row counts
// when it lies in any of the 8 closed boxes (lanes 0-3 of the box slots;
// pad slots are +inf / -inf and match nothing). Pad slots (bid < 0) read
// block 0, as the probe's index map jnp.maximum(bids[i], 0) does, and are
// not masked: their rows report block 0's stats, as xla_bounds does. A
// slot without a hit reports count 0, xmin = ymin = +inf, xmax = ymax =
// -inf.
//
// Bound on the H100: memory. Each row is read once (8 B) and costs 8
// boxes x 8 compares and logic ops; the output is 512 B a slot.
//
// Design: one CTA per slot, as bounds.cu. Each thread folds its 32 rows
// (gm_row, coalesced across lanes) into a count and four extrema in
// registers, a warp shuffle and a shared-memory pass across warps reduce
// them (the count is exact as f32 up to 2^24 rows), and the first 128
// threads write the slot's 128 output lanes, so the output needs no
// zeroing.

#include "masks.cuh"

#define GM_FULL_MASK 0xffffffffu

struct GmProbeStats {
  int cnt;
  float xmin, xmax, ymin, ymax;
};

__device__ __forceinline__ void gm_probe_fold(GmProbeStats& a, const GmProbeStats& b) {
  a.cnt += b.cnt;
  a.xmin = fminf(a.xmin, b.xmin);
  a.xmax = fmaxf(a.xmax, b.xmax);
  a.ymin = fminf(a.ymin, b.ymin);
  a.ymax = fmaxf(a.ymax, b.ymax);
}

__device__ __forceinline__ void gm_probe_warp_reduce(GmProbeStats& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const GmProbeStats o{__shfl_down_sync(GM_FULL_MASK, s.cnt, off),
                         __shfl_down_sync(GM_FULL_MASK, s.xmin, off),
                         __shfl_down_sync(GM_FULL_MASK, s.xmax, off),
                         __shfl_down_sync(GM_FULL_MASK, s.ymin, off),
                         __shfl_down_sync(GM_FULL_MASK, s.ymax, off)};
    gm_probe_fold(s, o);
  }
}

__global__ void __launch_bounds__(1024)
gm_probe_bounds_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const int* __restrict__ params, int m, int sub,
                       float* __restrict__ out) {
  __shared__ GmParams p;
  __shared__ GmProbeStats part[32];
  __shared__ float row[5];
  gm_load_params(p, params, m);
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  const int bid = max(params[blockIdx.x], 0);
  const int pack = sub >> 5;
  const long long base = (long long)bid * sub * GM_LANES;
  const int lane = threadIdx.x;
  GmProbeStats s{0, inf, -inf, inf, -inf};
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    for (int b = 0; b < 32; ++b) {
      const long long r = gm_row(base, j, b, lane);
      const float xv = x[r], yv = y[r];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < GM_SLOTS; ++k) {
        const float* q = p.box[k];
        hit |= (xv >= q[0]) & (xv <= q[2]) & (yv >= q[1]) & (yv <= q[3]);
      }
      if (hit) gm_probe_fold(s, GmProbeStats{1, xv, xv, yv, yv});
    }
  }
  gm_probe_warp_reduce(s);
  const int tid = gm_tid();
  const int warp = tid >> 5, wl = tid & 31;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  if (wl == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    GmProbeStats t = wl < n_warps ? part[wl] : GmProbeStats{0, inf, -inf, inf, -inf};
    gm_probe_warp_reduce(t);
    if (wl == 0) {
      row[0] = (float)t.cnt;
      row[1] = t.xmin;
      row[2] = t.xmax;
      row[3] = t.ymin;
      row[4] = t.ymax;
    }
  }
  __syncthreads();
  if (tid < GM_LANES) out[(long long)blockIdx.x * GM_LANES + tid] = tid < 5 ? row[tid] : 0.0f;
}

// x, y: f32 columns [n_blocks, sub, 128]. params: bids[m] (-1 = pad,
// read as block 0) | boxes[8][8] (f32 bits; lanes 0-3 read) | wins[8][8]
// and two slot counts (unused). out: f32 [m, 128]. Returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int gm_probe_bounds(const float* x, const float* y, const int* params, int m,
                               int sub, float* out, void* stream) {
  if (m <= 0) return 0;
  gm_probe_bounds_kernel<<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
      x, y, params, m, sub, out);
  return (int)cudaGetLastError();
}
