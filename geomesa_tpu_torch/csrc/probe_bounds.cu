// Probe P2, bounds: per-slot count, min/max x and y of the rows in any of
// 8 boxes.
//
// Replaces the Pallas kernel make_pallas(_bounds_kernel)
// (scripts/probe_agg.py:128, body _bounds_kernel :109, pallas_call
// :144), the chip-side probe of the bounds push-down: f32 x, y columns
// [n_blocks, SUB, 128], M slots, one [M, 128] f32 row per slot with lanes
// 0-4 = count, xmin, xmax, ymin, ymax and the other lanes 0. A row counts
// when it lies in any of the 8 closed boxes (lanes 0-3 of the box slots).
// Pad slots (bid < 0) read block 0, as the probe's index map
// jnp.maximum(bids[i], 0) does, and are not masked: their rows report
// block 0's stats, as xla_bounds does. A slot without a hit reports count
// 0, xmin = ymin = +inf, xmax = ymax = -inf.
//
// Bound on the H100: memory. Each row is read once (8 B) and costs 8
// compares and logic ops a live box; the output is 512 B a slot.
//
// Design: one CTA of 8 warps a slot, so a slot's result needs no merge
// across CTAs (the card has no f32 atomic min or max); at M = 1024 that
// is about one wave of 8 CTAs an SM. The slot's rows are read as a flat
// run of 16-byte column loads, neighbouring threads on neighbouring 4-row
// groups: a thread issues the loads of 8 rows (2 groups) of x and y before
// any compare, takes the box leg over the live slots through the batch
// predicate of masks.cuh (the host puts the live slots first,
// probe_kernels.live_slots: a slot with an empty interval matches no
// row), and folds count and four extrema of its hits in registers. Warp
// shuffles and one shared-memory pass across the 8 warps reduce them (the
// count is exact as f32 up to 2^24 rows), and the first 128 threads write
// the slot's 128 output lanes, so the output needs no zeroing.

#include "masks.cuh"

#define GM_PB_THREADS 256
#define GM_PB_WARPS (GM_PB_THREADS / 32)
#define GM_PB_GROUPS 2  // 4-row groups a thread loads ahead of its compares
#define GM_PB_ROWS (4 * GM_PB_GROUPS)
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

__global__ void __launch_bounds__(GM_PB_THREADS)
gm_probe_bounds_kernel(GmCols c, const int* __restrict__ params, int m, int sub,
                       float* __restrict__ out) {
  constexpr int G = GM_PB_GROUPS, R = GM_PB_ROWS;
  __shared__ GmParams p;
  __shared__ GmProbeStats part[GM_PB_WARPS];
  __shared__ float row[5];
  gm_load_params(p, params, m);
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const long long base = (long long)max(params[blockIdx.x], 0) * sub * GM_LANES;
  const int groups = sub * (GM_LANES / 4);  // 4-row groups of the slot
  const int n_box = p.n_box;
  GmProbeStats s{0, inf, -inf, inf, -inf};
#pragma unroll 1
  for (int g0 = tid; g0 < groups; g0 += G * GM_PB_THREADS) {
    // every load of the batch first: row 4k + i of group g0 + k * threads
    float a[R], b[R], e[R], f[R];
    int t0[R], t1[R];
#pragma unroll
    for (int k = 0; k < G; ++k)
      gm_load_rows<false, 4, 1>(c, base + 4ll * (g0 + k * GM_PB_THREADS), GM_HAS_BOXES,
                                GM_LEG_BOX, 4 * k, a, b, e, f, t0, t1);
    GmMask w = gm_all_rows<R>(), in = gm_all_rows<R>();
    gm_leg_bits<false, R>(p, GM_HAS_BOXES, GM_LEG_BOX, n_box, 0, a, b, e, f, t0, t1, w, in);
    s.cnt += __popc(w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool hit = (w >> r) & 1u;
      s.xmin = fminf(s.xmin, hit ? a[r] : inf);
      s.xmax = fmaxf(s.xmax, hit ? a[r] : -inf);
      s.ymin = fminf(s.ymin, hit ? b[r] : inf);
      s.ymax = fmaxf(s.ymax, hit ? b[r] : -inf);
    }
  }
  gm_probe_warp_reduce(s);
  const int warp = tid >> 5, wl = tid & 31;
  if (wl == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    GmProbeStats t = wl < GM_PB_WARPS ? part[wl] : GmProbeStats{0, inf, -inf, inf, -inf};
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

// x, y: f32 columns [n_blocks, sub, 128], 16-byte aligned, sub a multiple
// of 16. params: bids[m] (-1 = pad, read as block 0) | boxes[8][8] (f32
// bits; lanes 0-3 read) | wins[8][8] (unread) | live box slots (of lanes
// 0-3, first) | 0. out: f32 [m, 128]. Returns cudaGetLastError() of the
// launch (0 = launched).
extern "C" int gm_probe_bounds(const float* x, const float* y, const int* params, int m,
                               int sub, float* out, void* stream) {
  if (m <= 0) return 0;
  if (sub % 16) return (int)cudaErrorInvalidValue;
  const GmCols c{x, y, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  gm_probe_bounds_kernel<<<m, GM_PB_THREADS, 0, (cudaStream_t)stream>>>(c, params, m, sub,
                                                                         out);
  return (int)cudaGetLastError();
}
