// Shared predicate legs of the port's scan-path kernels (block_scan.cu,
// block_scan_multi.cu, block_pops.cu, density.cu, bounds.cu): the box,
// window, packed-time and validity legs of _masks in
// geomesa_tpu/scan/block_kernels.py:509-630, evaluated for one row of a
// [n_blocks, SUB, 128] column block.
//
// Parameter staging: the host packs one int32 buffer per query and sends
// it in one copy,
//     params = bids[m] | boxes[8][8] (f32 bits) | wins[8][8]
//              | n_box_slots | n_win_slots | extra...
// where box slot k holds (xmin, ymin, xmax, ymax) of the wide plane in
// lanes 0-3 and of the inner plane in lanes 4-7, and window slot k holds
// (bin_lo, bin_hi, off_lo, off_hi) likewise. Pad slots never match (the
// packers in block_kernels.py set xmin=+inf, xmax=-inf / bin_lo > bin_hi),
// so the host counts the slots before the trailing run of pad slots and
// the legs loop over those only: the same planes, less work per row.
// Each CTA stages the slot words in shared memory once.
//
// A fused chunk of q queries (block_scan_multi.cu) sends one buffer too,
//     params = bids[m] | qids[m] | boxes[q][8][8] | wins[q][8][8]
//              | (n_box_slots, n_win_slots)[q]
// and each CTA stages the slot words and counts of its own query only:
// the counts are per query, never one chunk-wide count.
#pragma once

#include <cuda_runtime.h>

#define GM_LANES 128
#define GM_SLOTS 8
#define GM_HAS_BOXES 1
#define GM_HAS_WINDOWS 2
#define GM_PACKED_TW 4
#define GM_VALID_ON_T 8
#define GM_TW_BITS 16
#define GM_TW_MASK 0xFFFF

struct GmParams {
  float box[GM_SLOTS][8];
  int win[GM_SLOTS][8];
  int n_box, n_win;  // slots before the trailing pad slots
};

// offset of the words after the slot counts (the density grid bounds)
#define GM_EXTRA(m) ((m) + 2 * GM_SLOTS * 8 + 2)

// x, y: f32 coordinates; t0: tbin, or the packed tw column; t1: toff.
// Columns a query does not read are null and never touched.
struct GmCols {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const int* __restrict__ t0;
  const int* __restrict__ t1;
};

__device__ __forceinline__ int gm_tid() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Stage one query's slot words (box[64] f32 bits, win[64]) and its two
// active-slot counts in shared memory. The caller runs __syncthreads()
// before reading them.
__device__ __forceinline__ void gm_load_slots(GmParams& p, const int* box, const int* win,
                                              const int* counts) {
  const int tid = gm_tid();
  if (tid < GM_SLOTS * 8) {
    p.box[tid >> 3][tid & 7] = __int_as_float(box[tid]);
    p.win[tid >> 3][tid & 7] = win[tid];
  }
  if (tid == 0) {
    p.n_box = counts[0];
    p.n_win = counts[1];
  }
}

// Stage the slot words of a one-query ``params`` (after the m bids).
__device__ __forceinline__ void gm_load_params(GmParams& p, const int* params, int m) {
  gm_load_slots(p, params + m, params + m + GM_SLOTS * 8, params + m + 2 * GM_SLOTS * 8);
}

#define GM_WIDE 1u
#define GM_INNER 2u

// Wide (bit 0) and inner (bit 1) of the row at flat offset r. Boxes and
// windows AND together; with neither, both planes are the row-validity
// test (isfinite(x), or t0 >= 0 for a table without coordinates): table
// pad rows carry never-matching sentinels (x = +inf, tbin = tw = -1).
__device__ __forceinline__ unsigned gm_row_bits(const GmCols& c, const GmParams& p,
                                                long long r, int flags,
                                                int n_box, int n_win) {
  bool w = true, in = true;
  if (flags & GM_HAS_BOXES) {
    const float x = c.x[r], y = c.y[r];
    bool bw = false, bi = false;
    for (int k = 0; k < n_box; ++k) {
      const float* b = p.box[k];
      bw |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3]);
      bi |= (x >= b[4]) & (x <= b[6]) & (y >= b[5]) & (y <= b[7]);
    }
    w = bw;
    in = bi;
  }
  if (flags & GM_HAS_WINDOWS) {
    int tb, to;
    if (flags & GM_PACKED_TW) {
      // arithmetic shift: the pad sentinel -1 stays bin -1, never a real bin
      const int tw = c.t0[r];
      tb = tw >> GM_TW_BITS;
      to = tw & GM_TW_MASK;
    } else {
      tb = c.t0[r];
      to = c.t1[r];
    }
    bool ww = false, wi = false;
    for (int k = 0; k < n_win; ++k) {
      const int* s = p.win[k];
      ww |= (tb >= s[0]) & (tb <= s[1]) & (to >= s[2]) & (to <= s[3]);
      wi |= (tb >= s[4]) & (tb <= s[5]) & (to >= s[6]) & (to <= s[7]);
    }
    w = w && ww;
    in = in && wi;
  }
  if (!(flags & (GM_HAS_BOXES | GM_HAS_WINDOWS))) {
    const bool v = (flags & GM_VALID_ON_T) ? (c.t0[r] >= 0) : (bool)isfinite(c.x[r]);
    w = v;
    in = v;
  }
  return (w ? GM_WIDE : 0u) | (in ? GM_INNER : 0u);
}

// Row (j*32 + b)*128 + lane of a block is bit b of word [j, lane] in the
// packed planes: thread (lane, j) walks its 32 rows at stride 128, so each
// load instruction of a warp reads 32 consecutive words.
__device__ __forceinline__ long long gm_row(long long base, int j, int b, int lane) {
  return base + (long long)(j * 32 + b) * GM_LANES + lane;
}

__host__ __forceinline__ dim3 gm_block_dim(int sub) {
  const int pack = sub / 32;
  return dim3(GM_LANES, pack < 8 ? pack : 8);
}
