// Shared predicate legs of the port's scan-path kernels (block_scan.cu,
// block_scan_multi.cu, block_pops.cu, density.cu, bounds.cu; the probes'
// kernels take only the row indexing, the slot staging and gm_pixel):
// the box, extent, window, packed-time, validity, point-in-polygon and
// raster legs of _masks in geomesa_tpu/scan/block_kernels.py:509-630
// (the polygon legs after _pip_edge_step :418, _rint_step :460 and
// _raster_cell :471), and the aggregations' representative point (_rep_xy,
// geomesa_tpu/scan/aggregations.py:46), evaluated for one row of a
// [n_blocks, SUB, 128] column block. The two scan kernels take the polygon
// legs; the aggregation kernels never do.
//
// Extent leg (XZ tables, flag GM_EXTENT): the box leg is bbox-intersects
// over the four f32 extent columns (gxmin <= box.xmax, gxmax >= box.xmin,
// likewise in y) against the wide box slots, and its inner plane is all
// false: a bbox test never certifies the true geometry, so every hit
// refines on the host. The stored extents are already widened one f32 ulp
// outward; the kernels compare the stored values and recompute nothing.
// Pad rows carry gxmin = +inf, gxmax = -inf and never intersect; with no
// predicate the validity test is isfinite(gxmin) (GM_VALID_ON_G). The
// aggregations' point of an extent row is the bbox centre,
// (gxmin + gxmax) * 0.5 in f32, add then multiply as the reference.
// The extent code is a template branch (EXT): each kernel is instantiated
// twice and the entry point picks the extent instance when the flags ask
// for the extent columns (gm_extent), so the point legs compile exactly as
// they would without it.
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
//
// Polygon legs. A query's polygon block is
//     n_edges | n_rints | edges[e_cap][6] | header[6] | intervals[r_cap][3]
// (f32 bits): edge lanes (y0, y1, x0, inverse slope, eps_x, eps_y), the
// raster header (x0, y0, 1/cell_w, 1/cell_h, nx, ny), interval lanes
// (lo, hi, cls) -- only the lanes the legs read, never the TPU's 128-lane
// rows. n_edges and n_rints count the rows before the trailing pad rows
// (zero edges never cross and are never near; intervals with lo > hi or
// cls 0 never classify), so the legs loop over those only. One query
// (block_scan.cu) appends its block after the slot counts with caps equal
// to its counts; a fused chunk with polygon stacks sends
//     bids[m] | qids[m] | spip[m] | boxes | wins | counts | blocks[q][...]
// at a stride set by the chunk's edge and interval buckets (e_cap, r_cap),
// and slot i takes the polygon legs of query qids[i] where spip[i] > 0.
#pragma once

#include <cuda_runtime.h>

#define GM_LANES 128
#define GM_SLOTS 8
#define GM_HAS_BOXES 1
#define GM_HAS_WINDOWS 2
#define GM_PACKED_TW 4
#define GM_VALID_ON_T 8
#define GM_HAS_EDGES 16
#define GM_HAS_RAST 32
#define GM_EXTENT 64
#define GM_VALID_ON_G 128
#define GM_TW_BITS 16
#define GM_TW_MASK 0xFFFF
#define GM_MAX_EDGES 256
#define GM_MAX_RINTS 256
#define GM_EDGE_LANES 6
#define GM_HEAD_LANES 6
#define GM_RINT_LANES 3

struct GmParams {
  float box[GM_SLOTS][8];
  int win[GM_SLOTS][8];
  int n_box, n_win;  // slots before the trailing pad slots
};

// offset of the words after the slot counts (the density grid bounds, or
// the scan's polygon block)
#define GM_EXTRA(m) ((m) + 2 * GM_SLOTS * 8 + 2)

// One query's polygon legs, staged in shared memory (9.3 KB at the caps).
struct GmPoly {
  float edge[GM_MAX_EDGES][GM_EDGE_LANES];
  float head[GM_HEAD_LANES];
  float rint[GM_MAX_RINTS][GM_RINT_LANES];
  int n_edge, n_rint;
};

// int32 words of one polygon block at the given caps
__host__ __device__ __forceinline__ int gm_poly_words(int e_cap, int r_cap) {
  return 2 + GM_EDGE_LANES * e_cap + GM_HEAD_LANES + GM_RINT_LANES * r_cap;
}

// spatial leg of a row: none (validity), the box slots, or the polygon legs
#define GM_LEG_NONE 0
#define GM_LEG_BOX 1
#define GM_LEG_PIP 2
#define GM_LEG_RAST 3
#define GM_LEG_RAST_PIP 4

// The spatial leg a slot takes: the polygon legs where the kernel carries
// them and the slot selects them (always for one query; spip > 0 in a
// fused chunk), else the box slots where the query has them.
__host__ __device__ __forceinline__ int gm_leg(int flags, bool poly_slot) {
  if (poly_slot && (flags & GM_HAS_RAST))
    return (flags & GM_HAS_EDGES) ? GM_LEG_RAST_PIP : GM_LEG_RAST;
  if (poly_slot && (flags & GM_HAS_EDGES)) return GM_LEG_PIP;
  return (flags & GM_HAS_BOXES) ? GM_LEG_BOX : GM_LEG_NONE;
}

// x, y: f32 coordinates of a point table; gx0, gy0, gx1, gy1: the f32
// extent columns (gxmin, gymin, gxmax, gymax) of an extent table; t0:
// tbin, or the packed tw column; t1: toff. Columns a query does not read
// are null and never touched.
struct GmCols {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const float* __restrict__ gx0;
  const float* __restrict__ gy0;
  const float* __restrict__ gx1;
  const float* __restrict__ gy1;
  const int* __restrict__ t0;
  const int* __restrict__ t1;
};

// The entry points' leading column arguments, in GmCols order.
#define GM_COL_ARGS                                                              \
  const float *x, const float *y, const float *gx0, const float *gy0,           \
      const float *gx1, const float *gy1, const int *t0, const int *t1
#define GM_COLS GmCols{x, y, gx0, gy0, gx1, gy1, t0, t1}

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

// Stage one polygon block (layout above) in shared memory. The caller
// runs __syncthreads() before reading it.
__device__ __forceinline__ void gm_load_poly(GmPoly& p, const int* blk, int e_cap, int r_cap) {
  const int tid = gm_tid();
  const int nt = blockDim.x * blockDim.y;
  const int n_edge = blk[0], n_rint = blk[1];
  const int* e = blk + 2;
  const int* h = e + GM_EDGE_LANES * e_cap;
  const int* r = h + GM_HEAD_LANES;
  float* pe = &p.edge[0][0];
  float* pr = &p.rint[0][0];
  for (int i = tid; i < n_edge * GM_EDGE_LANES; i += nt) pe[i] = __int_as_float(e[i]);
  for (int i = tid; i < n_rint * GM_RINT_LANES; i += nt) pr[i] = __int_as_float(r[i]);
  if (tid < GM_HEAD_LANES) p.head[tid] = __int_as_float(h[tid]);
  if (tid == 0) {
    p.n_edge = n_edge;
    p.n_rint = n_rint;
  }
}

// Even-odd ray cast of (x, y) over the real edges (_pip_edge_step): the
// crossing abscissa is a separate multiply and add (--fmad=false), as in
// the reference's f32 order; near = within an edge's uncertainty band.
__device__ __forceinline__ void gm_pip(const GmPoly& p, float x, float y, bool& parity,
                                       bool& near) {
  bool par = false, nr = false;
  const int n = p.n_edge;
  for (int k = 0; k < n; ++k) {
    const float* e = p.edge[k];
    const float y0 = e[0], y1 = e[1], x0 = e[2], isl = e[3], ex = e[4], ey = e[5];
    const bool in_win = (y0 > y) != (y1 > y);
    const float xc = x0 + (y - y0) * isl;
    par ^= in_win & (x < xc);
    nr |= (fabsf(y - y0) < ey) | (fabsf(y - y1) < ey) | (in_win & (fabsf(x - xc) < ex));
  }
  parity = par;
  near = nr;
}

// Raster cell class of (x, y) (_raster_cell, _rint_step): the cell id
// cy * nx + cx is an exact f32 integer; a row outside the grid (sentinel
// pad rows, a zero header) is neither full nor partial.
__device__ __forceinline__ void gm_raster(const GmPoly& p, float x, float y, bool& full,
                                          bool& part) {
  const float cx = floorf((x - p.head[0]) * p.head[2]);
  const float cy = floorf((y - p.head[1]) * p.head[3]);
  const float nx = p.head[4], ny = p.head[5];
  bool f = false, q = false;
  if ((cx >= 0.f) & (cx < nx) & (cy >= 0.f) & (cy < ny)) {
    const float c = cy * nx + cx;
    const int n = p.n_rint;
    for (int k = 0; k < n; ++k) {
      const float* r = p.rint[k];
      const bool hit = (c >= r[0]) & (c <= r[1]);
      f |= hit & (r[2] > 0.f);
      q |= hit & (r[2] < 0.f);
    }
  }
  full = f;
  part = q;
}

#define GM_WIDE 1u
#define GM_INNER 2u

// Whether a launch reads the extent columns: the instance of the kernels
// to run.
__host__ __forceinline__ bool gm_extent(int flags) {
  return (flags & (GM_EXTENT | GM_VALID_ON_G)) != 0;
}

// Wide (bit 0) and inner (bit 1) of the row at flat offset r. The spatial
// leg (``leg``: the box slots, or the polygon legs read from ``poly``,
// which may be null otherwise) and the windows AND together; with
// neither, both planes are the row-validity test (isfinite(x), or t0 >= 0
// for a table without coordinates): table pad rows carry never-matching
// sentinels (x = +inf, tbin = tw = -1). The polygon legs combine as
// _masks does: PIP alone wide = parity | near, inner = parity & ~near;
// raster alone wide = full | part, inner = full; both, the ray cast
// decides the partial cells only (a row that is not partial needs none).
template <bool EXT>
__device__ __forceinline__ unsigned gm_row_bits(const GmCols& c, const GmParams& p,
                                                const GmPoly* poly, long long r, int flags,
                                                int leg, int n_box, int n_win) {
  bool w = true, in = true;
  if (EXT && leg == GM_LEG_BOX && (flags & GM_EXTENT)) {
    const float x0 = c.gx0[r], y0 = c.gy0[r], x1 = c.gx1[r], y1 = c.gy1[r];
    bool hit = false;
    for (int k = 0; k < n_box; ++k) {
      const float* b = p.box[k];
      hit |= (x0 <= b[2]) & (x1 >= b[0]) & (y0 <= b[3]) & (y1 >= b[1]);
    }
    w = hit;
    in = false;
  } else if (leg == GM_LEG_BOX) {
    const float x = c.x[r], y = c.y[r];
    bool bw = false, bi = false;
    for (int k = 0; k < n_box; ++k) {
      const float* b = p.box[k];
      bw |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3]);
      bi |= (x >= b[4]) & (x <= b[6]) & (y >= b[5]) & (y <= b[7]);
    }
    w = bw;
    in = bi;
  } else if (leg == GM_LEG_PIP) {
    bool parity, near;
    gm_pip(*poly, c.x[r], c.y[r], parity, near);
    w = parity | near;
    in = parity & !near;
  } else if (leg != GM_LEG_NONE) {
    const float x = c.x[r], y = c.y[r];
    bool full, part;
    gm_raster(*poly, x, y, full, part);
    if (leg == GM_LEG_RAST) {
      w = full | part;
      in = full;
    } else {
      bool parity = false, near = false;
      if (part) gm_pip(*poly, x, y, parity, near);
      w = full | (part & (parity | near));
      in = full | (part & parity & !near);
    }
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
  if (leg == GM_LEG_NONE && !(flags & GM_HAS_WINDOWS)) {
    const bool v = (flags & GM_VALID_ON_T)          ? (c.t0[r] >= 0)
                   : (EXT && (flags & GM_VALID_ON_G)) ? (bool)isfinite(c.gx0[r])
                                                    : (bool)isfinite(c.x[r]);
    w = v;
    in = v;
  }
  return (w ? GM_WIDE : 0u) | (in ? GM_INNER : 0u);
}

// The box, extent, window, packed-time and validity legs alone (the
// aggregation kernels).
template <bool EXT>
__device__ __forceinline__ unsigned gm_row_bits(const GmCols& c, const GmParams& p,
                                                long long r, int flags, int n_box, int n_win) {
  return gm_row_bits<EXT>(c, p, nullptr, r, flags, gm_leg(flags, false), n_box, n_win);
}

// The aggregations' representative point of row r: the point, or the
// extent's bbox centre, each coordinate added then halved in f32 (_rep_xy).
// A pad row's centre is (+inf + -inf) * 0.5 = NaN; callers read it only
// for rows that passed the wide predicate, which no pad row does.
template <bool EXT>
__device__ __forceinline__ void gm_rep_xy(const GmCols& c, long long r, int flags, float& x,
                                          float& y) {
  if (EXT && (flags & GM_EXTENT)) {
    x = __fmul_rn(__fadd_rn(c.gx0[r], c.gx1[r]), 0.5f);
    y = __fmul_rn(__fadd_rn(c.gy0[r], c.gy1[r]), 0.5f);
  } else {
    x = c.x[r];
    y = c.y[r];
  }
}

// Row (j*32 + b)*128 + lane of a block is bit b of word [j, lane] in the
// packed planes: thread (lane, j) walks its 32 rows at stride 128, so each
// load instruction of a warp reads 32 consecutive words.
__device__ __forceinline__ long long gm_row(long long base, int j, int b, int lane) {
  return base + (long long)(j * 32 + b) * GM_LANES + lane;
}

// Density pixel of coordinate v on a grid of ``cells`` over [v0, v0 +
// span]: clip(int((v - v0) / span * n)) in the reference's f32 order,
// each step correctly rounded and the cast truncating (density.cu,
// probe_density.cu).
__device__ __forceinline__ int gm_pixel(float v, float v0, float span, float n, int cells) {
  const int p = __float2int_rz(__fmul_rn(__fdiv_rn(__fsub_rn(v, v0), span), n));
  return min(max(p, 0), cells - 1);
}

__host__ __forceinline__ dim3 gm_block_dim(int sub) {
  const int pack = sub / 32;
  return dim3(GM_LANES, pack < 8 ? pack : 8);
}
