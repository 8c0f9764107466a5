// Shared predicate legs of the port's scan-path kernels (block_scan.cu,
// block_scan_multi.cu, block_pops.cu, density.cu, bounds.cu; the probes'
// kernels take only the row indexing, the slot staging and gm_pixel):
// the box, extent, window, packed-time, validity, point-in-polygon and
// raster legs of _masks in geomesa_tpu/scan/block_kernels.py:509-630
// (the polygon legs after _pip_edge_step :418, _rint_step :460 and
// _raster_cell :471), and the aggregations' representative point (_rep_xy,
// geomesa_tpu/scan/aggregations.py:46), evaluated for R rows of a
// [n_blocks, SUB, 128] column block at once. Each leg loops over its
// slots, edges or intervals outside and over the R rows inside, so a
// slot's words are read once for the R rows, and each row's truth value
// is a bit of a row mask. The scans (scan_tile.cuh's row-batched body)
// take 8 rows a thread, K3 its rows of a tile, K1p and K4 one row at a
// time (gm_row_bits). The two scan kernels take the polygon legs; the
// aggregation kernels never do.
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
// A kernel stages the slot words in shared memory (gm_load_slots), each
// slot's eight words 16-byte aligned so a leg reads a plane's four in one
// load.
//
// A fused chunk of q queries (block_scan_multi.cu) sends one buffer too,
//     params = bids[m] | qids[m] | boxes[q][8][8] | wins[q][8][8]
//              | (n_box_slots, n_win_slots)[q]
// and each warp stages the slot words and counts of the query it scans:
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
// The legs read a block in place through the read-only path (GmPoly): an
// edge's six words and an interval's three are one broadcast load each per
// batch of rows.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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

struct __align__(16) GmParams {
  float box[GM_SLOTS][8];
  int win[GM_SLOTS][8];
  int n_box, n_win;  // slots before the trailing pad slots
};

// offset of the words after the slot counts (the density grid bounds, or
// the scan's polygon block)
#define GM_EXTRA(m) ((m) + 2 * GM_SLOTS * 8 + 2)

// int32 words of one polygon block at the given caps
__host__ __device__ __forceinline__ int gm_poly_words(int e_cap, int r_cap) {
  return 2 + GM_EDGE_LANES * e_cap + GM_HEAD_LANES + GM_RINT_LANES * r_cap;
}

// One query's polygon block, read in place: its real edges and intervals
// (global memory, read-only path) and the raster header in registers.
struct GmPoly {
  const float* edge;
  const float* rint;
  float head[GM_HEAD_LANES];
  int n_edge, n_rint;
};

// The polygon block at ``blk`` (layout above); its header is read only
// where the raster leg is on.
__device__ __forceinline__ GmPoly gm_poly(const int* blk, int e_cap, int flags) {
  GmPoly p;
  p.n_edge = __ldg(blk);
  p.n_rint = __ldg(blk + 1);
  p.edge = reinterpret_cast<const float*>(blk + 2);
  const float* h = p.edge + GM_EDGE_LANES * e_cap;
  p.rint = h + GM_HEAD_LANES;
#pragma unroll
  for (int k = 0; k < GM_HEAD_LANES; ++k)
    p.head[k] = (flags & GM_HAS_RAST) ? __ldg(h + k) : 0.f;
  return p;
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
// active-slot counts in shared memory, thread t of the nt that share the
// copy (a CTA, or one warp). The caller synchronises them before reading.
__device__ __forceinline__ void gm_load_slots(GmParams& p, const int* box, const int* win,
                                              const int* counts, int t, int nt) {
  for (int i = t; i < GM_SLOTS * 8; i += nt) {
    p.box[i >> 3][i & 7] = __int_as_float(box[i]);
    p.win[i >> 3][i & 7] = win[i];
  }
  if (t == 0) {
    p.n_box = counts[0];
    p.n_win = counts[1];
  }
}

// Stage the slot words of a one-query ``params`` (after the m bids), the
// whole CTA sharing the copy; the caller runs __syncthreads().
__device__ __forceinline__ void gm_load_params(GmParams& p, const int* params, int m) {
  gm_load_slots(p, params + m, params + m + GM_SLOTS * 8, params + m + 2 * GM_SLOTS * 8,
                gm_tid(), GM_SLOTS * 8);
}

// Row masks: the legs of R <= 32 rows keep each per-row truth value as
// bit r of a 32-bit mask (GmMask), so a batch's accumulators cost a
// register each, not one per row.
typedef unsigned GmMask;

template <int R>
__device__ __forceinline__ GmMask gm_all_rows() {
  return R == 32 ? ~0u : (1u << R) - 1u;
}

// Even-odd ray cast of R rows (x, y) over the real edges (_pip_edge_step),
// edge outside and rows inside: each edge's six words are read once for
// the R rows. The crossing abscissa is a separate multiply and add
// (--fmad=false), as in the reference's f32 order; near = within an
// edge's uncertainty band. Parity and near bits per row.
template <int R>
__device__ __forceinline__ void gm_pip(const GmPoly& p, const float (&x)[R], const float (&y)[R],
                                       GmMask& parity, GmMask& near) {
  GmMask par = 0u, nr = 0u;
  const int n = p.n_edge;
  for (int k = 0; k < n; ++k) {
    const float* e = p.edge + k * GM_EDGE_LANES;
    const float y0 = __ldg(e), y1 = __ldg(e + 1), x0 = __ldg(e + 2), isl = __ldg(e + 3),
                ex = __ldg(e + 4), ey = __ldg(e + 5);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in_win = (y0 > y[r]) != (y1 > y[r]);
      const float xc = x0 + (y[r] - y0) * isl;
      par ^= (GmMask)(in_win & (x[r] < xc)) << r;
      nr |= (GmMask)((fabsf(y[r] - y0) < ey) | (fabsf(y[r] - y1) < ey) |
                     (in_win & (fabsf(x[r] - xc) < ex))) << r;
    }
  }
  parity = par;
  near = nr;
}

// The ray casts of the rows set in ``rows``, one row a lane at a time with
// the warp's lanes together: each round every lane casts its next such row
// (a lane with none left casts a dummy), for as many rounds as the most
// rows any lane holds, so sparse rows cost a round or two and dense ones
// no more than gm_pip over all R. A warp collective: every lane of the
// warp calls it.
template <int R>
__device__ __forceinline__ void gm_pip_rows(const GmPoly& p, const float (&x)[R],
                                            const float (&y)[R], GmMask rows, GmMask& parity,
                                            GmMask& near) {
  GmMask par = 0u, nr = 0u;
  const int rounds = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(rows));
  for (int i = 0; i < rounds; ++i) {
    const int r = __ffs(rows) - 1;  // -1: none left
    float xr[1] = {0.f}, yr[1] = {0.f};
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k == r) {
        xr[0] = x[k];
        yr[0] = y[k];
      }
    }
    GmMask pb, nb;
    gm_pip<1>(p, xr, yr, pb, nb);
    if (r >= 0) {
      par |= pb << r;
      nr |= nb << r;
      rows &= rows - 1u;
    }
  }
  parity = par;
  near = nr;
}

// Raster cell class of R rows (_raster_cell, _rint_step), interval outside
// and rows inside: the cell id cy * nx + cx is an exact f32 integer; a row
// outside the grid (sentinel pad rows, a zero header) is neither full nor
// partial, and a batch with no row in the grid walks no interval.
template <int R>
__device__ __forceinline__ void gm_raster(const GmPoly& p, const float (&x)[R],
                                          const float (&y)[R], GmMask& full, GmMask& part) {
  const float nx = p.head[4], ny = p.head[5];
  float c[R];
  GmMask in = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float cx = floorf((x[r] - p.head[0]) * p.head[2]);
    const float cy = floorf((y[r] - p.head[1]) * p.head[3]);
    in |= (GmMask)((cx >= 0.f) & (cx < nx) & (cy >= 0.f) & (cy < ny)) << r;
    c[r] = cy * nx + cx;
  }
  GmMask f = 0u, q = 0u;
  const int n = in ? p.n_rint : 0;
  for (int k = 0; k < n; ++k) {
    const float* s = p.rint + k * GM_RINT_LANES;
    const float lo = __ldg(s), hi = __ldg(s + 1), cls = __ldg(s + 2);
    GmMask hit = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) hit |= (GmMask)((c[r] >= lo) & (c[r] <= hi)) << r;
    hit &= in;
    f |= cls > 0.f ? hit : 0u;
    q |= cls < 0.f ? hit : 0u;
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

// Wide and inner row masks of R rows from the polygon legs (``leg``): PIP
// alone wide = parity | near, inner = parity & ~near; raster alone wide =
// full | part, inner = full; both, the ray cast decides each row in a
// partial cell and no other, row by row (gm_pip_rows). With another leg
// every row keeps both bits for gm_leg_bits. x, y are the rows' points. A
// warp collective where the leg is both (the scans' warp tiles).
template <int R>
__device__ __forceinline__ void gm_poly_bits(const GmPoly& p, int leg, const float (&x)[R],
                                             const float (&y)[R], GmMask& w, GmMask& in) {
  GmMask par = 0u, near = 0u;
  if (leg == GM_LEG_PIP) {
    gm_pip<R>(p, x, y, par, near);
    w = par | near;
    in = par & ~near;
  } else if (leg == GM_LEG_RAST || leg == GM_LEG_RAST_PIP) {
    GmMask full, part;
    gm_raster<R>(p, x, y, full, part);
    if (leg == GM_LEG_RAST_PIP) {
      gm_pip_rows<R>(p, x, y, part, par, near);
      w = full | (part & (par | near));
      in = full | (part & par & ~near);
    } else {
      // the raster alone: a partial cell is wide, never inner
      w = full | (leg == GM_LEG_RAST ? part : 0u);
      in = full;
    }
  } else {
    w = in = gm_all_rows<R>();
  }
}

// Wide and inner row masks of R rows from their loaded values: the box leg
// (``leg`` GM_LEG_BOX) or the spatial masks w, in hold on entry (the
// polygon legs', or all rows), ANDed with the windows; with neither, both
// planes are the row-validity test (isfinite(a), or t0 >= 0 for a table
// without coordinates): table pad rows carry never-matching sentinels
// (x = +inf, tbin = tw = -1). a, b, e, f are x and y of a point, or
// gxmin, gymin, gxmax, gymax of an extent (an extent box leg is
// bbox-intersects, its inner plane all false); t0 is tbin or the packed
// tw, t1 toff. Values a query does not read are never looked at. Each leg
// walks its slots outside and the rows inside.
template <bool EXT, int R>
__device__ __forceinline__ void gm_leg_bits(const GmParams& p, int flags, int leg, int n_box,
                                            int n_win, const float (&a)[R], const float (&b)[R],
                                            const float (&e)[R], const float (&f)[R],
                                            const int (&t0)[R], const int (&t1)[R], GmMask& w,
                                            GmMask& in) {
  if (EXT && leg == GM_LEG_BOX && (flags & GM_EXTENT)) {
    GmMask hit = 0u;
    for (int k = 0; k < n_box; ++k) {
      const float4 s = *reinterpret_cast<const float4*>(p.box[k]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        hit |= (GmMask)((a[r] <= s.z) & (e[r] >= s.x) & (b[r] <= s.w) & (f[r] >= s.y)) << r;
    }
    w = hit;
    in = 0u;
  } else if (leg == GM_LEG_BOX) {
    GmMask bw = 0u, bi = 0u;
    for (int k = 0; k < n_box; ++k) {
      const float4 s = *reinterpret_cast<const float4*>(p.box[k]);
      const float4 u = *reinterpret_cast<const float4*>(p.box[k] + 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bw |= (GmMask)((a[r] >= s.x) & (a[r] <= s.z) & (b[r] >= s.y) & (b[r] <= s.w)) << r;
        bi |= (GmMask)((a[r] >= u.x) & (a[r] <= u.z) & (b[r] >= u.y) & (b[r] <= u.w)) << r;
      }
    }
    w = bw;
    in = bi;
  }
  if (flags & GM_HAS_WINDOWS) {
    int tb[R], to[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tb[r] = t0[r];
      to[r] = t1[r];
      if (flags & GM_PACKED_TW) {
        // arithmetic shift: the pad sentinel -1 stays bin -1, never a real bin
        tb[r] = t0[r] >> GM_TW_BITS;
        to[r] = t0[r] & GM_TW_MASK;
      }
    }
    GmMask ww = 0u, wi = 0u;
    for (int k = 0; k < n_win; ++k) {
      const int4 s = *reinterpret_cast<const int4*>(p.win[k]);
      const int4 u = *reinterpret_cast<const int4*>(p.win[k] + 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ww |= (GmMask)((tb[r] >= s.x) & (tb[r] <= s.y) & (to[r] >= s.z) & (to[r] <= s.w)) << r;
        wi |= (GmMask)((tb[r] >= u.x) & (tb[r] <= u.y) & (to[r] >= u.z) & (to[r] <= u.w)) << r;
      }
    }
    w &= ww;
    in &= wi;
  }
  if (leg == GM_LEG_NONE && !(flags & GM_HAS_WINDOWS)) {
    GmMask v = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v |= (GmMask)((flags & GM_VALID_ON_T) ? (t0[r] >= 0) : (bool)isfinite(a[r])) << r;
    w = in = v;
  }
}

// Load what the legs read of V neighbouring rows from flat offset r (V = 1,
// or 4 as one 16-byte load a column, r a multiple of 4): row k of the V
// into entry o + k * STRIDE of the value arrays. The extent columns for an
// extent box leg, x and y for the point box leg and the polygon legs, the
// time columns where the windows or the validity test read them:
// coordinates first, then the times; nothing is compared until the caller
// has issued every load of its rows.
template <int V, int STRIDE, typename T, int R>
__device__ __forceinline__ void gm_load_col(const T* __restrict__ col, long long r, int o,
                                            T (&v)[R]) {
  if constexpr (V == 4) {
    const auto q = *reinterpret_cast<const typename std::conditional<
        std::is_same<T, float>::value, float4, int4>::type*>(col + r);
    v[o] = q.x;
    v[o + STRIDE] = q.y;
    v[o + 2 * STRIDE] = q.z;
    v[o + 3 * STRIDE] = q.w;
  } else {
    v[o] = col[r];
  }
}

template <bool EXT, int V, int STRIDE = 1, int R>
__device__ __forceinline__ void gm_load_rows(const GmCols& c, long long r, int flags, int leg,
                                             int o, float (&a)[R], float (&b)[R], float (&e)[R],
                                             float (&f)[R], int (&t0)[R], int (&t1)[R]) {
  if (EXT && leg == GM_LEG_BOX && (flags & GM_EXTENT)) {
    gm_load_col<V, STRIDE>(c.gx0, r, o, a);
    gm_load_col<V, STRIDE>(c.gy0, r, o, b);
    gm_load_col<V, STRIDE>(c.gx1, r, o, e);
    gm_load_col<V, STRIDE>(c.gy1, r, o, f);
  } else if (leg != GM_LEG_NONE) {
    gm_load_col<V, STRIDE>(c.x, r, o, a);
    gm_load_col<V, STRIDE>(c.y, r, o, b);
  }
  const bool valid_leg = leg == GM_LEG_NONE && !(flags & GM_HAS_WINDOWS);
  if ((flags & GM_HAS_WINDOWS) || (valid_leg && (flags & GM_VALID_ON_T)))
    gm_load_col<V, STRIDE>(c.t0, r, o, t0);
  if ((flags & GM_HAS_WINDOWS) && !(flags & GM_PACKED_TW))
    gm_load_col<V, STRIDE>(c.t1, r, o, t1);
  if (valid_leg && !(flags & GM_VALID_ON_T))
    gm_load_col<V, STRIDE>((EXT && (flags & GM_VALID_ON_G)) ? c.gx0 : c.x, r, o, a);
}

// Wide and inner of the row at flat offset r through the box, extent,
// window, packed-time and validity legs (the aggregation kernels).
template <bool EXT>
__device__ __forceinline__ unsigned gm_row_bits(const GmCols& c, const GmParams& p,
                                                long long r, int flags, int n_box, int n_win) {
  float a[1] = {0.f}, b[1] = {0.f}, e[1] = {0.f}, f[1] = {0.f};
  int t0[1] = {0}, t1[1] = {0};
  const int leg = gm_leg(flags, false);
  gm_load_rows<EXT, 1>(c, r, flags, leg, 0, a, b, e, f, t0, t1);
  GmMask w = 1u, in = 1u;
  gm_leg_bits<EXT, 1>(p, flags, leg, n_box, n_win, a, b, e, f, t0, t1, w, in);
  return (w ? GM_WIDE : 0u) | (in ? GM_INNER : 0u);
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
