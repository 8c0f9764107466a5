// Candidate-block scan: wide and inner bit planes of one query.
//
// Replaces the Pallas kernel _pallas_block_scan
// (geomesa_tpu/scan/block_kernels.py:685, body _make_pallas_kernel :654,
// _masks :509, _pack_bits :636): its box, window, packed-time, validity,
// point-in-polygon, raster and extent legs. An extent box scan writes the
// wide plane alone (skip_inner_plane :645; inner is null), since its
// inner plane is identically false.
//
// Bound on the H100: memory for the box and window legs. Each row is read
// once (8-16 B of columns) and costs a handful of compares, far below the
// card's 20 f32 operations per byte; the planes written back are 1/32 of a
// column each. The polygon legs move the bound to operations: the ray
// cast costs 22 operations per row and edge (a 56-edge polygon ~1,200 per
// row), the raster leg 15 per row plus 9 per row and interval: a row of
// 16 B balances 320 operations, so past ~15 edges or ~34 intervals per row
// the compares, not the bytes, set the bound.
//
// Design (scan_tile.cuh, the body K2 shares): the slots' rows are cut
// into warp tiles of 32 stripes x 32 lanes spread in even runs over whole
// waves of resident CTAs, so M = 32 puts every SM to work and M = 4096
// ends on whole waves. A thread owns four neighbouring lanes of 8 stripes:
// it issues a batch's 16-byte column loads (2 stripes, 8 rows) before any
// compare, then runs the legs with the slot, edge and interval loops
// outside and the batch's rows inside, so a slot's words (shared memory,
// staged once per CTA) and an edge's or interval's (the polygon block,
// read in place through the read-only path) are read once a batch, not
// once a row. Each row's truth is a bit of a mask; each lane's bits move
// into its words, the chunks of a quad meet by two shuffles, and each
// quad's four words leave as one 16-byte store: no atomics, no
// shared-memory reduction. The legs loop over the query's real slots,
// edges and intervals only; when both polygon legs ride together the ray
// cast runs only for rows in the raster's partial cells, each lane casting
// its own such rows one at a time with the warp's lanes together. The
// extent leg reads four f32 columns per row and writes one plane. Pad
// slots repeat block 0 and are ignored by the host decode.

#include "scan_tile.cuh"

template <bool EXT, bool POLY>
__global__ void __launch_bounds__(GS_THREADS)
gm_block_scan_kernel(GmCols c, const int* __restrict__ params, int m, int sub, int flags,
                     int e_cap, int* __restrict__ wide, int* __restrict__ inner) {
  __shared__ GmParams p;
  gm_load_params(p, params, m);
  __syncthreads();
  const GmPoly poly = (flags & (GM_HAS_EDGES | GM_HAS_RAST))
                          ? gm_poly(params + GM_EXTRA(m), e_cap, flags)
                          : GmPoly{};
  const int leg = gm_leg(flags, true);
  const int pack = sub >> 5;
  int begin, end;
  gs_run(m, pack, begin, end);
  for (int t = begin; t < end; ++t) {
    const GsTile tile = gs_tile(t, pack);
    gs_scan_tile<EXT, POLY>(c, p, poly, flags, leg, (long long)params[tile.slot] * sub * GM_LANES,
                      tile, pack, wide, inner);
  }
}

// resident CTAs of each instance (point, extent, polygon), per device
static std::atomic<int> gm_block_scan_resident[3][GS_MAX_DEVICES];

// wide, inner: int32 [m, sub/32, 128], 16-byte aligned like every column;
// inner null writes the wide plane alone. e_cap, r_cap: the polygon
// block's edge and interval caps (0 without the polygon legs). Returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int gm_block_scan(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                             int e_cap, int r_cap, int* wide, int* inner, void* stream) {
  if (m <= 0) return 0;
  if (e_cap > GM_MAX_EDGES || r_cap > GM_MAX_RINTS) return (int)cudaErrorInvalidValue;
  const GmCols c = GM_COLS;
  const cudaStream_t s = (cudaStream_t)stream;
  // the instance: extent columns, polygon legs, or the point legs
  const int inst = gm_extent(flags) ? 1 : (flags & (GM_HAS_EDGES | GM_HAS_RAST)) ? 2 : 0;
  std::atomic<int>* res = gm_block_scan_resident[inst];
  if (inst == 1)
    return gs_launch(gm_block_scan_kernel<true, false>, res, m, sub, s, c, params, m, sub, flags,
                     e_cap, wide, inner);
  if (inst == 2)
    return gs_launch(gm_block_scan_kernel<false, true>, res, m, sub, s, c, params, m, sub, flags,
                     e_cap, wide, inner);
  return gs_launch(gm_block_scan_kernel<false, false>, res, m, sub, s, c, params, m, sub, flags,
                   e_cap, wide, inner);
}
