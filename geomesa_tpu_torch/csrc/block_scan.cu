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
// Design: one CTA per candidate slot i, reading block bids[i]. Thread
// (lane, j) reads its 32 rows at stride 128 (coalesced across lanes),
// builds one uint32 word per plane by shifts and stores it as int32, so
// no atomics and no shared-memory reduction are needed. The box and
// window slots, and the query's polygon block (its real edges and
// intervals, only the lanes the legs read), are staged in shared memory
// once per CTA; every thread then walks them row by row, edge-inner, each
// edge a broadcast read. The extent leg reads four f32 columns per row
// (16 B, four compares per active slot) and writes one plane. The legs
// loop over the query's real slots, edges and intervals only, and the ray
// cast runs only on the raster's partial cells when both polygon legs
// ride together. Pad slots repeat block 0 and are ignored by the host
// decode.

#include "masks.cuh"

template <bool EXT>
__global__ void __launch_bounds__(1024)
gm_block_scan_kernel(GmCols c, const int* __restrict__ params, int m, int sub,
                     int flags, int e_cap, int r_cap, int* __restrict__ wide,
                     int* __restrict__ inner) {
  __shared__ GmParams p;
  __shared__ GmPoly poly;
  gm_load_params(p, params, m);
  if (flags & (GM_HAS_EDGES | GM_HAS_RAST)) gm_load_poly(poly, params + GM_EXTRA(m), e_cap, r_cap);
  __syncthreads();
  const int slot = blockIdx.x;
  const int pack = sub >> 5;
  const long long base = (long long)params[slot] * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  const int leg = gm_leg(flags, true);
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    unsigned int wbits = 0u, ibits = 0u;
    for (int b = 0; b < 32; ++b) {
      const unsigned m2 =
          gm_row_bits<EXT>(c, p, &poly, gm_row(base, j, b, lane), flags, leg, n_box, n_win);
      wbits |= (m2 & GM_WIDE) << b;
      ibits |= ((m2 & GM_INNER) >> 1) << b;
    }
    const long long o = ((long long)slot * pack + j) * GM_LANES + lane;
    wide[o] = (int)wbits;
    if (inner) inner[o] = (int)ibits;
  }
}

// wide, inner: int32 [m, sub/32, 128]; inner null writes the wide plane
// alone. e_cap, r_cap: the polygon block's edge and interval caps (0
// without the polygon legs). Returns cudaGetLastError() of the launch
// (0 = launched).
extern "C" int gm_block_scan(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                             int e_cap, int r_cap, int* wide, int* inner, void* stream) {
  if (m <= 0) return 0;
  if (e_cap > GM_MAX_EDGES || r_cap > GM_MAX_RINTS) return (int)cudaErrorInvalidValue;
  const GmCols c = GM_COLS;
  if (gm_extent(flags))
    gm_block_scan_kernel<true><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, e_cap, r_cap, wide, inner);
  else
    gm_block_scan_kernel<false><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, e_cap, r_cap, wide, inner);
  return (int)cudaGetLastError();
}
