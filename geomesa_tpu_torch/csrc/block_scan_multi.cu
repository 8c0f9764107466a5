// Fused multi-query scan: slot i scans block bids[i] with query qids[i]'s
// box and window slots, or its polygon legs; wide and inner bit planes
// per slot.
//
// Replaces the Pallas kernel _pallas_block_scan_multi
// (geomesa_tpu/scan/block_kernels.py:847, body _make_pallas_kernel_multi
// :794): its box, window, packed-time, validity, point-in-polygon, raster
// and extent legs, with the per-query edge and raster stacks and the
// per-slot selector spip (:870-886). Extent members fuse on the wide plane
// alone (no edge or raster stacks; inner is null for a box chunk).
//
// Bound on the H100: memory for box chunks, as for block_scan.cu. Each
// slot reads one column block once and writes 1/32 of it per plane; the
// per-query parameters are 0.5 KB, read once per CTA. A chunk with an
// edge stack is bound by operations, like block_scan.cu's polygon legs
// (each slot's rows walk its own query's real edges); a raster stack of
// 16 intervals stays bound by bytes.
//
// Design: K1's mapping, one CTA per slot and thread (lane, j) building one
// word per plane from its 32 rows at stride 128, so no atomics. The CTA
// reads qids[slot] (and spip[slot]) from the staged params and stages
// only that query's box and window slots, its two active-slot counts and,
// for a polygon slot, that query's polygon block (its real edge and
// interval counts and the lanes the legs read) in shared memory
// (masks.cuh): queries of one chunk differ in how many slots, edges and
// intervals they use, and a chunk-wide count would drop or add rows. The
// TPU's [Q, E, 128] f32 stacks never travel: the host sends six lanes per
// edge and three per interval, for the queries the polygon slots read. A
// slot whose spip is 0 takes the box leg even when the chunk carries
// stacks. Pad slots carry bid 0, qid 0 and spip 0 and are ignored by the
// host decode, which reads each member's planes from its own slot segment.

#include "masks.cuh"

template <bool EXT>
__global__ void __launch_bounds__(1024)
gm_block_scan_multi_kernel(GmCols c, const int* __restrict__ params, int m, int q, int sub,
                           int flags, int e_cap, int r_cap, int* __restrict__ wide,
                           int* __restrict__ inner) {
  __shared__ GmParams p;
  __shared__ GmPoly poly;
  const int slot = blockIdx.x;
  const int qid = params[m + slot];
  const bool stacks = flags & (GM_HAS_EDGES | GM_HAS_RAST);
  const bool poly_slot = stacks && params[2 * m + slot] > 0;
  const int* box = params + (stacks ? 3 : 2) * m;
  const int* win = box + q * GM_SLOTS * 8;
  const int* counts = win + q * GM_SLOTS * 8;
  gm_load_slots(p, box + qid * GM_SLOTS * 8, win + qid * GM_SLOTS * 8, counts + 2 * qid);
  if (poly_slot) {
    const int* blocks = counts + 2 * q;
    gm_load_poly(poly, blocks + (long long)qid * gm_poly_words(e_cap, r_cap), e_cap, r_cap);
  }
  __syncthreads();
  const int pack = sub >> 5;
  const long long base = (long long)params[slot] * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  const int leg = gm_leg(flags, poly_slot);
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
// alone. params: bids[m] | qids[m] | (spip[m]) | the q queries' slot words
// and counts | (their polygon blocks at caps e_cap, r_cap: the chunk's
// buckets). Returns cudaGetLastError() of the launch.
extern "C" int gm_block_scan_multi(GM_COL_ARGS, const int* params, int m, int q, int sub,
                                   int flags, int e_cap, int r_cap, int* wide, int* inner,
                                   void* stream) {
  if (m <= 0) return 0;
  if (e_cap > GM_MAX_EDGES || r_cap > GM_MAX_RINTS) return (int)cudaErrorInvalidValue;
  const GmCols c = GM_COLS;
  if (gm_extent(flags))
    gm_block_scan_multi_kernel<true><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, q, sub, flags, e_cap, r_cap, wide, inner);
  else
    gm_block_scan_multi_kernel<false><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, q, sub, flags, e_cap, r_cap, wide, inner);
  return (int)cudaGetLastError();
}
