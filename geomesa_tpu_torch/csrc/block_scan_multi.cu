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
// per-query parameters are 0.5 KB, staged once per warp and query. A chunk with an
// edge stack is bound by operations, like block_scan.cu's polygon legs
// (each slot's rows walk its own query's real edges); a raster stack of
// 16 intervals stays bound by bytes.
//
// Design: K1's row-batched body (scan_tile.cuh) over the same warp tiles,
// spread in even runs over whole waves of resident CTAs. A tile reads
// qids[slot] (and spip[slot]) from the staged params; each warp keeps the
// slot words and two active-slot counts of the query it scans in its own
// shared-memory copy and restages them only when its tile's query
// changes (tiles of a run walk a slot's word groups in turn), so queries of
// one chunk, which differ in how many slots, edges and intervals they use,
// never share a chunk-wide count. A polygon slot reads its query's polygon
// block in place (its real edge and interval counts and the lanes the legs
// read) through the read-only path. The TPU's [Q, E, 128] f32 stacks never
// travel: the host sends six lanes per edge and three per interval, for
// the queries the polygon slots read. A slot whose spip is 0 takes the box
// leg even when the chunk carries stacks. Pad slots carry bid 0, qid 0 and
// spip 0 and are ignored by the host decode, which reads each member's
// planes from its own slot segment.

#include "scan_tile.cuh"

template <bool EXT, bool POLY>
__global__ void __launch_bounds__(GS_THREADS)
gm_block_scan_multi_kernel(GmCols c, const int* __restrict__ params, int m, int q, int sub,
                           int flags, int e_cap, int r_cap, int* __restrict__ wide,
                           int* __restrict__ inner) {
  __shared__ GmParams staged[GS_WARPS];
  GmParams& p = staged[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const bool stacks = (flags & (GM_HAS_EDGES | GM_HAS_RAST)) != 0;
  const int* box = params + (stacks ? 3 : 2) * m;
  const int* win = box + q * GM_SLOTS * 8;
  const int* counts = win + q * GM_SLOTS * 8;
  const int* blocks = counts + 2 * q;
  const int words = gm_poly_words(e_cap, r_cap);
  const int pack = sub >> 5;
  int begin, end;
  gs_run(m, pack, begin, end);
  int qid_staged = -1;
  GmPoly poly{};
  for (int t = begin; t < end; ++t) {
    const GsTile tile = gs_tile(t, pack);
    const int qid = params[m + tile.slot];
    const bool poly_slot = stacks && params[2 * m + tile.slot] > 0;
    if (qid != qid_staged) {  // uniform across the warp
      __syncwarp();
      gm_load_slots(p, box + qid * GM_SLOTS * 8, win + qid * GM_SLOTS * 8, counts + 2 * qid,
                    lane, 32);
      __syncwarp();
      qid_staged = qid;
    }
    if (poly_slot) poly = gm_poly(blocks + (long long)qid * words, e_cap, flags);
    gs_scan_tile<EXT, POLY>(c, p, poly, flags, gm_leg(flags, poly_slot),
                      (long long)params[tile.slot] * sub * GM_LANES, tile, pack, wide, inner);
  }
}

// resident CTAs of each instance (point, extent, polygon), per device
static std::atomic<int> gm_block_scan_multi_resident[3][GS_MAX_DEVICES];

// wide, inner: int32 [m, sub/32, 128], 16-byte aligned like every column;
// inner null writes the wide plane alone. params: bids[m] | qids[m] |
// (spip[m]) | the q queries' slot words and counts | (their polygon blocks
// at caps e_cap, r_cap: the chunk's buckets). Returns cudaGetLastError()
// of the launch.
extern "C" int gm_block_scan_multi(GM_COL_ARGS, const int* params, int m, int q, int sub,
                                   int flags, int e_cap, int r_cap, int* wide, int* inner,
                                   void* stream) {
  if (m <= 0) return 0;
  if (e_cap > GM_MAX_EDGES || r_cap > GM_MAX_RINTS) return (int)cudaErrorInvalidValue;
  const GmCols c = GM_COLS;
  const cudaStream_t s = (cudaStream_t)stream;
  // the instance: extent columns, polygon legs, or the point legs
  const int inst = gm_extent(flags) ? 1 : (flags & (GM_HAS_EDGES | GM_HAS_RAST)) ? 2 : 0;
  std::atomic<int>* res = gm_block_scan_multi_resident[inst];
  if (inst == 1)
    return gs_launch(gm_block_scan_multi_kernel<true, false>, res, m, sub, s, c, params, m, q, sub,
                     flags, e_cap, r_cap, wide, inner);
  if (inst == 2)
    return gs_launch(gm_block_scan_multi_kernel<false, true>, res, m, sub, s, c, params, m, q, sub,
                     flags, e_cap, r_cap, wide, inner);
  return gs_launch(gm_block_scan_multi_kernel<false, false>, res, m, sub, s, c, params, m, q, sub,
                   flags, e_cap, r_cap, wide, inner);
}
