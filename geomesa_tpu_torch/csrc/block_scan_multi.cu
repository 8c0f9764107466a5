// Fused multi-query scan: slot i scans block bids[i] with query qids[i]'s
// box and window slots; wide and inner bit planes per slot.
//
// Replaces the Pallas kernel _pallas_block_scan_multi
// (geomesa_tpu/scan/block_kernels.py:847, body _make_pallas_kernel_multi
// :794) for its box, window, packed-time and validity legs. The per-query
// edge and raster stacks (the point-in-polygon and raster legs) are not
// ported: the wrapper raises NotImplementedError for them.
//
// Bound on the H100: memory, as for block_scan.cu. Each slot reads one
// column block once and writes 1/32 of it per plane; the per-query
// parameters are 0.5 KB, read once per CTA.
//
// Design: K1's mapping, one CTA per slot and thread (lane, j) building one
// word per plane from its 32 rows at stride 128, so no atomics. The CTA
// reads qids[slot] from the staged params and stages only that query's
// box and window slots and that query's two active-slot counts in shared
// memory (masks.cuh): queries of one chunk differ in how many slots they
// use, and a chunk-wide count would drop or add slots. Pad slots carry
// bid 0 and qid 0 and are ignored by the host decode, which reads each
// member's planes from its own slot segment.

#include "masks.cuh"

__global__ void __launch_bounds__(1024)
gm_block_scan_multi_kernel(GmCols c, const int* __restrict__ params, int m, int q, int sub,
                           int flags, int* __restrict__ wide, int* __restrict__ inner) {
  __shared__ GmParams p;
  const int slot = blockIdx.x;
  const int qid = params[m + slot];
  const int* box = params + 2 * m;
  const int* win = box + q * GM_SLOTS * 8;
  const int* counts = win + q * GM_SLOTS * 8;
  gm_load_slots(p, box + qid * GM_SLOTS * 8, win + qid * GM_SLOTS * 8, counts + 2 * qid);
  __syncthreads();
  const int pack = sub >> 5;
  const long long base = (long long)params[slot] * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    unsigned int wbits = 0u, ibits = 0u;
    for (int b = 0; b < 32; ++b) {
      const unsigned m2 = gm_row_bits(c, p, gm_row(base, j, b, lane), flags, n_box, n_win);
      wbits |= (m2 & GM_WIDE) << b;
      ibits |= ((m2 & GM_INNER) >> 1) << b;
    }
    const long long o = ((long long)slot * pack + j) * GM_LANES + lane;
    wide[o] = (int)wbits;
    inner[o] = (int)ibits;
  }
}

// wide, inner: int32 [m, sub/32, 128]. params: bids[m] | qids[m] | the q
// queries' slot words and counts. Returns cudaGetLastError() of the launch.
extern "C" int gm_block_scan_multi(const float* x, const float* y, const int* t0,
                                   const int* t1, const int* params, int m, int q, int sub,
                                   int flags, int* wide, int* inner, void* stream) {
  if (m <= 0) return 0;
  const GmCols c{x, y, t0, t1};
  gm_block_scan_multi_kernel<<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
      c, params, m, q, sub, flags, wide, inner);
  return (int)cudaGetLastError();
}
