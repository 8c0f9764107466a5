// Density grid: count of wide-predicate hits per pixel.
//
// Replaces the Pallas kernel _pallas_density
// (geomesa_tpu/scan/aggregations.py:244, body _make_density_kernel :187),
// which built the histogram as a bf16 one-hot matmul on the TPU's matrix
// unit, and the XLA scatter it fell back to for grids without a VMEM fit
// (_density_chunk :169). Every leg: on an extent table a row's point is
// its bbox centre (_rep_xy :46), read only after the row passed the wide
// predicate, so no pad row's NaN centre ever reaches a pixel cast.
//
// Bound on the H100: memory for the column reads; the scattered
// increments are the other cost, and they collide on hot pixels of
// clustered data.
//
// Design: a simple, exact histogram. One CTA per candidate slot (pad
// slots, bid < 0, return at once); per row the predicate legs, then the
// representative point, the closed envelope test and the pixel, rounded
// exactly like the reference's f32 arithmetic ((x - x0) / (x1 - x0) * W,
// truncated, clipped), then one atomicAdd on an int32 [H, W] grid in
// device memory that the wrapper zeroes. Counts are exact integers, so
// the grid equals the JAX grid bit for bit. Privatizing the grid in shared memory is later work: the
// default 256 x 256 int32 grid is 256 KB, above the 227 KB a block has.

#include "masks.cuh"

template <bool EXT>
__global__ void __launch_bounds__(1024)
gm_density_kernel(GmCols c, const int* __restrict__ params, int m, int sub,
                  int flags, int width, int height, int* __restrict__ grid) {
  __shared__ GmParams p;
  __shared__ float gb[4];
  gm_load_params(p, params, m);
  const int tid = gm_tid();
  if (tid < 4) gb[tid] = __int_as_float(params[GM_EXTRA(m) + tid]);
  __syncthreads();
  const int bid = params[blockIdx.x];
  if (bid < 0) return;  // pad slot: uniform across the CTA
  const float x0 = gb[0], y0 = gb[1], x1 = gb[2], y1 = gb[3];
  const float sx = __fsub_rn(x1, x0), sy = __fsub_rn(y1, y0);
  const float fw = (float)width, fh = (float)height;
  const int pack = sub >> 5;
  const long long base = (long long)bid * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    for (int b = 0; b < 32; ++b) {
      const long long r = gm_row(base, j, b, lane);
      if (!(gm_row_bits<EXT>(c, p, r, flags, n_box, n_win) & GM_WIDE)) continue;
      float x, y;
      gm_rep_xy<EXT>(c, r, flags, x, y);
      if (!((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1))) continue;
      const int px = gm_pixel(x, x0, sx, fw, width);
      const int py = gm_pixel(y, y0, sy, fh, height);
      atomicAdd(grid + py * width + px, 1);
    }
  }
}

// grid: int32 [height, width], zeroed by the caller. params: bids[m] |
// boxes | wins | slot counts | grid bounds (x0, y0, x1, y1) as f32 bits.
extern "C" int gm_density(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                          int width, int height, int* grid, void* stream) {
  if (m <= 0) return 0;
  const GmCols c = GM_COLS;
  if (gm_extent(flags))
    gm_density_kernel<true><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, width, height, grid);
  else
    gm_density_kernel<false><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, width, height, grid);
  return (int)cudaGetLastError();
}
