// Density grid: count of wide-predicate hits per pixel.
//
// Replaces the Pallas kernel _pallas_density
// (geomesa_tpu/scan/aggregations.py:244, body _make_density_kernel :187),
// which built the histogram as a bf16 one-hot matmul on the TPU's matrix
// unit, and the XLA scatter it fell back to for grids without a VMEM fit
// (_density_chunk :169). Every leg: on an extent table a row's point is
// its bbox centre (_rep_xy :46), used only after the row passed the wide
// predicate, so no pad row's NaN centre ever reaches a pixel.
//
// Bound on the H100: memory for the column reads (each row read once); the
// increments are the other cost, and they collide on the hot pixels of
// clustered data.
//
// Design, for this card. The candidate slots' rows are cut into tiles; a
// CTA of 512 threads walks a run of tiles, 8 rows a thread per tile on a
// point table (4 on an extent table, whose 4 bbox columns need the
// registers), neighbouring threads on neighbouring rows. The runs split
// the tiles evenly over whole waves of resident CTAs.
// - Loads off the increments: a thread first issues the loads of all its
//   rows of the tile (the coordinate columns, then the time columns where
//   the query reads them), only then evaluates the predicate and the
//   pixel of each, keeping a flat pixel or -1 in registers, and only then
//   increments. No load waits behind an atomic.
// - Compaction: each warp packs its hits of the tile into a shared list
//   (__ballot_sync / __popc offsets), so the increments run 32 hits a step
//   with no idle lane.
// - Hot pixels: the increments are atomics on the int32 grid in device
//   memory; lanes of a step holding the same pixel are grouped
//   (__match_any_sync) and the group's leader adds the group's count, one
//   atomic per distinct pixel of the step.
// Counts are exact integers in any order of the atomics, so the grid
// equals the plain version and the JAX grid bit for bit. The predicate is
// masks.cuh's (gm_leg_bits on the loaded values of the thread's rows of
// the tile at once: each slot's words are read once for them); the pixel
// keeps the reference's f32 order (gm_pixel, built with --fmad=false); a
// pad slot (bid < 0) counts nothing.

#include "masks.cuh"

#define GD_THREADS 512
#define GD_WARPS (GD_THREADS / 32)
#define GD_MAX_RPT 8
#define GD_CTA_ROWS 16384  // rows a CTA covers at most
#define GD_FULL 0xffffffffu

// rows per thread per tile, and rows per tile, of each leg
template <bool EXT>
struct GdTile {
  static constexpr int rpt = EXT ? 4 : GD_MAX_RPT;
  static constexpr int rows = rpt * GD_THREADS;
};

template <bool EXT>
__global__ void __launch_bounds__(GD_THREADS)
gm_density_kernel(GmCols c, const int* __restrict__ params, int m, int sub, int flags,
                  int width, int height, int* __restrict__ grid) {
  constexpr int RPT = GdTile<EXT>::rpt, TILE = GdTile<EXT>::rows;
  __shared__ GmParams p;
  __shared__ float gb[4];
  __shared__ int stage[GD_WARPS][32 * GD_MAX_RPT];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  gm_load_params(p, params, m);
  if (tid < 4) gb[tid] = __int_as_float(params[GM_EXTRA(m) + tid]);
  __syncthreads();
  const float x0 = gb[0], y0 = gb[1], x1 = gb[2], y1 = gb[3];
  const float sx = __fsub_rn(x1, x0), sy = __fsub_rn(y1, y0);
  const float fw = (float)width, fh = (float)height;
  const int n_box = p.n_box, n_win = p.n_win;
  const int leg = gm_leg(flags, false);
  const bool read_t = (flags & (GM_HAS_WINDOWS | GM_VALID_ON_T)) != 0;
  const bool read_t1 = (flags & GM_HAS_WINDOWS) && !(flags & GM_PACKED_TW);
  const unsigned below = (1u << lane) - 1u;
  const int pack = sub * GM_LANES / TILE;  // tiles a slot
  const long long n_tiles = (long long)m * pack;
  // this CTA's run of tiles: an even share
  const int t_end = (int)((blockIdx.x + 1ll) * n_tiles / gridDim.x);
  for (int t = (int)(blockIdx.x * n_tiles / gridDim.x); t < t_end; ++t) {
    const int slot = t / pack;
    const int bid = params[slot];
    if (bid < 0) continue;  // pad slot: uniform across the CTA
    const long long base =
        (long long)bid * sub * GM_LANES + (long long)(t - slot * pack) * TILE + tid;
    // every load of the thread's rows first
    float a[RPT], b[RPT], e[RPT], f[RPT];
    int t0[RPT], t1[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long r = base + k * GD_THREADS;
      if (EXT) {
        a[k] = c.gx0[r];
        b[k] = c.gy0[r];
        e[k] = c.gx1[r];
        f[k] = c.gy1[r];
      } else {
        a[k] = c.x[r];
        b[k] = c.y[r];
        e[k] = f[k] = 0.f;
      }
      t0[k] = t1[k] = 0;
    }
    if (read_t) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) t0[k] = c.t0[base + k * GD_THREADS];
    }
    if (read_t1) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) t1[k] = c.t1[base + k * GD_THREADS];
    }
    // then each row's pixel, or -1, packed into the warp's hit list
    int n_hits = 0;
    GmMask wide = gm_all_rows<RPT>(), inner = gm_all_rows<RPT>();
    gm_leg_bits<EXT, RPT>(p, flags, leg, n_box, n_win, a, b, e, f, t0, t1, wide, inner);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      int pix = -1;
      if ((wide >> k) & 1u) {
        float x = a[k], y = b[k];
        if (EXT && (flags & GM_EXTENT)) {
          x = __fmul_rn(__fadd_rn(a[k], e[k]), 0.5f);
          y = __fmul_rn(__fadd_rn(b[k], f[k]), 0.5f);
        }
        if ((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1))
          pix = gm_pixel(y, y0, sy, fh, height) * width + gm_pixel(x, x0, sx, fw, width);
      }
      const unsigned hits = __ballot_sync(GD_FULL, pix >= 0);
      if (pix >= 0) stage[warp][n_hits + __popc(hits & below)] = pix;
      n_hits += __popc(hits);
    }
    __syncwarp();
    // then the increments, 32 hits a step, one atomic per distinct pixel
    for (int i0 = 0; i0 < n_hits; i0 += 32) {
      const int left = n_hits - i0;
      const unsigned act = left >= 32 ? GD_FULL : (1u << left) - 1u;
      if (lane < left) {
        const int pix = stage[warp][i0 + lane];
        const unsigned peers = __match_any_sync(act, pix);
        if (lane == __ffs(peers) - 1) atomicAdd(grid + pix, __popc(peers));
      }
    }
    __syncwarp();
  }
}

template <bool EXT>
static int gd_launch(const GmCols& c, const int* params, int m, int sub, int flags, int width,
                     int height, int* grid, cudaStream_t stream) {
  constexpr int TILE = GdTile<EXT>::rows;
  const int n_tiles = m * (sub * GM_LANES / TILE);
  const int max_tiles = GD_CTA_ROWS / TILE;
  const auto kernel = gm_density_kernel<EXT>;
  // whole waves of resident CTAs, each CTA an even share of at most
  // max_tiles tiles, so the last wave is never a sliver
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GD_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  const long long waves = (n_tiles + resident * max_tiles - 1) / (resident * max_tiles);
  const int blocks = (int)(resident * waves < n_tiles ? resident * waves : n_tiles);
  kernel<<<blocks, GD_THREADS, 0, stream>>>(c, params, m, sub, flags, width, height, grid);
  return (int)cudaGetLastError();
}

// grid: int32 [height, width], zeroed by the caller. params: bids[m] |
// boxes | wins | slot counts | grid bounds (x0, y0, x1, y1) as f32 bits.
extern "C" int gm_density(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                          int width, int height, int* grid, void* stream) {
  if (m <= 0) return 0;
  const GmCols c = GM_COLS;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gm_extent(flags))
    return gd_launch<true>(c, params, m, sub, flags, width, height, grid, s);
  return gd_launch<false>(c, params, m, sub, flags, width, height, grid, s);
}
