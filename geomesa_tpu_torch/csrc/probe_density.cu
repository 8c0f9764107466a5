// Probe P2, density: the [H, W] grid of the rows in any of 8 boxes and in
// the grid's envelope.
//
// Replaces the Pallas kernels make_pallas(_density_kernel_reshape) and
// make_pallas(_density_kernel_fori) (scripts/probe_agg.py:128, bodies
// :58 and :85, pallas_call :144), the chip-side probe of the one-hot
// histogram that the JAX package's K3 (_pallas_density) adopted: f32 x, y
// columns [n_blocks, SUB, 128], M slots, one f32 [H, W] grid. A row counts
// when it lies in any of the 8 closed boxes (lanes 0-3 of the box slots),
// in the closed envelope gb = (x0, y0, x1, y1) and in a real slot (bid >=
// 0: pad slots count nothing); its pixel is clip(int((x - x0) / (x1 - x0)
// * W)), likewise in y (gm_pixel, in the reference's f32 order, built
// with --fmad=false). The two TPU bodies compute this one grid: each sums
// the product of a bf16 y one-hot [H, rows] and a bf16 x one-hot [W, rows]
// per chunk of rows, 32 sublanes in the reshape body and one in the fori
// body, the chunk being the matrix unit's tile. That product was the
// TPU's way around scatter; it costs 2 * H * W flops a row (131,072 at
// 256 x 256), so on this card's tensor cores it took some 250 times the
// time of the 8 bytes a row reads. Both variants launch this one kernel,
// which has no chunk.
//
// Bound on the H100: memory. Each row of a real slot is read once (8 B of
// x and y) and costs the box compares, the envelope and, for a hit, two
// pixels; the grid is written once (4 B a pixel). The increments are the
// other cost: one atomic per hit, fewer where hits share a pixel.
//
// Design, K3's scheme (density.cu) on the probe's two columns. The real
// slots' rows are cut into tiles of 4096 rows, spread in even runs over
// whole waves of resident CTAs of 512 threads. In a tile a thread owns
// two groups of 4 neighbouring rows, neighbouring threads on neighbouring
// groups, and issues their 16-byte loads of x and y before any compare.
// The box leg runs over the live slots only, through the batch predicate
// of masks.cuh (the host puts the live slots first,
// probe_kernels.live_slots: a slot with an empty interval matches no
// row), then the envelope; each warp packs its hits' points of the tile
// into a shared list (__ballot_sync / __popc offsets), and only then are
// the pixels computed and counted, 32 hits a step with every lane on a hit:
// the two correctly rounded divisions of a pixel run once a hit, not once
// a row for every row of a warp with any hit among its lanes. The lanes on
// one pixel are grouped by __match_any_sync, so each distinct pixel of a
// step costs one atomic. They count on an int32 scratch grid, so every count is exact in any
// order of the atomics (at M = 1024 one pixel can reach 2^24 rows, where
// f32 steps would stop being exact past it); a second launch converts the
// scratch into the f32 output once and zeroes it for the next launch.

#include "masks.cuh"

#include <atomic>

#define GM_PD_THREADS 512
#define GM_PD_WARPS (GM_PD_THREADS / 32)
#define GM_PD_GROUPS 2  // 4-row groups a thread loads per tile
#define GM_PD_ROWS (4 * GM_PD_GROUPS)
#define GM_PD_TILE (GM_PD_ROWS * GM_PD_THREADS)
#define GM_PD_CTA_TILES 4  // tiles a CTA covers at most
#define GM_PD_MAX_DEVICES 64
#define GM_PD_FULL 0xffffffffu

__global__ void __launch_bounds__(GM_PD_THREADS)
gm_probe_density_kernel(GmCols c, const int* __restrict__ params, int m, int sub, int height,
                        int width, int* __restrict__ counts) {
  constexpr int G = GM_PD_GROUPS, R = GM_PD_ROWS;
  __shared__ GmParams p;
  __shared__ float gb[4];
  __shared__ float2 stage[GM_PD_WARPS][32 * R];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  gm_load_params(p, params, m);
  if (tid < 4) gb[tid] = __int_as_float(params[GM_EXTRA(m) + tid]);
  __syncthreads();
  const float x0 = gb[0], y0 = gb[1], x1 = gb[2], y1 = gb[3];
  const float sx = __fsub_rn(x1, x0), sy = __fsub_rn(y1, y0);
  const float fw = (float)width, fh = (float)height;
  const int n_box = p.n_box;
  const unsigned below = (1u << lane) - 1u;
  const int per_slot = sub * GM_LANES / GM_PD_TILE;  // tiles a slot
  const long long n_tiles = (long long)m * per_slot;
  // this CTA's run of tiles: an even share
  const int t_end = (int)((blockIdx.x + 1ll) * n_tiles / gridDim.x);
  for (int t = (int)(blockIdx.x * n_tiles / gridDim.x); t < t_end; ++t) {
    const int slot = t / per_slot;
    const int bid = params[slot];
    if (bid < 0) continue;  // pad slot: counts nothing, uniform across the CTA
    const long long base =
        (long long)bid * sub * GM_LANES + (long long)(t - slot * per_slot) * GM_PD_TILE;
    // every load of the thread's rows first: row 4k + i of group tid + k * threads
    float a[R], b[R], e[R], f[R];
    int t0[R], t1[R];
#pragma unroll
    for (int k = 0; k < G; ++k)
      gm_load_rows<false, 4, 1>(c, base + 4ll * (tid + k * GM_PD_THREADS), GM_HAS_BOXES,
                                GM_LEG_BOX, 4 * k, a, b, e, f, t0, t1);
    GmMask w = gm_all_rows<R>(), in = gm_all_rows<R>();
    gm_leg_bits<false, R>(p, GM_HAS_BOXES, GM_LEG_BOX, n_box, 0, a, b, e, f, t0, t1, w, in);
    // then each hit's point packed into the warp's hit list
    int n_hits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = a[r], y = b[r];
      const bool hit = ((w >> r) & 1u) && (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1);
      const unsigned hits = __ballot_sync(GM_PD_FULL, hit);
      if (hit) stage[warp][n_hits + __popc(hits & below)] = make_float2(x, y);
      n_hits += __popc(hits);
    }
    __syncwarp();
    // then the pixels and increments, 32 hits a step with every lane on a
    // hit, one atomic per distinct pixel
    for (int i0 = 0; i0 < n_hits; i0 += 32) {
      const int left = n_hits - i0;
      const unsigned act = left >= 32 ? GM_PD_FULL : (1u << left) - 1u;
      if (lane < left) {
        const float2 h = stage[warp][i0 + lane];
        const int pix =
            gm_pixel(h.y, y0, sy, fh, height) * width + gm_pixel(h.x, x0, sx, fw, width);
        const unsigned peers = __match_any_sync(act, pix);
        if (lane == __ffs(peers) - 1) atomicAdd(counts + pix, __popc(peers));
      }
    }
    __syncwarp();
  }
}

// grid = f32(counts), and counts back to zero for the next launch
__global__ void gm_probe_density_f32(int* __restrict__ counts, float* __restrict__ grid,
                                     int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    grid[i] = (float)counts[i];
    counts[i] = 0;
  }
}

// resident CTAs of the counting kernel, per device (read once: the
// occupancy query would otherwise sit in every launch)
static std::atomic<int> gm_probe_density_resident[GM_PD_MAX_DEVICES];

// x, y: f32 columns [n_blocks, sub, 128], 16-byte aligned, sub a multiple
// of 32. params: bids[m] (-1 = pad) | boxes[8][8] (f32 bits; lanes 0-3
// read) | wins[8][8] (unread) | live box slots (of lanes 0-3, first) | 0 |
// gb (x0, y0, x1, y1) as f32 bits. counts: int32 [height, width], zero on
// entry and on return; grid: f32 [height, width], written whole (height
// below 2^15, width below 2^16). Returns cudaGetLastError() of the
// launches (0 = launched).
extern "C" int gm_probe_density(const float* x, const float* y, const int* params, int m,
                                int sub, int height, int width, int* counts, float* grid,
                                void* stream) {
  if (height <= 0 || width <= 0 || height > 0x7FFF || width > 0xFFFF || sub % 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m > 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int res = dev < GM_PD_MAX_DEVICES
                  ? gm_probe_density_resident[dev].load(std::memory_order_relaxed)
                  : 0;
    if (res <= 0) {
      int n_sm = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gm_probe_density_kernel,
                                                            GM_PD_THREADS, 0);
      if (err != cudaSuccess) return (int)err;
      res = n_sm * (per_sm > 0 ? per_sm : 1);
      if (dev < GM_PD_MAX_DEVICES)
        gm_probe_density_resident[dev].store(res, std::memory_order_relaxed);
    }
    // whole waves of resident CTAs, each an even share of at most
    // GM_PD_CTA_TILES tiles, so the last wave is never a sliver
    const long long n_tiles = (long long)m * (sub * GM_LANES / GM_PD_TILE);
    const long long per_wave = (long long)res * GM_PD_CTA_TILES;
    const long long waves = (n_tiles + per_wave - 1) / per_wave;
    const int blocks = (int)(res * waves < n_tiles ? res * waves : n_tiles);
    const GmCols c{x, y, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    gm_probe_density_kernel<<<blocks, GM_PD_THREADS, 0, s>>>(c, params, m, sub, height, width,
                                                             counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = height * width;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads < 1024 ? (n + threads - 1) / threads : 1024;
  gm_probe_density_f32<<<blocks, threads, 0, s>>>(counts, grid, n);
  return (int)cudaGetLastError();
}
