// Probe P1: the smallest candidate-block scan, wide and inner bit planes.
//
// Replaces the Pallas kernel block_scan (scripts/probe_pallas.py:67, body
// scan_kernel :25, pallas_call :84), the chip-side design probe of the
// block layout: f32 x, y and i32 tbin, toff columns [n_blocks, SUB, 128],
// M candidate slots, two i32 planes [M, SUB/32, 128] (bit b of word
// [j, lane] is local row (j*32 + b)*128 + lane). Its function is wide =
// box(lanes 0-3) & win(lanes 0-3), inner = box(lanes 4-7) & win(lanes
// 4-7), each an OR over all 8 box and all 8 window slots, with no slot
// counts and no leg flags. The TPU kernel unrolls the 8 slots because a
// branch costs a TPU more than the compares do.
//
// Bound on the H100: memory. Each row is read once (16 B of columns) and
// costs at most 2 planes x 16 slots x 8 compares and logic ops, about 260
// operations, below the 320 a row of 16 B balances at 67 TOP/s against
// 3.35 TB/s; the planes written back are 1/64 of the columns. With all 8
// slots of both legs real (the 8-slot split) the compares come close to
// that balance, and the instruction issue rate may set the pace.
//
// Design: an instance of K1's row-batched body (scan_tile.cuh) with the
// box and window legs of both planes fixed at compile time: no flags,
// validity, packed-time, polygon, raster or extent legs and no branch on
// them survive the inlining. Warp tiles of 32 stripes x 32 lanes in even
// runs over whole waves of resident CTAs; a thread loads 16 rows (4
// stripes of its 4 lanes) as 16-byte column loads before any compare, the
// slot loops run outside the rows, so a slot's words are read once for 16
// rows, each row's truth a bit of a mask, two shuffles a quad and one
// 16-byte store a plane. A GPU drops a slot for a whole CTA at no cost:
// the host puts each leg's live slots first (probe_kernels.live_slots) and
// the legs loop over those only. A slot with an empty interval (lo > hi,
// or a NaN bound) matches no row whatever the row holds, so every plane
// word is the one all 8 slots give. Pad slots repeat block 0; the host
// decode ignores them.

#include "scan_tile.cuh"

// the probe's legs: the boxes and the (tbin, toff) windows, both planes
#define GM_PROBE_SCAN_FLAGS (GM_HAS_BOXES | GM_HAS_WINDOWS)
// stripes a batch: 16 rows a thread (in A/B runs on an H100, K1's 8 were
// 4.6 % slower on the 8-slot split at M = 1024, 5 % faster on the probe's
// params)
#define GM_PROBE_SCAN_STRIPES 4

__global__ void __launch_bounds__(GS_THREADS)
gm_probe_scan_kernel(GmCols c, const int* __restrict__ params, int m, int sub,
                     int* __restrict__ wide, int* __restrict__ inner) {
  __shared__ GmParams p;
  gm_load_params(p, params, m);
  __syncthreads();
  const int pack = sub >> 5;
  int begin, end;
  gs_run(m, pack, begin, end);
  for (int t = begin; t < end; ++t) {
    const GsTile tile = gs_tile(t, pack);
    gs_scan_tile<false, false, GM_PROBE_SCAN_STRIPES>(
        c, p, GmPoly{}, GM_PROBE_SCAN_FLAGS, GM_LEG_BOX,
        (long long)params[tile.slot] * sub * GM_LANES, tile, pack, wide, inner);
  }
}

static std::atomic<int> gm_probe_scan_resident[GS_MAX_DEVICES];

// x, y: f32, tb, to: i32 columns [n_blocks, sub, 128], 16-byte aligned.
// params: bids[m] (each in [0, n_blocks)) | boxes[8][8] (f32 bits) |
// wins[8][8] | live box and window slots, each leg's live slots first.
// wide, inner: int32 [m, sub/32, 128]. Returns cudaGetLastError() of the
// launch (0 = launched).
extern "C" int gm_probe_scan(const float* x, const float* y, const int* tb, const int* to,
                             const int* params, int m, int sub, int* wide, int* inner,
                             void* stream) {
  if (m <= 0) return 0;
  if (sub % 32) return (int)cudaErrorInvalidValue;
  const GmCols c{x, y, nullptr, nullptr, nullptr, nullptr, tb, to};
  return gs_launch(gm_probe_scan_kernel, gm_probe_scan_resident, m, sub, (cudaStream_t)stream,
                   c, params, m, sub, wide, inner);
}
