// Probe P1: the smallest candidate-block scan, wide and inner bit planes.
//
// Replaces the Pallas kernel block_scan (scripts/probe_pallas.py:67, body
// scan_kernel :25, pallas_call :84), the chip-side design probe of the
// block layout: f32 x, y and i32 tbin, toff columns [n_blocks, SUB, 128],
// M candidate slots, two i32 planes [M, SUB/32, 128] (bit b of word
// [j, lane] is local row (j*32 + b)*128 + lane). Every slot evaluates all
// 8 box and all 8 window slots of each plane, with no slot counts and no
// leg flags: wide = box(lanes 0-3) & win(lanes 0-3), inner = box(lanes
// 4-7) & win(lanes 4-7). That is its point beside K1 (block_scan.cu): the
// same work without K1's generality, so the two timed on the same columns
// show what the flags, slot counts and polygon legs cost.
//
// Bound on the H100: memory. Each row is read once (16 B of columns) and
// costs 2 planes x 16 slots x 8 compares and logic ops, about 260
// operations, below the 320 a row of 16 B balances at 67 TOP/s against
// 3.35 TB/s; the planes written back are 1/64 of the columns.
//
// Design: one CTA per slot i, reading block bids[i] (pad slots repeat
// block 0; the host decode ignores them). Thread (lane, j) reads its 32
// rows at stride 128 (gm_row, coalesced across lanes) and folds them into
// one word per plane by shifts, so no atomics and no shared-memory
// reduction are needed. The slot words are staged in shared memory once
// per CTA (gm_load_params, the one-query params layout of masks.cuh; the
// slot counts there are not read) and the slot loops are unrolled.

#include "masks.cuh"

// 512 threads (128 lanes x 4 words of SUB = 128): a bound of 1024 would
// cap the registers at 64 and spill the unrolled slot loops
#define GM_PROBE_SCAN_THREADS 512

__global__ void __launch_bounds__(GM_PROBE_SCAN_THREADS)
gm_probe_scan_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const int* __restrict__ tb, const int* __restrict__ to,
                     const int* __restrict__ params, int m, int sub,
                     int* __restrict__ wide, int* __restrict__ inner) {
  __shared__ GmParams p;
  gm_load_params(p, params, m);
  __syncthreads();
  const int slot = blockIdx.x;
  const int pack = sub >> 5;
  const long long base = (long long)params[slot] * sub * GM_LANES;
  const int lane = threadIdx.x;
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    unsigned int wbits = 0u, ibits = 0u;
    for (int b = 0; b < 32; ++b) {
      const long long r = gm_row(base, j, b, lane);
      const float xv = x[r], yv = y[r];
      const int tv = tb[r], ov = to[r];
      bool bw = false, bi = false, ww = false, wi = false;
#pragma unroll
      for (int k = 0; k < GM_SLOTS; ++k) {
        const float* s = p.box[k];
        bw |= (xv >= s[0]) & (xv <= s[2]) & (yv >= s[1]) & (yv <= s[3]);
        bi |= (xv >= s[4]) & (xv <= s[6]) & (yv >= s[5]) & (yv <= s[7]);
        const int* t = p.win[k];
        ww |= (tv >= t[0]) & (tv <= t[1]) & (ov >= t[2]) & (ov <= t[3]);
        wi |= (tv >= t[4]) & (tv <= t[5]) & (ov >= t[6]) & (ov <= t[7]);
      }
      wbits |= (unsigned)(bw & ww) << b;
      ibits |= (unsigned)(bi & wi) << b;
    }
    const long long o = ((long long)slot * pack + j) * GM_LANES + lane;
    wide[o] = (int)wbits;
    inner[o] = (int)ibits;
  }
}

// x, y: f32, tb, to: i32 columns [n_blocks, sub, 128]. params: bids[m]
// (each in [0, n_blocks)) | boxes[8][8] (f32 bits) | wins[8][8] | two
// slot counts (unused). wide, inner: int32 [m, sub/32, 128]. Returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int gm_probe_scan(const float* x, const float* y, const int* tb, const int* to,
                             const int* params, int m, int sub, int* wide, int* inner,
                             void* stream) {
  if (m <= 0) return 0;
  const int pack = sub / 32;
  const dim3 block(GM_LANES, pack < 4 ? pack : 4);
  gm_probe_scan_kernel<<<m, block, 0, (cudaStream_t)stream>>>(
      x, y, tb, to, params, m, sub, wide, inner);
  return (int)cudaGetLastError();
}
