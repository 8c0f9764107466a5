// Probe P2, density: the [H, W] grid of the rows in any of 8 boxes and in
// the grid's envelope, as one-hot products summed on the tensor cores.
//
// Replaces the Pallas kernel make_pallas(_density_kernel_reshape) and
// make_pallas(_density_kernel_fori) (scripts/probe_agg.py:128, bodies
// :58 and :85, pallas_call :144), the chip-side probe of the one-hot
// histogram that the JAX package's K3 (_pallas_density) adopted: f32 x, y
// columns [n_blocks, SUB, 128], M slots, one f32 [H, W] grid. A row counts
// when it lies in any of the 8 closed boxes (lanes 0-3 of the box slots),
// in the closed envelope gb = (x0, y0, x1, y1) and in a real slot (bid >=
// 0: pad slots count nothing); its pixel is clip(int((x - x0) / (x1 - x0)
// * W)), likewise in y (gm_pixel). The TPU kernel sums, per chunk of CH
// sublanes (CH * 128 rows), the product of a bf16 y one-hot [H, rows] and
// a bf16 x one-hot [W, rows] in f32: CH = 32 in the reshape body, 1 in the
// fori body. This kernel computes the grid the same way, templated on the
// chunk (the launch names its leg: "reshape" = 32, "fori" = 1).
//
// Bound on the H100: the function's work is memory-bound (8 B of columns
// a row and the 256 KB grid; K3's bound), but the one-hot design does
// 2 * H * W = 131,072 tensor-core flops a row (H = W = 256), which at
// 989 TFLOP/s dense bf16 is 0.13 ns a row against 2.4 ps for its 8 B: the
// tensor cores, not the bytes, set this design's floor, some 55x the
// function's.
//
// Design: a CTA owns a 128 x 128 tile of the grid and a strided group of
// slots; its 8 warps (2 x 4) each keep a 64 x 32 piece of the tile in
// mma.sync m16n8k16 accumulator fragments (bf16 in, f32 sums; 64
// registers a thread) over all its slots. Per chunk the CTA stages one
// packed pixel per row in shared memory ((py << 16) | px, -1 for a row
// that does not count); per 16 rows each thread reads the four rows its
// fragments cover and builds its A (y one-hot) and B (x one-hot)
// fragment elements in registers by compares, so no one-hot matrix is
// ever written to memory. At the end each nonzero sum is added to the
// global f32 grid with atomicAdd. Counts are integers below 2^24, so
// every f32 sum is exact in any order and the grid equals the plain
// version bit for bit.

#include "masks.cuh"

#define GM_PD_THREADS 256
#define GM_PD_TILE 128                // grid tile of one CTA (rows, columns)
#define GM_PD_WM 64                   // warp piece: grid rows (py)
#define GM_PD_WN 32                   // warp piece: grid columns (px)
#define GM_PD_MT (GM_PD_WM / 16)      // m16 fragments per warp piece
#define GM_PD_NT (GM_PD_WN / 8)       // n8 fragments per warp piece
#define GM_PD_MAX_GROUPS 64           // slot groups: 4 tiles x 64 = 256 CTAs, 2 per SM
#define GM_BF16_ONE 0x3F80u

// two bf16 one-hot elements in one register: the lower-indexed in the low
// half (the mma fragment order)
__device__ __forceinline__ unsigned gm_onehot2(int lo, int hi, int v) {
  return (lo == v ? GM_BF16_ONE : 0u) | (hi == v ? GM_BF16_ONE << 16 : 0u);
}

// c += A (16 x 16, row) * B (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void gm_mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                            unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int CH>
__global__ void __launch_bounds__(GM_PD_THREADS, 2)
gm_probe_density_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const int* __restrict__ params, int m, int sub, int height,
                        int width, int groups, float* __restrict__ grid) {
  constexpr int ROWS = CH * GM_LANES;  // rows staged per chunk
  __shared__ GmParams p;
  __shared__ float gb[4];
  __shared__ __align__(16) int pix[ROWS];
  gm_load_params(p, params, m);
  const int tid = threadIdx.x;
  if (tid < 4) gb[tid] = __int_as_float(params[GM_EXTRA(m) + tid]);
  __syncthreads();
  const int n_tx = width / GM_PD_TILE;
  const int n_tiles = (height / GM_PD_TILE) * n_tx;
  const int tile = blockIdx.x % n_tiles;
  const int group = blockIdx.x / n_tiles;
  const int warp = tid >> 5, wl = tid & 31;
  const int g = wl >> 2, t = wl & 3;  // fragment row group, thread in group
  const int wy0 = (tile / n_tx) * GM_PD_TILE + (warp >> 2) * GM_PD_WM;
  const int wx0 = (tile % n_tx) * GM_PD_TILE + (warp & 3) * GM_PD_WN;
  const float x0 = gb[0], y0 = gb[1], x1 = gb[2], y1 = gb[3];
  const float sx = __fsub_rn(x1, x0), sy = __fsub_rn(y1, y0);
  const float fw = (float)width, fh = (float)height;
  const int block_rows = sub * GM_LANES;
  float acc[GM_PD_MT][GM_PD_NT][4];
#pragma unroll
  for (int i = 0; i < GM_PD_MT; ++i)
#pragma unroll
    for (int j = 0; j < GM_PD_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int slot = group; slot < m; slot += groups) {
    const int bid = params[slot];
    if (bid < 0) continue;  // pad slot: counts nothing, uniform across the CTA
    const long long base = (long long)bid * block_rows;
    for (int c0 = 0; c0 < block_rows; c0 += ROWS) {
      __syncthreads();  // the previous chunk's readers are done with pix
      for (int i = tid; i < ROWS; i += GM_PD_THREADS) {
        const long long r = base + c0 + i;
        const float xv = x[r], yv = y[r];
        bool hit = false;
#pragma unroll
        for (int k = 0; k < GM_SLOTS; ++k) {
          const float* q = p.box[k];
          hit |= (xv >= q[0]) & (xv <= q[2]) & (yv >= q[1]) & (yv <= q[3]);
        }
        hit &= (xv >= x0) & (xv <= x1) & (yv >= y0) & (yv <= y1);
        pix[i] = hit ? (gm_pixel(yv, y0, sy, fh, height) << 16) |
                           gm_pixel(xv, x0, sx, fw, width)
                     : -1;
      }
      __syncthreads();
      for (int k0 = 0; k0 < ROWS; k0 += 16) {
        // rows k0 + 2t, +1 (fragment columns 2t, 2t+1) and k0 + 2t + 8, +9
        const int2 lo = *reinterpret_cast<const int2*>(&pix[k0 + 2 * t]);
        const int2 hi = *reinterpret_cast<const int2*>(&pix[k0 + 2 * t + 8]);
        // a row that does not count is -1: its y (-1) matches no grid row
        const int ya = lo.x >> 16, yb = lo.y >> 16, yc = hi.x >> 16, yd = hi.y >> 16;
        const int xa = lo.x & 0xFFFF, xb = lo.y & 0xFFFF, xc = hi.x & 0xFFFF,
                  xd = hi.y & 0xFFFF;
        unsigned bx[GM_PD_NT][2];
#pragma unroll
        for (int j = 0; j < GM_PD_NT; ++j) {
          const int px = wx0 + j * 8 + g;  // B column (grid column) of this thread
          bx[j][0] = gm_onehot2(xa, xb, px);
          bx[j][1] = gm_onehot2(xc, xd, px);
        }
#pragma unroll
        for (int i = 0; i < GM_PD_MT; ++i) {
          const int py = wy0 + i * 16 + g;  // A rows py and py + 8 of this thread
          const unsigned a0 = gm_onehot2(ya, yb, py), a1 = gm_onehot2(ya, yb, py + 8);
          const unsigned a2 = gm_onehot2(yc, yd, py), a3 = gm_onehot2(yc, yd, py + 8);
#pragma unroll
          for (int j = 0; j < GM_PD_NT; ++j)
            gm_mma_bf16(acc[i][j], a0, a1, a2, a3, bx[j][0], bx[j][1]);
        }
      }
    }
  }
  // accumulator element e of fragment (i, j): grid row py + 8 * (e >> 1),
  // column px + (e & 1)
#pragma unroll
  for (int i = 0; i < GM_PD_MT; ++i)
#pragma unroll
    for (int j = 0; j < GM_PD_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = acc[i][j][e];
        if (v != 0.0f) {
          const int row = wy0 + i * 16 + g + 8 * (e >> 1);
          const int col = wx0 + j * 8 + 2 * t + (e & 1);
          atomicAdd(grid + row * width + col, v);
        }
      }
}

// x, y: f32 columns [n_blocks, sub, 128]. params: bids[m] (-1 = pad) |
// boxes[8][8] (f32 bits; lanes 0-3 read) | wins[8][8] and two slot
// counts (unused) | gb (x0, y0, x1, y1) as f32 bits. chunk: sublanes per
// staged chunk, 32 (the reshape body) or 1 (the fori body). grid: f32
// [height, width], zeroed by the caller; height and width multiples of
// 128 (height below 2^15, width below 2^16: the packed pixel). Returns cudaGetLastError() of the launch (0 = launched).
extern "C" int gm_probe_density(const float* x, const float* y, const int* params, int m,
                                int sub, int chunk, int height, int width, float* grid,
                                void* stream) {
  if (m <= 0) return 0;
  if (height <= 0 || width <= 0 || height % GM_PD_TILE || width % GM_PD_TILE ||
      height > 0x7FFF || width > 0xFFFF || chunk <= 0 || sub % chunk)
    return (int)cudaErrorInvalidValue;
  const int groups = m < GM_PD_MAX_GROUPS ? m : GM_PD_MAX_GROUPS;
  const int ctas = (height / GM_PD_TILE) * (width / GM_PD_TILE) * groups;
  if (chunk == 32)
    gm_probe_density_kernel<32><<<ctas, GM_PD_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, params, m, sub, height, width, groups, grid);
  else if (chunk == 1)
    gm_probe_density_kernel<1><<<ctas, GM_PD_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, params, m, sub, height, width, groups, grid);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
