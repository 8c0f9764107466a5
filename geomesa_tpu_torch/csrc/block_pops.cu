// Per-slot wide-predicate hit counts: K1's wide plane, popcounted per
// candidate block slot, with no plane written.
//
// Replaces the Pallas kernel _pops_pallas
// (geomesa_tpu/scan/aggregations.py:86), which runs _pallas_block_scan
// (block_kernels.py:685) on jnp.maximum(bids, 0) and popcounts the wide
// plane per slot, for all its legs (box, extent, window, packed-time,
// validity).
//
// Bound on the H100: memory. The columns of each slot's block are read
// once; the output is 4 B per slot.
//
// Design: one CTA per slot. Thread (lane, j) builds its wide words as K1
// does (masks.cuh) and adds __popc of each, as unsigned; a warp shuffle
// and one shared-memory pass across warps reduce to one int32 per slot,
// so the planes never reach device memory. Bids are clamped to >= 0 as the
// reference does; the host reads [:n_real].

#include "masks.cuh"

__device__ __forceinline__ int gm_warp_sum(int n) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  return n;
}

template <bool EXT>
__global__ void __launch_bounds__(1024)
gm_block_pops_kernel(GmCols c, const int* __restrict__ params, int m, int sub, int flags,
                     int* __restrict__ out) {
  __shared__ GmParams p;
  __shared__ int part[32];
  gm_load_params(p, params, m);
  __syncthreads();
  const int bid = max(params[blockIdx.x], 0);
  const int pack = sub >> 5;
  const long long base = (long long)bid * sub * GM_LANES;
  const int lane = threadIdx.x;
  const int n_box = p.n_box, n_win = p.n_win;
  int n = 0;
  for (int j = threadIdx.y; j < pack; j += blockDim.y) {
    unsigned int wbits = 0u;
    for (int b = 0; b < 32; ++b) {
      wbits |= (gm_row_bits<EXT>(c, p, gm_row(base, j, b, lane), flags, n_box, n_win) & GM_WIDE) << b;
    }
    n += __popc(wbits);
  }
  n = gm_warp_sum(n);
  const int tid = gm_tid();
  const int warp = tid >> 5, wl = tid & 31;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  if (wl == 0) part[warp] = n;
  __syncthreads();
  if (warp == 0) {
    const int t = gm_warp_sum(wl < n_warps ? part[wl] : 0);
    if (wl == 0) out[blockIdx.x] = t;
  }
}

// out: int32 [m]. params: bids[m] | boxes | wins | slot counts.
extern "C" int gm_block_pops(GM_COL_ARGS, const int* params, int m, int sub, int flags,
                             int* out, void* stream) {
  if (m <= 0) return 0;
  const GmCols c = GM_COLS;
  if (gm_extent(flags))
    gm_block_pops_kernel<true><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, out);
  else
    gm_block_pops_kernel<false><<<m, gm_block_dim(sub), 0, (cudaStream_t)stream>>>(
        c, params, m, sub, flags, out);
  return (int)cudaGetLastError();
}
