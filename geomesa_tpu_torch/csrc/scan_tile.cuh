// The row-batched scan body of K1 (block_scan.cu) and K2
// (block_scan_multi.cu): one warp tile of a candidate slot into its wide
// and inner plane words, and the launch geometry both kernels share.
//
// A slot's block is SUB stripes of 128 lanes (row = stripe*128 + lane),
// and word [j, lane] of a plane holds bit b for stripe j*32 + b. A warp
// tile is word group j of a slot over 32 of the 128 lanes (lane group g):
// 32 stripes x 32 lanes = 1024 rows, 32 words per plane. Thread l of the
// warp owns four neighbouring lanes (quad q = l % 8) of 8 stripes (chunk
// l / 8): every column it reads is one 16-byte load per stripe, a warp
// load instruction four full 128-byte lines. It loads a batch of 2
// stripes (8 rows; batches of 4 stripes held twice the registers and were
// slower on the box, window and raster legs in A/B runs; the probe P1,
// whose legs are fixed at compile time, takes 4) before any
// compare, evaluates the legs over the batch with the slot, edge and
// interval loops outside (masks.cuh: a slot's words are read once a
// batch, each row's truth a bit of a mask), and moves each lane's bits
// into its words. The four chunks of a quad then OR their bits with two
// shuffles, and the first writes the quad's four words of each plane as
// one 16-byte store.
//
// Launch geometry: the slots' warp tiles (M * SUB/32 * 4) are cut into
// even runs over whole waves of resident CTAs of 8 warps, each run at most
// 32 tiles, as K3 cuts its tiles (density.cu); each warp takes an even
// share of its CTA's run in a row, so its tiles mostly share a slot. A
// small M spreads over every SM (M = 32 at SUB = 128: 512 tiles), a large
// one ends on whole waves, and nothing assumes SUB/32 is a power of two.
//
// The polygon legs take a kernel instance of their own (POLY): their
// registers stay out of the box, window and validity instances.

#pragma once

#include <atomic>

#include "masks.cuh"

#define GS_THREADS 256
#define GS_WARPS (GS_THREADS / 32)
#define GS_GROUPS 4       // warp tiles across a stripe's 128 lanes
#define GS_CHUNK 8        // stripes of a word group a thread covers
#define GS_CTA_TILES 32   // warp tiles a CTA covers at most
#define GS_MAX_DEVICES 64
#define GS_FULL 0xffffffffu

#define GS_STRIPES 2      // stripes a thread loads ahead of its compares (K1, K2)

struct GsTile {
  int slot, j, g;
};

__device__ __forceinline__ GsTile gs_tile(int t, int pack) {
  const int per_slot = pack * GS_GROUPS;
  const int slot = t / per_slot;
  const int r = t - slot * per_slot;
  return GsTile{slot, r / GS_GROUPS, r % GS_GROUPS};
}

// This warp's tiles [begin, end): an even share of its CTA's even run, in
// a row, so a warp's tiles mostly share a slot (and in K2 its query).
__device__ __forceinline__ void gs_run(int m, int pack, int& begin, int& end) {
  const long long n = (long long)m * pack * GS_GROUPS;
  const long long b0 = blockIdx.x * n / gridDim.x, b1 = (blockIdx.x + 1ll) * n / gridDim.x;
  const int w = threadIdx.x >> 5;
  begin = (int)(b0 + w * (b1 - b0) / GS_WARPS);
  end = (int)(b0 + (w + 1) * (b1 - b0) / GS_WARPS);
}

// Wide and inner words of one warp tile: block rows from ``block0`` (the
// slot's bid * SUB * 128), its planes at word [slot, j, 32g] of wide and
// inner (null: the wide plane alone). ``leg``: the tile's spatial leg
// (gm_leg); ``poly``: its polygon block where the leg reads one. POLY:
// the launch carries polygon legs; S: stripes a batch (a divisor of
// GS_CHUNK). The whole warp runs a tile together.
template <bool EXT, bool POLY, int S = GS_STRIPES>
__device__ __forceinline__ void gs_scan_tile(const GmCols& c, const GmParams& p, const GmPoly& poly,
                                             int flags, int leg, long long block0, GsTile t,
                                             int pack, int* __restrict__ wide,
                                             int* __restrict__ inner) {
  constexpr int R = 4 * S;
  const int l = threadIdx.x & 31;
  const int q = l % 8, ch = l / 8;
  const long long r0 =
      block0 + (long long)(t.j * 32 + ch * GS_CHUNK) * GM_LANES + t.g * 32 + q * 4;
  const int n_box = p.n_box, n_win = p.n_win;
  unsigned wb[4] = {0u, 0u, 0u, 0u}, ib[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
  for (int h = 0; h < GS_CHUNK; h += S) {
    // every load of the batch first, row k * S + s = lane k of stripe h + s;
    // values a leg does not read stay unset
    float a[R], b[R], e[R], f[R];
    int t0[R], t1[R];
#pragma unroll
    for (int s = 0; s < S; ++s)
      gm_load_rows<EXT, 4, S>(c, r0 + (long long)(h + s) * GM_LANES, flags, leg, s, a, b, e, f,
                              t0, t1);
    GmMask w = gm_all_rows<R>(), in = gm_all_rows<R>();
    if constexpr (POLY) gm_poly_bits<R>(poly, leg, a, b, w, in);
    gm_leg_bits<EXT, R>(p, flags, leg, n_box, n_win, a, b, e, f, t0, t1, w, in);
    // lane k's S bits are stripes h .. h + S - 1 of its words
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wb[k] |= ((w >> (k * S)) & ((1u << S) - 1u)) << h;
      ib[k] |= ((in >> (k * S)) & ((1u << S) - 1u)) << h;
    }
  }
  // chunk ch holds bits 8ch .. 8ch + 7 of its quad's words
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wb[k] <<= ch * GS_CHUNK;
    wb[k] |= __shfl_xor_sync(GS_FULL, wb[k], 8);
    wb[k] |= __shfl_xor_sync(GS_FULL, wb[k], 16);
  }
  if (inner) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ib[k] <<= ch * GS_CHUNK;
      ib[k] |= __shfl_xor_sync(GS_FULL, ib[k], 8);
      ib[k] |= __shfl_xor_sync(GS_FULL, ib[k], 16);
    }
  }
  if (ch == 0) {
    const long long o = ((long long)t.slot * pack + t.j) * GM_LANES + t.g * 32 + q * 4;
    *reinterpret_cast<int4*>(wide + o) =
        make_int4((int)wb[0], (int)wb[1], (int)wb[2], (int)wb[3]);
    if (inner)
      *reinterpret_cast<int4*>(inner + o) =
          make_int4((int)ib[0], (int)ib[1], (int)ib[2], (int)ib[3]);
  }
}

// Launch ``kernel`` over the warp tiles of m slots of SUB = sub: whole
// waves of resident CTAs, each an even run of at most GS_CTA_TILES tiles.
// ``resident`` caches the kernel's resident CTAs per device (read once:
// the occupancy query would otherwise sit in every launch). Returns
// cudaGetLastError() of the launch.
template <typename... P, typename... A>
static int gs_launch(void (*kernel)(P...), std::atomic<int>* resident, int m, int sub,
                     cudaStream_t stream, A... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int res = dev < GS_MAX_DEVICES ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (res <= 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GS_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    res = n_sm * (per_sm > 0 ? per_sm : 1);
    if (dev < GS_MAX_DEVICES) resident[dev].store(res, std::memory_order_relaxed);
  }
  const long long n_tiles = (long long)m * (sub / 32) * GS_GROUPS;
  const long long per_wave = (long long)res * GS_CTA_TILES;
  const long long waves = (n_tiles + per_wave - 1) / per_wave;
  const int blocks = (int)(res * waves < n_tiles ? res * waves : n_tiles);
  kernel<<<blocks, GS_THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}
