// Native ingest hot path: fused write-key encoding.
//
// The reference's ingest hot loop is per-feature JVM code — normalize +
// Z3.split interleave + row byte assembly (reference
// geomesa-index-api/.../index/z3/Z3IndexKeySpace.scala:63-95 over
// geomesa-z3/.../zorder/sfcurve/Z3.scala:73-91). Here the equivalent tier
// is one fused multithreaded C++ pass per ingest batch: epoch-millis
// binning, lon/lat/time bit-normalization, Morton interleave, and the f32
// device-column conversion, writing all five output columns in a single
// traversal (the numpy path materializes ~10 temporaries).
//
// The port's copy of geomesa_tpu/native/geomesa_native.cpp, arithmetic
// unchanged. Semantics are bit-exact with the port's numpy versions
// (curve/zorder.py, normalize.py, binnedtime.py and their callers);
// tests/test_torch_native.py holds every entry point against the JAX
// package's library and against those numpy versions.
//
// Build (native/__init__.py): g++ -O3 -ffp-contract=off [-fopenmp] -shared
// -fPIC geomesa_native.cpp -o libgeomesa_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- morton

static inline uint64_t split2(uint64_t x) {
  x &= 0x7FFFFFFFull;
  x = (x ^ (x << 32)) & 0x00000000FFFFFFFFull;
  x = (x ^ (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x ^ (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x ^ (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x ^ (x << 2)) & 0x3333333333333333ull;
  x = (x ^ (x << 1)) & 0x5555555555555555ull;
  return x;
}

static inline uint64_t combine2(uint64_t z) {
  uint64_t x = z & 0x5555555555555555ull;
  x = (x ^ (x >> 1)) & 0x3333333333333333ull;
  x = (x ^ (x >> 2)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x ^ (x >> 4)) & 0x00FF00FF00FF00FFull;
  x = (x ^ (x >> 8)) & 0x0000FFFF0000FFFFull;
  x = (x ^ (x >> 16)) & 0x00000000FFFFFFFFull;
  return x;
}

static inline uint64_t split3(uint64_t x) {
  x &= 0x1FFFFFull;
  x = (x | (x << 32)) & 0x1F00000000FFFFull;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

static inline uint64_t combine3(uint64_t z) {
  uint64_t x = z & 0x1249249249249249ull;
  x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3ull;
  x = (x ^ (x >> 4)) & 0x100F00F00F00F00Full;
  x = (x ^ (x >> 8)) & 0x1F0000FF0000FFull;
  x = (x ^ (x >> 16)) & 0x1F00000000FFFFull;
  x = (x ^ (x >> 32)) & 0x1FFFFFull;
  return x;
}

void morton2(const uint64_t* x, const uint64_t* y, int64_t n, uint64_t* out) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    out[i] = split2(x[i]) | (split2(y[i]) << 1);
  }
}

void morton2_decode(const uint64_t* z, int64_t n, uint64_t* x, uint64_t* y) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    x[i] = combine2(z[i]);
    y[i] = combine2(z[i] >> 1);
  }
}

void morton3(const uint64_t* x, const uint64_t* y, const uint64_t* t, int64_t n,
             uint64_t* out) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    out[i] = split3(x[i]) | (split3(y[i]) << 1) | (split3(t[i]) << 2);
  }
}

void morton3_decode(const uint64_t* z, int64_t n, uint64_t* x, uint64_t* y,
                    uint64_t* t) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    x[i] = combine3(z[i]);
    y[i] = combine3(z[i] >> 1);
    t[i] = combine3(z[i] >> 2);
  }
}

// ----------------------------------------------------------- normalization
// Bit-exact with NormalizedDimension.normalize: floor((d - min) * bins /
// (max - min)) clamped to [0, 2^p - 1]; the normalizer is computed once in
// double, matching numpy's scalar broadcast.

static inline int64_t normalize(double d, double mn, double normalizer,
                                int64_t max_index) {
  int64_t i = (int64_t)std::floor((d - mn) * normalizer);
  if (i < 0) i = 0;
  if (i > max_index) i = max_index;
  return i;
}

// ------------------------------------------------------------- write keys

// Fixed-width periods only (day: bin_ms=86400000, off_div=1; week:
// bin_ms=604800000, off_div=1000). Calendar periods (month/year) stay on
// the numpy path. Returns 0 ok, 1 pre-epoch input, 2 bin overflow.
int32_t z3_write_keys(const double* x, const double* y, const int64_t* millis,
                      int64_t n, int64_t bin_ms, int64_t off_div,
                      double max_off, int32_t max_bin, uint64_t* out_z,
                      int32_t* out_bin, float* out_xf, float* out_yf,
                      int32_t* out_toff) {
  const double lon_norm = 2097152.0 / 360.0;  // 2^21 / (180 - -180)
  const double lat_norm = 2097152.0 / 180.0;
  const double t_norm = 2097152.0 / max_off;  // NormalizedTime(21, max_off)
  const int64_t max_index = 2097151;          // 2^21 - 1
  int32_t status = 0;
#pragma omp parallel for reduction(max : status)
  for (int64_t i = 0; i < n; ++i) {
    int64_t ms = millis[i];
    if (ms < 0) {
      status = status > 1 ? status : 1;
      continue;
    }
    int64_t bin = ms / bin_ms;
    int64_t off = (ms - bin * bin_ms) / off_div;
    if (bin > (int64_t)max_bin) {
      status = 2;
      continue;
    }
    uint64_t xi = (uint64_t)normalize(x[i], -180.0, lon_norm, max_index);
    uint64_t yi = (uint64_t)normalize(y[i], -90.0, lat_norm, max_index);
    uint64_t ti = (uint64_t)normalize((double)off, 0.0, t_norm, max_index);
    out_z[i] = split3(xi) | (split3(yi) << 1) | (split3(ti) << 2);
    out_bin[i] = (int32_t)bin;
    out_xf[i] = (float)x[i];
    out_yf[i] = (float)y[i];
    out_toff[i] = (int32_t)off;
  }
  return status;
}

void z2_write_keys(const double* x, const double* y, int64_t n, uint64_t* out_z,
                   float* out_xf, float* out_yf) {
  const double lon_norm = 2147483648.0 / 360.0;  // 2^31 / 360
  const double lat_norm = 2147483648.0 / 180.0;
  const int64_t max_index = 2147483647;  // 2^31 - 1
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    uint64_t xi = (uint64_t)normalize(x[i], -180.0, lon_norm, max_index);
    uint64_t yi = (uint64_t)normalize(y[i], -90.0, lat_norm, max_index);
    out_z[i] = split2(xi) | (split2(yi) << 1);
    out_xf[i] = (float)x[i];
    out_yf[i] = (float)y[i];
  }
  return;
}

}  // extern "C"

// ------------------------------------------------------------ radix sort
// Ingest-path argsort by (bin, z): LSD radix with u32 payload, replacing
// np.lexsort's comparison sort (the reference gets sorted order for free
// from its KV backends; here the sorted columnar table is built in one
// batch pass — SURVEY §7 hard part (c)). 8-bit digits; passes whose
// histogram collapses to a single bucket are skipped (high z bytes and
// small bin counts make most of the 10 nominal passes no-ops).


static int radix_pass_u64_w(const uint64_t* key, const uint32_t* idx, int64_t n,
                            int shift, int bits, uint64_t* key_out,
                            uint32_t* idx_out, int64_t* hist) {
  const uint64_t mask = ((uint64_t)1 << bits) - 1;
  const int64_t buckets = (int64_t)1 << bits;
  std::fill(hist, hist + buckets, 0);
  for (int64_t i = 0; i < n; ++i) hist[(key[i] >> shift) & mask]++;
  int64_t nonzero = 0;
  for (int64_t b = 0; b < buckets; ++b) nonzero += hist[b] != 0;
  if (nonzero <= 1) return 0;  // all keys share this digit: skip
  int64_t acc = 0;
  for (int64_t b = 0; b < buckets; ++b) {
    const int64_t c = hist[b];
    hist[b] = acc;
    acc += c;
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t& o = hist[(key[i] >> shift) & mask];
    key_out[o] = key[i];
    idx_out[o] = idx[i];
    ++o;
  }
  return 1;
}

// argsort by (bins asc, zs asc), stable; out_perm must hold n uint32.
// 16-bit digits (4 z passes + 1 bin pass vs 8+4 at 8 bits) for large n,
// 8-bit digits below 1M rows where the 512 KB histogram dominates.
extern "C" void sort_bins_z(const int32_t* bins, const uint64_t* zs, int64_t n,
                 uint32_t* out_perm) {
  const int bits = n >= (1 << 20) ? 16 : 8;
  std::vector<int64_t> hist((size_t)1 << bits);
  std::vector<uint64_t> ka(n), kb(n);
  std::vector<uint32_t> ia(n), ib(n);
  for (int64_t i = 0; i < n; ++i) { ka[i] = zs[i]; ia[i] = (uint32_t)i; }
  uint64_t* k0 = ka.data(); uint64_t* k1 = kb.data();
  uint32_t* i0 = ia.data(); uint32_t* i1 = ib.data();
  for (int shift = 0; shift < 64; shift += bits) {
    if (radix_pass_u64_w(k0, i0, n, shift, bits, k1, i1, hist.data())) {
      std::swap(k0, k1);
      std::swap(i0, i1);
    }
  }
  // bin passes: rebuild key as bin (u16 range) of the current order
  for (int64_t i = 0; i < n; ++i) k0[i] = (uint64_t)(uint32_t)bins[i0[i]];
  for (int shift = 0; shift < 32; shift += bits) {
    if (radix_pass_u64_w(k0, i0, n, shift, bits, k1, i1, hist.data())) {
      std::swap(k0, k1);
      std::swap(i0, i1);
    }
  }
  std::memcpy(out_perm, i0, n * sizeof(uint32_t));
}

// permutation gathers for building sorted device/host columns
extern "C" void gather_f32(const float* src, const uint32_t* idx, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}
extern "C" void gather_i32(const int32_t* src, const uint32_t* idx, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}
extern "C" void gather_i64(const int64_t* src, const uint32_t* idx, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}
extern "C" void gather_u64(const uint64_t* src, const uint32_t* idx, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}
extern "C" void gather_f64(const double* src, const uint32_t* idx, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}

// row gathers for [n, width] arrays (packed-geometry coords/bboxes):
// out[i, :] = src[idx[i], :]. The random-row reads are memory-latency
// bound; threads hide the misses.
extern "C" void gather_rows_f64(const double* src, const uint32_t* idx,
                                int64_t n, int64_t width, double* out) {
#pragma omp parallel for schedule(static) if (n > 65536)
  for (int64_t i = 0; i < n; ++i) {
    const double* s = src + (int64_t)idx[i] * width;
    double* o = out + i * width;
    for (int64_t w = 0; w < width; ++w) o[w] = s[w];
  }
}
extern "C" void gather_rows_f32(const float* src, const uint32_t* idx,
                                int64_t n, int64_t width, float* out) {
#pragma omp parallel for schedule(static) if (n > 65536)
  for (int64_t i = 0; i < n; ++i) {
    const float* s = src + (int64_t)idx[i] * width;
    float* o = out + i * width;
    for (int64_t w = 0; w < width; ++w) o[w] = s[w];
  }
}

// ----------------------------------------------- point-in-polygon refine
// Host refinement hot loop for polygon queries over point stores: the
// numpy even-odd ray cast materializes an [n_points, n_edges] matrix
// (800 MB at 1M x 100); this streams edges per point in registers with
// the SAME crossing construction (spans half-open in y, intersection x
// strictly right of the point), threaded over points.
// rings are verts[ring_offsets[r] : ring_offsets[r+1]] (closed);
// ring_part[r] groups rings into polygon parts: within a part parity
// XORs (holes subtract), across parts the results OR (multi-polygon).
extern "C" void points_in_polygon_cpp(
    const double* px, const double* py, int64_t n,
    const double* verts /* [total_verts, 2] */,
    const int64_t* ring_offsets, int64_t n_rings,
    const int32_t* ring_part, uint8_t* out) {
#pragma omp parallel for schedule(static) if (n > 16384)
  for (int64_t i = 0; i < n; ++i) {
    const double x = px[i], y = py[i];
    bool any = false;
    bool parity = false;
    int32_t cur_part = n_rings ? ring_part[0] : 0;
    for (int64_t r = 0; r < n_rings; ++r) {
      if (ring_part[r] != cur_part) {
        any |= parity;
        parity = false;
        cur_part = ring_part[r];
      }
      const int64_t a = ring_offsets[r], b = ring_offsets[r + 1];
      int64_t crossings = 0;
      for (int64_t e = a; e + 1 < b; ++e) {
        const double y1 = verts[2 * e + 1], y2 = verts[2 * e + 3];
        if ((y1 <= y) != (y2 <= y)) {
          const double x1 = verts[2 * e], x2 = verts[2 * e + 2];
          const double t = (y - y1) / (y2 - y1);
          if (x1 + t * (x2 - x1) > x) ++crossings;
        }
      }
      if (crossings & 1) parity = !parity;
    }
    out[i] = (any | parity) ? 1 : 0;
  }
}

// -------------------------------------------------------- z-range BFS
// Query planning hot path: covering z-ranges for a union of ordinal boxes
// (reference ZN.zranges quad/oct BFS + Tropf/Herzog zdiv tightening,
// geomesa-z3/.../sfcurve/ZN.scala:110-242, :309-361). The Python
// implementation (curve/zranges.py) costs 100-300 ms per query; this is
// the same algorithm in C++ at <1 ms. Containment is classified against a
// separate *inner* ordinal box so that contained-range rows are certain
// hits at f64 precision (ScanConfig.contained -> no refinement).

struct ZCurveOps {
  int dims;
  int bits_per_dim;
  uint64_t (*split)(uint64_t);
  uint64_t (*combine)(uint64_t);
};

static uint64_t z2_index_(const uint64_t* p) { return split2(p[0]) | (split2(p[1]) << 1); }
static uint64_t z3_index_(const uint64_t* p) {
  return split3(p[0]) | (split3(p[1]) << 1) | (split3(p[2]) << 2);
}

static void z_decode(const ZCurveOps& ops, uint64_t z, uint64_t* out) {
  for (int d = 0; d < ops.dims; ++d) out[d] = ops.combine(z >> d);
}

static uint64_t z_index(const ZCurveOps& ops, const uint64_t* p) {
  return ops.dims == 2 ? z2_index_(p) : z3_index_(p);
}

// 2 = cell fully inside some inner box, 1 = overlaps some outer box, 0 = no
static int classify(const uint64_t* lo, const uint64_t* hi, int dims, int64_t nbox,
                    const uint64_t* mins, const uint64_t* maxes,
                    const uint64_t* imins, const uint64_t* imaxes) {
  for (int64_t b = 0; b < nbox; ++b) {
    bool contained = true;
    for (int d = 0; d < dims; ++d)
      if (lo[d] < imins[b * dims + d] || hi[d] > imaxes[b * dims + d]) {
        contained = false;
        break;
      }
    if (contained) return 2;
  }
  for (int64_t b = 0; b < nbox; ++b) {
    bool overlap = true;
    for (int d = 0; d < dims; ++d)
      if (lo[d] > maxes[b * dims + d] || hi[d] < mins[b * dims + d]) {
        overlap = false;
        break;
      }
    if (overlap) return 1;
  }
  return 0;
}

struct ZRange { uint64_t lo, hi; uint8_t contained; };

// Tropf/Herzog LITMAX/BIGMIN: mirrors curve/zorder.py zdiv.
static void zdiv_cpp(const ZCurveOps& ops, uint64_t zmin, uint64_t zmax,
                     uint64_t zval, uint64_t* litmax_out, uint64_t* bigmin_out) {
  int dims = ops.dims;
  int total = dims * ops.bits_per_dim;
  uint64_t litmax = zmin, bigmin = zmax;
  uint64_t zmin_ = zmin, zmax_ = zmax;
  for (int i = total - 1; i >= 0; --i) {
    uint64_t bit = 1ull << i;
    int dim = i % dims;
    int bl = i / dims + 1;  // 1-based dim-local bit index
    int v = (zval & bit) ? 1 : 0;
    int mn = (zmin_ & bit) ? 1 : 0;
    int mx = (zmax_ & bit) ? 1 : 0;
    uint64_t mask = ops.split((1ull << bl) - 1) << dim;
    if (v == 0 && mn == 0 && mx == 1) {
      uint64_t pat_hi = ops.split(1ull << (bl - 1)) << dim;
      uint64_t pat_lo = ops.split(((1ull << (bl - 1)) - 1)) << dim;
      bigmin = (zmin_ & ~mask) | pat_hi;
      zmax_ = (zmax_ & ~mask) | pat_lo;
    } else if (v == 0 && mn == 1 && mx == 1) {
      bigmin = zmin_;
      break;
    } else if (v == 1 && mn == 0 && mx == 0) {
      litmax = zmax_;
      break;
    } else if (v == 1 && mn == 0 && mx == 1) {
      uint64_t pat_hi = ops.split(1ull << (bl - 1)) << dim;
      uint64_t pat_lo = ops.split(((1ull << (bl - 1)) - 1)) << dim;
      litmax = (zmax_ & ~mask) | pat_lo;
      zmin_ = (zmin_ & ~mask) | pat_hi;
    }
  }
  *litmax_out = litmax;
  *bigmin_out = bigmin;
}

static bool in_some_box(const ZCurveOps& ops, uint64_t z, int64_t nbox,
                        const uint64_t* mins, const uint64_t* maxes) {
  uint64_t pt[3];
  z_decode(ops, z, pt);
  for (int64_t b = 0; b < nbox; ++b) {
    bool in = true;
    for (int d = 0; d < ops.dims; ++d)
      if (pt[d] < mins[b * ops.dims + d] || pt[d] > maxes[b * ops.dims + d]) {
        in = false;
        break;
      }
    if (in) return true;
  }
  return false;
}

// Covering ranges for a union of ordinal boxes. Returns the number of
// ranges written (<= cap), or -1 if cap was too small.
extern "C" int64_t zranges_cpp(int32_t dims, int32_t bits_per_dim, int64_t nbox,
                    const uint64_t* mins, const uint64_t* maxes,
                    const uint64_t* imins, const uint64_t* imaxes,
                    int64_t max_ranges, int64_t max_recurse,
                    uint64_t* out_lo, uint64_t* out_hi, uint8_t* out_cont,
                    int64_t cap) {
  ZCurveOps ops = dims == 2 ? ZCurveOps{2, bits_per_dim, split2, combine2}
                            : ZCurveOps{3, bits_per_dim, split3, combine3};
  int total = dims * bits_per_dim;
  int children = 1 << dims;

  // corner z's + longest common prefix aligned to dims bits
  std::vector<uint64_t> zmins(nbox), zmaxes(nbox);
  for (int64_t b = 0; b < nbox; ++b) {
    zmins[b] = z_index(ops, mins + b * dims);
    zmaxes[b] = z_index(ops, maxes + b * dims);
  }
  int offset = total;
  while (offset > 0) {
    int nxt = offset - dims;
    uint64_t bits = zmins[0] >> nxt;
    bool same = true;
    for (int64_t b = 0; b < nbox && same; ++b)
      same = (zmins[b] >> nxt) == bits && (zmaxes[b] >> nxt) == bits;
    if (same) offset = nxt; else break;
  }
  uint64_t prefix = (zmins[0] >> offset) << offset;

  std::vector<ZRange> ranges;
  std::vector<std::pair<uint64_t, int>> level{{prefix, offset}}, nxt_level;
  uint64_t lo_pt[3], hi_pt[3];
  int recursions = 0;
  while (!level.empty() && recursions < max_recurse &&
         (int64_t)(ranges.size() + level.size() * children) < max_ranges * 2) {
    nxt_level.clear();
    for (auto& cell : level) {
      uint64_t zp = cell.first;
      int free_bits = cell.second;
      if (free_bits == 0) {
        z_decode(ops, zp, lo_pt);
        int c = classify(lo_pt, lo_pt, dims, nbox, mins, maxes, imins, imaxes);
        if (c) ranges.push_back({zp, zp, (uint8_t)(c == 2)});
        continue;
      }
      int child_bits = free_bits - dims;
      for (int q = 0; q < children; ++q) {
        uint64_t cp = zp | ((uint64_t)q << child_bits);
        uint64_t cmax = cp | ((child_bits ? (1ull << child_bits) : 0) - (child_bits ? 1ull : 0));
        z_decode(ops, cp, lo_pt);
        z_decode(ops, cmax, hi_pt);
        int c = classify(lo_pt, hi_pt, dims, nbox, mins, maxes, imins, imaxes);
        if (c == 2) {
          ranges.push_back({cp, cmax, 1});
        } else if (c == 1) {
          if (child_bits == 0) ranges.push_back({cp, cp, 0});
          else nxt_level.push_back({cp, child_bits});
        }
      }
    }
    level.swap(nxt_level);
    ++recursions;
  }
  for (auto& cell : level)
    ranges.push_back({cell.first, cell.first | ((1ull << cell.second) - 1), 0});

  // sort + merge adjacent/overlapping
  std::sort(ranges.begin(), ranges.end(), [](const ZRange& a, const ZRange& b) {
    return a.lo != b.lo ? a.lo < b.lo : a.hi < b.hi;
  });
  // merge only same-kind neighbors (BFS cells are disjoint, so ranges can
  // only be adjacent): a contained range glued to an overlapping one keeps
  // its no-refinement guarantee instead of degrading the pair
  std::vector<ZRange> merged;
  for (auto& r : ranges) {
    if (!merged.empty() && merged.back().hi != ~0ull &&
        r.lo <= merged.back().hi + 1 && r.contained == merged.back().contained) {
      if (r.hi > merged.back().hi) merged.back().hi = r.hi;
    } else {
      merged.push_back(r);
    }
  }
  // reduce below max_ranges by closing the smallest gaps first
  while ((int64_t)merged.size() > max_ranges) {
    // single pass: close all gaps below a threshold found by nth_element
    int64_t k = merged.size() - max_ranges;
    std::vector<uint64_t> gaps(merged.size() - 1);
    for (size_t i = 0; i + 1 < merged.size(); ++i)
      gaps[i] = merged[i + 1].lo - merged[i].hi;
    std::vector<uint64_t> g2(gaps);
    std::nth_element(g2.begin(), g2.begin() + (k - 1), g2.end());
    uint64_t cutoff = g2[k - 1];
    std::vector<ZRange> out;
    out.push_back(merged[0]);
    int64_t closed = 0;
    for (size_t i = 1; i < merged.size(); ++i) {
      if (closed < k && gaps[i - 1] <= cutoff) {
        out.back().hi = merged[i].hi > out.back().hi ? merged[i].hi : out.back().hi;
        out.back().contained = 0;
        ++closed;
      } else {
        out.push_back(merged[i]);
      }
    }
    merged.swap(out);
  }

  // tighten endpoints to in-union z-values (zdiv post-pass; mirrors
  // curve/zranges.py _tighten_ranges against the *outer* boxes)
  std::vector<ZRange> out;
  for (auto& r : merged) {
    bool has_lo = false, has_hi = false;
    uint64_t lo = 0, hi = 0;
    for (int64_t b = 0; b < nbox; ++b) {
      uint64_t zmin = zmins[b], zmax = zmaxes[b];
      if (zmax < r.lo || zmin > r.hi) continue;
      uint64_t cand;
      if (r.lo <= zmin) cand = zmin;
      else if (in_some_box(ops, r.lo, 1, mins + b * dims, maxes + b * dims)) cand = r.lo;
      else { uint64_t lm, bm; zdiv_cpp(ops, zmin, zmax, r.lo, &lm, &bm); cand = bm; }
      if (cand <= r.hi && (!has_lo || cand < lo)) { lo = cand; has_lo = true; }
      if (r.hi >= zmax) cand = zmax;
      else if (in_some_box(ops, r.hi, 1, mins + b * dims, maxes + b * dims)) cand = r.hi;
      else { uint64_t lm, bm; zdiv_cpp(ops, zmin, zmax, r.hi, &lm, &bm); cand = lm; }
      if (cand >= r.lo && (!has_hi || cand > hi)) { hi = cand; has_hi = true; }
    }
    if (!has_lo || !has_hi || lo > hi) continue;
    out.push_back({lo, hi, r.contained});
  }

  if ((int64_t)out.size() > cap) return -1;
  for (size_t i = 0; i < out.size(); ++i) {
    out_lo[i] = out[i].lo;
    out_hi[i] = out[i].hi;
    out_cont[i] = out[i].contained;
  }
  return (int64_t)out.size();
}

// ---------------------------------------------------------------------------
// bitmask decode: the scan pull's host decode hot path
// (scan/block_kernels.py decode_bits_pair; bit b of word
// [blk, j, lane] = local row (j*32 + b)*128 + lane). The numpy route
// (unpackbits + transpose + nonzero + fancy index) costs ~25x this.
// ---------------------------------------------------------------------------

extern "C" int64_t bitmask_count(const int32_t* wide, int64_t n_real,
                                 int64_t pack) {
  const uint32_t* w = (const uint32_t*)wide;
  int64_t words = n_real * pack * 128;
  int64_t total = 0;
  for (int64_t i = 0; i < words; ++i) total += __builtin_popcount(w[i]);
  return total;
}

extern "C" int64_t bitmask_decode_pair(const int32_t* wide,
                                       const int32_t* inner,
                                       const int64_t* bids, int64_t n_real,
                                       int64_t pack, int64_t block,
                                       int64_t* rows_out, uint8_t* cert_out) {
  const uint32_t* w = (const uint32_t*)wide;
  const uint32_t* in = (const uint32_t*)inner;
  int64_t k = 0;
  for (int64_t blk = 0; blk < n_real; ++blk) {
    int64_t base = bids[blk] * block;
    for (int64_t j = 0; j < pack; ++j) {
      const uint32_t* wrow = w + (blk * pack + j) * 128;
      const uint32_t* irow = in + (blk * pack + j) * 128;
      uint32_t any = 0;
      for (int lane = 0; lane < 128; ++lane) any |= wrow[lane];
      if (!any) continue;  // sparse planes: skip empty sub-blocks cheaply
      for (int b = 0; b < 32; ++b) {
        if (!(any & (1u << b))) continue;
        const uint32_t bit = 1u << b;
        const int64_t rbase = base + (j * 32 + b) * 128;
        for (int lane = 0; lane < 128; ++lane) {
          if (wrow[lane] & bit) {
            rows_out[k] = rbase + lane;
            cert_out[k] = (irow[lane] & bit) ? 1 : 0;
            ++k;
          }
        }
      }
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// contained-span merge: emit the union of contained-span rows (all certain)
// and kernel rows (with their certainty), ascending, deduplicating kernel
// rows that fall inside a span — one two-pointer pass replacing the
// span_rows + rows_in_spans + positional-merge numpy pipeline.
// ---------------------------------------------------------------------------

extern "C" int64_t merge_rows_spans(const int64_t* span_lo,
                                    const int64_t* span_hi, int64_t n_spans,
                                    const int64_t* rows, const uint8_t* cert,
                                    int64_t n_rows, int64_t* out_rows,
                                    uint8_t* out_cert) {
  int64_t k = 0, r = 0;
  for (int64_t s = 0; s < n_spans; ++s) {
    const int64_t lo = span_lo[s], hi = span_hi[s];  // [lo, hi)
    // kernel rows strictly before this span
    while (r < n_rows && rows[r] < lo) {
      out_rows[k] = rows[r];
      out_cert[k] = cert[r];
      ++k; ++r;
    }
    // the span itself (all rows certain)
    for (int64_t v = lo; v < hi; ++v) {
      out_rows[k] = v;
      out_cert[k] = 1;
      ++k;
    }
    // skip kernel duplicates inside the span
    while (r < n_rows && rows[r] < hi) ++r;
  }
  while (r < n_rows) {
    out_rows[k] = rows[r];
    out_cert[k] = cert[r];
    ++k; ++r;
  }
  return k;
}

// ---------------------------------------------------------------------------
// counting argsort: stable O(n) argsort of small-integer keys (grid cell
// ids in the spatial join; np.argsort's n log n dominated join setup).
// ---------------------------------------------------------------------------

extern "C" void counting_argsort(const int32_t* keys, int64_t n,
                                 int64_t n_buckets, uint32_t* perm) {
  std::vector<int64_t> offsets(static_cast<size_t>(n_buckets) + 1, 0);
  for (int64_t i = 0; i < n; ++i) ++offsets[keys[i] + 1];
  for (int64_t b = 0; b < n_buckets; ++b) offsets[b + 1] += offsets[b];
  for (int64_t i = 0; i < n; ++i)
    perm[offsets[keys[i]]++] = static_cast<uint32_t>(i);
}

// wide-only decode (extent scans skip the inner plane entirely)
extern "C" int64_t bitmask_decode(const int32_t* wide, const int64_t* bids,
                                  int64_t n_real, int64_t pack, int64_t block,
                                  int64_t* rows_out) {
  const uint32_t* w = (const uint32_t*)wide;
  int64_t k = 0;
  for (int64_t blk = 0; blk < n_real; ++blk) {
    int64_t base = bids[blk] * block;
    for (int64_t j = 0; j < pack; ++j) {
      const uint32_t* wrow = w + (blk * pack + j) * 128;
      uint32_t any = 0;
      for (int lane = 0; lane < 128; ++lane) any |= wrow[lane];
      if (!any) continue;
      for (int b = 0; b < 32; ++b) {
        if (!(any & (1u << b))) continue;
        const uint32_t bit = 1u << b;
        const int64_t rbase = base + (j * 32 + b) * 128;
        for (int lane = 0; lane < 128; ++lane) {
          if (wrow[lane] & bit) rows_out[k++] = rbase + lane;
        }
      }
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// XZ index write path: element boxes -> XZ sequence codes (the extent-table
// analogue of z3_write_keys). Same construction as curve/xzsfc.py
// XZSFC.length_at + sequence_code (Boehm et al. XZ-ordering, re-derived;
// reference XZ2SFC.index:54-77): deepest level whose enlarged cell still
// contains the element, then the preorder code of the cell holding the
// element's low corner at that level. One scalar pass per element replaces
// ~2*g full-array numpy passes.
// ---------------------------------------------------------------------------

extern "C" void xz_index(const double* lo, const double* hi, int64_t n,
                         int32_t dims, int32_t g, const int64_t* subtree,
                         int64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t e = 0; e < n; ++e) {
    const double* el = lo + e * dims;
    const double* eh = hi + e * dims;
    double extent = 0.0;
    for (int32_t d = 0; d < dims; ++d)
      extent = std::max(extent, eh[d] - el[d]);
    int64_t l1 = (int64_t)std::floor(std::log(std::max(extent, 1e-300)) /
                                     std::log(0.5));
    if (l1 > g) l1 = g;
    const int64_t lp = std::min<int64_t>(l1 + 1, g);
    const double w2 = std::ldexp(1.0, (int)-lp);  // 0.5^lp, exact
    bool fits = true;
    for (int32_t d = 0; d < dims; ++d) {
      const double anchor = std::floor(el[d] / w2) * w2;
      if (eh[d] > anchor + 2.0 * w2) { fits = false; break; }
    }
    int64_t length = fits ? lp : std::max<int64_t>(l1, 0);
    if (length > g) length = g;
    int64_t cs = 0;
    double clo[4] = {0, 0, 0, 0}, chi[4] = {1, 1, 1, 1};
    for (int64_t i = 0; i < length; ++i) {
      int64_t q = 0;
      for (int32_t d = 0; d < dims; ++d) {
        const double c = (clo[d] + chi[d]) * 0.5;
        if (el[d] >= c) { q |= (int64_t)1 << d; clo[d] = c; }
        else chi[d] = c;
      }
      cs += 1 + q * subtree[i + 1];
    }
    out[e] = cs;
  }
}

// ---------------------------------------------------------------------------
// XZ range decomposition: covering sequence-code ranges of query boxes.
// Same BFS + budget + merge semantics as curve/xzsfc.py XZSFC.ranges
// (re-derived XZ-ordering construction; reference XZ2SFC.ranges:146-252):
// a cell whose ENLARGED extent is contained in a query covers its whole
// subtree (contained=true, no row filter); an overlapping cell emits its
// own code and recurses. Per-level budget of 2*max_ranges, then a
// sort+merge that only glues same-kind neighbors and closes the smallest
// gaps to reach max_ranges. Python's per-cell numpy ops cost 3-116 ms per
// query at g=12; this pass is ~100x cheaper.
// ---------------------------------------------------------------------------

namespace {
struct XzCell {
  double lo[4];
  int32_t level;
  int64_t cs;
};
struct XzRange {
  uint64_t lo, hi;
  uint8_t contained;
};
}  // namespace

extern "C" int64_t xz_ranges(int32_t dims, int32_t g, const int64_t* subtree,
                             const double* qlo, const double* qhi, int64_t nq,
                             int64_t max_ranges, uint64_t* out_lo,
                             uint64_t* out_hi, uint8_t* out_cont,
                             int64_t cap) {
  if (dims > 4) return -1;
  const int32_t children = 1 << dims;
  std::vector<XzCell> level_cells, nxt;
  XzCell root{};
  for (int32_t d = 0; d < dims; ++d) root.lo[d] = 0.0;
  root.level = 0;
  root.cs = 0;
  level_cells.push_back(root);
  std::vector<XzRange> ranges;

  while (!level_cells.empty()) {
    nxt.clear();
    const int64_t budget_left = max_ranges * 2 - (int64_t)ranges.size();
    if (budget_left <= 0) break;
    for (const XzCell& c : level_cells) {
      const double w = std::ldexp(1.0, -c.level);
      bool contained = false, overlaps = false;
      for (int64_t q = 0; q < nq && !contained; ++q) {
        bool cont = true;
        for (int32_t d = 0; d < dims; ++d) {
          if (!(qlo[q * dims + d] <= c.lo[d] &&
                qhi[q * dims + d] >= c.lo[d] + 2.0 * w)) {
            cont = false;
            break;
          }
        }
        contained |= cont;
      }
      if (contained) {
        ranges.push_back({(uint64_t)c.cs,
                          (uint64_t)(c.cs + subtree[c.level] - 1), 1});
        continue;
      }
      for (int64_t q = 0; q < nq && !overlaps; ++q) {
        bool ov = true;
        for (int32_t d = 0; d < dims; ++d) {
          if (!(qlo[q * dims + d] <= c.lo[d] + 2.0 * w &&
                qhi[q * dims + d] >= c.lo[d])) {
            ov = false;
            break;
          }
        }
        overlaps |= ov;
      }
      if (!overlaps) continue;
      ranges.push_back({(uint64_t)c.cs, (uint64_t)c.cs, 0});
      if (c.level < g) {
        const int64_t sub = subtree[c.level + 1];
        const double half = w * 0.5;
        for (int32_t q = 0; q < children; ++q) {
          XzCell ch{};
          for (int32_t d = 0; d < dims; ++d)
            ch.lo[d] = c.lo[d] + (((q >> d) & 1) ? half : 0.0);
          ch.level = c.level + 1;
          ch.cs = c.cs + 1 + q * sub;
          nxt.push_back(ch);
        }
      }
    }
    level_cells.swap(nxt);
  }
  // budget exhausted: whole subtrees for unprocessed overlapping cells
  for (const XzCell& c : level_cells) {
    const double w = std::ldexp(1.0, -c.level);
    bool overlaps = false;
    for (int64_t q = 0; q < nq && !overlaps; ++q) {
      bool ov = true;
      for (int32_t d = 0; d < dims; ++d) {
        if (!(qlo[q * dims + d] <= c.lo[d] + 2.0 * w &&
              qhi[q * dims + d] >= c.lo[d])) {
          ov = false;
          break;
        }
      }
      overlaps |= ov;
    }
    if (overlaps)
      ranges.push_back({(uint64_t)c.cs,
                        (uint64_t)(c.cs + subtree[c.level] - 1), 0});
  }

  if (ranges.empty()) return 0;
  // sort + merge same-kind neighbors (curve/zranges.py merge_ranges)
  std::sort(ranges.begin(), ranges.end(), [](const XzRange& a, const XzRange& b) {
    return a.lo != b.lo ? a.lo < b.lo : a.hi < b.hi;
  });
  std::vector<XzRange> merged;
  merged.push_back(ranges[0]);
  for (size_t i = 1; i < ranges.size(); ++i) {
    XzRange& last = merged.back();
    const XzRange& r = ranges[i];
    if (r.lo <= last.hi + 1 && r.contained == last.contained) {
      last.hi = std::max(last.hi, r.hi);
    } else {
      merged.push_back(r);
    }
  }
  if (max_ranges > 0 && (int64_t)merged.size() > max_ranges) {
    const int64_t k = (int64_t)merged.size() - max_ranges;
    std::vector<int64_t> gap_idx(merged.size() - 1);
    for (size_t i = 0; i + 1 < merged.size(); ++i) gap_idx[i] = (int64_t)i;
    std::nth_element(
        gap_idx.begin(), gap_idx.begin() + (k - 1), gap_idx.end(),
        [&](int64_t a, int64_t b) {
          return merged[a + 1].lo - merged[a].hi < merged[b + 1].lo - merged[b].hi;
        });
    std::vector<uint8_t> close(merged.size() - 1, 0);
    for (int64_t i = 0; i < k; ++i) close[gap_idx[i]] = 1;
    std::vector<XzRange> out;
    out.push_back(merged[0]);
    for (size_t i = 1; i < merged.size(); ++i) {
      if (close[i - 1]) {
        out.back().hi = std::max(out.back().hi, merged[i].hi);
        out.back().contained = 0;
      } else {
        out.push_back(merged[i]);
      }
    }
    merged.swap(out);
  }
  if ((int64_t)merged.size() > cap) return -1;
  for (size_t i = 0; i < merged.size(); ++i) {
    out_lo[i] = merged[i].lo;
    out_hi[i] = merged[i].hi;
    out_cont[i] = merged[i].contained;
  }
  return (int64_t)merged.size();
}
