// The register-window skeleton that K2's planar entry (chain_planar.cu) and
// K3 (rank_chain_planar.cu) share, and the stages in their run and walking
// forms (K4 and K5, tiled_lanes.cuh, run the same forms over 2-D tiles).
//
// A block owns (plane, tile of rows_per_block output rows). Its two stage
// buffers in shared memory hold padded rows: column 0 of a row sits kLead
// bytes in, and the columns on each side of the plane's (four or more) hold
// copies of column 0 and column w - 1. Above row 0 and below row h - 1 the
// buffer holds copies of those rows. So a stage reads every tap with a
// plain offset, with no clamp: the pads are the clamp of its input, and the
// stage that wrote that input filled them, from its own values (every
// stage clamps at the edges of its own input, as hipe_tpu/ops/blur.py
// does). Clamps cost a few stores a row a stage, not two instructions a tap.
//
// Threads are laid out as (row, run of kRun = 8 bytes), once a launch: no
// division a byte. A thread keeps its run for a whole stage and goes down
// its rows; what the run is to the plane's edge is worked out once. It loads
// each input row it needs as aligned words (columns x - 4 .. x + 11 around
// its run x .. x + 7: a 32-bit, a 64-bit and a 32-bit load), takes the
// bytes out in registers, computes its eight outputs from values they share
// (per-column sums, differences, sorts and extrema), and stores them with
// one 64-bit store; runs of 8 beat runs of 4 (PERF.md §6). gaussian3,
// sharpen, edge and the 3x3 median, the stages of the chain and denoise
// streams, go two pixels a 32-bit word in 16-bit lanes: half the adds, and
// one DPX instruction for the minimum or maximum of three pairs.
//
// gaussian3, sharpen, edge and the median walk (Walks, walk): a thread row
// takes a band of consecutive rows of the stage, the bands split evenly,
// and each thread walks down its band with the column pairs of the rows
// above, at and below in registers, in rotation, so each input row is
// loaded (3 loads, 6 shared-memory wavefronts a warp) and unpacked (10 byte
// permutes) once: per run of 8 outputs, 3 loads and 10 permutes where a run
// at a time took 9 and 30 (gaussian3, edge, the median) or 5 and 18
// (sharpen, which reads only its own columns above and below), plus two
// rows to start each band. Every other stage steps down its rows by the
// thread rows, a run at a time. The three rows' 24 pair registers live
// through a whole band: K2's kernel takes 64 registers (four blocks an SM)
// where the run forms took 63, and is bound to them (__launch_bounds__):
// left free, ptxas took 80, three blocks an SM, and the walk gained 3%,
// not 15% (PERF.md §6).
// The stages compute what chain_stages.cuh's and rank_stages.cuh's
// functors compute, to the bit; the wide rank and kernel stages of K3 are
// those functors, reading the padded buffer through Win.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "chain_stages.cuh"

namespace {
namespace lanes {

constexpr int kRun = 8;             // output bytes a thread computes at once
constexpr int kWords = kRun / 4;    // 32-bit words of a run
constexpr int kLead = 16;           // bytes before column 0 of a buffer row (16-aligned)
static_assert(kRun == 8, "a run is two words: four output pairs of 16-bit lanes");

// Bytes of a buffer row for planes w wide: kLead, the w columns, and pads up
// to column round_up(w, kRun) + 3, rounded up to 16 bytes.
// ops/planar.py:lane_pitch computes the same.
__host__ __device__ constexpr long long lane_pitch(long long w) {
  return ((w + kRun - 1) / kRun * kRun + kLead + 4 + 15) & ~15LL;
}

__device__ __forceinline__ uint32_t splat(uint32_t b) { return b * 0x01010101u; }

// Byte i (0..3) of a word, as an int.
__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return static_cast<int>(__byte_perm(w, 0, 0x4440 | i));
}

// Column x + c (c in -4 .. kRun + 3) of a row loaded by Win::load at run x.
__device__ __forceinline__ int px(const uint32_t wd[kWords + 2], int c) {
  return byte_of(wd[(c + 4) >> 2], (c + 4) & 3);
}

// A run's output bytes, as words; aligned so that one load or store moves it.
struct alignas(4 * kWords) Run {
  uint32_t w[kWords];
};

// The low bytes of o[0 .. kRun), as a run.
__device__ __forceinline__ Run pack(const int o[kRun]) {
  Run r;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    r.w[j] = __byte_perm(__byte_perm(o[4 * j], o[4 * j + 1], 0x0040),
                         __byte_perm(o[4 * j + 2], o[4 * j + 3], 0x0040), 0x5410);
  }
  return r;
}

// Byte i (0 .. kRun) of a run; i need not be a constant.
__device__ __forceinline__ uint32_t run_byte(const Run& r, int i) {
  return __byte_perm(i < 4 ? r.w[0] : r.w[1], 0, 0x4440 | (i & 3));
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return static_cast<int>(__vimin3_u32(a, b, c));  // Hopper's DPX, for 0..255
}
__device__ __forceinline__ int max3(int a, int b, int c) {
  return static_cast<int>(__vimax3_u32(a, b, c));
}

// Two pixels in a 32-bit word, in 16-bit lanes: pair (a, b) holds column a
// in bits 0-15 and column b in bits 16-31. Sums of non-negative lanes that
// stay below 2^16 are exact in one 32-bit add, and so is a difference whose
// every lane ends non-negative; a signed value is carried with a bias.
// Hopper's DPX takes the minimum and maximum of three pairs at once.
__device__ __forceinline__ uint32_t pmin3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimin3_u16x2(a, b, c);
}
__device__ __forceinline__ uint32_t pmax3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimax3_u16x2(a, b, c);
}
__device__ __forceinline__ uint32_t pmid3(uint32_t a, uint32_t b, uint32_t c) {
  return a + b + c - pmin3(a, b, c) - pmax3(a, b, c);  // lanes <= 765: exact
}
__device__ __forceinline__ uint32_t pabsdiff(uint32_t a, uint32_t b) {
  return pmax3(a, b, b) - pmin3(a, b, b);
}

// The column pairs a run of 8 needs from a row loaded by Win::load: pairs
// (-1, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7), (6, 8) of columns
// around the run; output pair k, columns (o, o + 2) with o = 0, 1, 4, 5,
// reads pairs b, b + 1, b + 2 with b = k + (k & 2). Ten byte permutes.
__device__ __forceinline__ void col_pairs(const uint32_t wd[4], uint32_t c[8]) {
  const uint32_t o0 = __byte_perm(wd[0], 0, 0x4341);  // (-3, -1)
  const uint32_t e1 = __byte_perm(wd[1], 0, 0x4240);  // (0, 2)
  const uint32_t o1 = __byte_perm(wd[1], 0, 0x4341);  // (1, 3)
  const uint32_t e2 = __byte_perm(wd[2], 0, 0x4240);  // (4, 6)
  const uint32_t o2 = __byte_perm(wd[2], 0, 0x4341);  // (5, 7)
  const uint32_t e3 = __byte_perm(wd[3], 0, 0x4240);  // (8, 10)
  c[0] = __byte_perm(o0, o1, 0x5432);
  c[1] = e1;
  c[2] = o1;
  c[3] = __byte_perm(e1, e2, 0x5432);
  c[4] = __byte_perm(o1, o2, 0x5432);
  c[5] = e2;
  c[6] = o2;
  c[7] = __byte_perm(e2, e3, 0x5432);
}

// The output pairs' own columns, (0, 2), (1, 3), (4, 6), (5, 7), of a run.
__device__ __forceinline__ void own_pairs(const Run& r, uint32_t c[4]) {
  c[0] = __byte_perm(r.w[0], 0, 0x4240);
  c[1] = __byte_perm(r.w[0], 0, 0x4341);
  c[2] = __byte_perm(r.w[1], 0, 0x4240);
  c[3] = __byte_perm(r.w[1], 0, 0x4341);
}

// The low bytes of the four output pairs' lanes, as a run.
__device__ __forceinline__ Run pack_pairs(const uint32_t o[4]) {
  Run r;
  r.w[0] = __byte_perm(o[0], o[1], 0x6240);
  r.w[1] = __byte_perm(o[2], o[3], 0x6240);
  return r;
}

// A stage's input: padded rows in shared memory. row0 is column 0 of the
// buffer row that holds plane row `base`.
struct Win {
  const uint8_t* row0;
  int pitch;
  int base;

  __device__ __forceinline__ const uint8_t* at(int y, int x) const {
    return row0 + (y - base) * pitch + x;
  }
  // Columns x - 4 .. x + kRun + 3 of row y, for a run x (a multiple of kRun).
  __device__ __forceinline__ void load(int y, int x, uint32_t wd[kWords + 2]) const {
    const uint8_t* p = at(y, x);
    wd[0] = reinterpret_cast<const uint32_t*>(p)[-1];
    const Run mid = *reinterpret_cast<const Run*>(p);
#pragma unroll
    for (int j = 0; j < kWords; ++j) wd[j + 1] = mid.w[j];
    wd[kWords + 1] = *reinterpret_cast<const uint32_t*>(p + kRun);
  }
  // Columns x .. x + kRun - 1 of row y.
  __device__ __forceinline__ Run load_run(int y, int x) const {
    return *reinterpret_cast<const Run*>(at(y, x));
  }
  // chain_stages.cuh's Src interface, for the per-pixel functors: the pads
  // make every row and column in reach readable as it is.
  __device__ __forceinline__ int row(int y) const { return (y - base) * pitch; }
  __device__ __forceinline__ int get(int line, int x, int) const { return row0[line + x]; }
};

// What a thread's run at column x is to the plane's edge, fixed for a whole
// stage: whether it holds column 0, whether it holds column w - 1, and
// which of its bytes lie inside the plane.
struct RunEdge {
  int keep;  // columns of the run inside the plane: >= 1
  bool first;
  bool last;
  uint32_t mask[kWords];

  __device__ __forceinline__ RunEdge(int x, int w) {
    keep = w - x;
    first = x == 0;
    last = keep <= kRun;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int kj = keep - 4 * j;
      mask[j] = kj >= 4 ? 0xFFFFFFFFu : kj <= 0 ? 0u : 0xFFFFFFFFu >> (8 * (4 - kj));
    }
  }
};

// The output of a stage with a stage after it: row0 is column 0 of the
// buffer row that holds plane row `base`. Each run is stored with the pads
// the next stage reads (a run at column 0 fills the left pad, the last run
// its columns past w - 1 and the right pad) and, at row 0 and row h - 1,
// replicated into the `top` rows above and the `bot` rows below.
struct SharedSink {
  uint8_t* row0;
  int pitch;
  int base;
  int h;
  int top;
  int bot;

  __device__ __forceinline__ void put(int y, int x, const RunEdge& e, Run r) const {
    uint8_t* p = row0 + (y - base) * pitch + x;
    uint32_t fill = 0;
    if (e.last) {
      fill = splat(run_byte(r, e.keep - 1));
#pragma unroll
      for (int j = 0; j < kWords; ++j) r.w[j] = (r.w[j] & e.mask[j]) | (fill & ~e.mask[j]);
    }
    const uint32_t left = splat(r.w[0] & 0xFFu);
    store(p, r, left, fill, e);
    if (y == 0) {
      for (int k = 1; k <= top; ++k) store(p - k * pitch, r, left, fill, e);
    }
    if (y == h - 1) {
      for (int k = 1; k <= bot; ++k) store(p + k * pitch, r, left, fill, e);
    }
  }

  // A run at q, and the left pad before it or the right pad after it.
  __device__ __forceinline__ static void store(uint8_t* q, const Run& r, uint32_t left,
                                               uint32_t fill, const RunEdge& e) {
    *reinterpret_cast<Run*>(q) = r;
    if (e.first) reinterpret_cast<uint32_t*>(q)[-1] = left;
    if (e.last) *reinterpret_cast<uint32_t*>(q + kRun) = fill;
  }
};

// The last stage's output in device memory: row0 is output row 0 of the
// plane, base the output offset; `vec` says a run's store is aligned (the
// output and w are multiples of kRun bytes).
struct GlobalSink {
  uint8_t* row0;
  int base;
  int w;
  bool vec;

  __device__ __forceinline__ void put(int y, int x, const RunEdge& e, const Run& r) const {
    uint8_t* p = row0 + (y - base) * w + x;
    if (vec) {
      *reinterpret_cast<Run*>(p) = r;
      return;
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < e.keep) p[i] = static_cast<uint8_t>(r.w[i >> 2] >> (8 * (i & 3)));
    }
  }
};

// --- gaussian3, sharpen, edge and the 3x3 median in 16-bit lanes, from
// the column pairs of the rows above (t), at (m) and below (b) the output
// row. Output pair k (columns o, o + 2; o = 0, 1, 4, 5) reads pairs j, j +
// 1, j + 2 with j = k + (k & 2); pair j + 1 holds its own columns. A thread
// walks down a band of rows with them (walk, below), so each input row is
// loaded and unpacked once.

// The column pairs of row y around the run at x.
__device__ __forceinline__ void load_pairs(const Win& s, int y, int x, uint32_t c[8]) {
  uint32_t wd[kWords + 2];
  s.load(y, x, wd);
  col_pairs(wd, c);
}

// gaussian 1: column sums t + 2m + b (<= 1020), row sums (<= 4080), >> 4 of
// the word: a lane's low byte takes no bit of the other lane.
struct Gaussian3Pairs {
  __device__ __forceinline__ Run operator()(const uint32_t t[8], const uint32_t m[8],
                                            const uint32_t b[8]) const {
    uint32_t v[8], o[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = t[j] + 2 * m[j] + b[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k + (k & 2);
      o[k] = (v[j] + 2 * v[j + 1] + v[j + 2]) >> 4;
    }
    return pack_pairs(o);
  }
};

// Sobel: per column the sum t + 2m + b (<= 1020), shared by three outputs;
// |gx| = |sum right - sum left| and |gy| = |B - T|, B and T the binomial
// row sums of the rows below and above, each an absolute difference of
// non-negative lanes.
struct EdgePairs {
  __device__ __forceinline__ Run operator()(const uint32_t t[8], const uint32_t m[8],
                                            const uint32_t b[8]) const {
    uint32_t cs[8], o[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[j] = t[j] + 2 * m[j] + b[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k + (k & 2);
      const uint32_t gx = pabsdiff(cs[j + 2], cs[j]);
      const uint32_t gy = pabsdiff(b[j] + 2 * b[j + 1] + b[j + 2], t[j] + 2 * t[j + 1] + t[j + 2]);
      o[k] = pmin3(gx + gy, 255u * 0x10001u, 255u * 0x10001u);  // gx + gy <= 2040
    }
    return pack_pairs(o);
  }
};

// sharpen of one output pair, clip(5c - u - d - l - r, 0, 255): 5c + 1020
// - u - d - l - r lies in [0, 2295], so the lanes stay apart; clamped to
// [1020, 1275] and unbiased.
__device__ __forceinline__ uint32_t sharpen_pair(uint32_t l, uint32_t c, uint32_t r, uint32_t u,
                                                 uint32_t d) {
  constexpr uint32_t kBias = 1020u * 0x10001u;
  const uint32_t v = 5 * c + kBias - u - d - l - r;
  return pmin3(pmax3(v, kBias, kBias), kBias + 255u * 0x10001u, kBias + 255u * 0x10001u) - kBias;
}

// sharpen: u and d the own columns of the rows above and below (pairs j + 1).
struct SharpenPairs {
  __device__ __forceinline__ Run operator()(const uint32_t t[8], const uint32_t m[8],
                                            const uint32_t b[8]) const {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k + (k & 2);
      o[k] = sharpen_pair(m[j], m[j + 1], m[j + 2], t[j + 1], b[j + 1]);
    }
    return pack_pairs(o);
  }
};

// The 3x3 median: each column pair sorted once (lo, mid, hi; mid = a + b +
// c - lo - hi), then med3(max of the los, med3 of the mids, min of the his)
// over three column pairs, Paeth's identity with columns for rows. Output
// pairs 0 and 1 read column pairs 0-3, 2 and 3 read 4-7: taken a half at a
// time, the sorts hold 12 registers, not 24, beside the walk's three rows
// (K3's 3x3 kernel then fits 64 registers, four blocks an SM, unspilled).
struct Median3Pairs {
  __device__ __forceinline__ Run operator()(const uint32_t t[8], const uint32_t m[8],
                                            const uint32_t b[8]) const {
    uint32_t o[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lo[4], mi[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * half + i;
        lo[i] = pmin3(t[j], m[j], b[j]);
        hi[i] = pmax3(t[j], m[j], b[j]);
        mi[i] = t[j] + m[j] + b[j] - lo[i] - hi[i];
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        o[2 * half + k] = pmid3(pmax3(lo[k], lo[k + 1], lo[k + 2]),
                                pmid3(mi[k], mi[k + 1], mi[k + 2]),
                                pmin3(hi[k], hi[k + 1], hi[k + 2]));
      }
    }
    return pack_pairs(o);
  }
};

// A stage that walks: the pair forms above. Every other stage is computed a
// run at a time from the buffer (the run forms below). K5 runs sharpen a run
// at a time too: walking cost it 5% there (tiled_stage_planar.cu).
template <class S>
struct Walks {
  static constexpr bool value = false;
};
template <>
struct Walks<Gaussian3Pairs> {
  static constexpr bool value = true;
};
template <>
struct Walks<EdgePairs> {
  static constexpr bool value = true;
};
template <>
struct Walks<SharpenPairs> {
  static constexpr bool value = true;
};
template <>
struct Walks<Median3Pairs> {
  static constexpr bool value = true;
};

// Rows [ya, yb) of the run at x, the three rows' column pairs kept in
// registers: each step loads and unpacks one row, and the three arrays
// take turns as the row above, at and below, so no register moves.
template <class Stage, class Sink>
__device__ __forceinline__ void walk(const Stage& f, const Win& s, const Sink& dst,
                                     const RunEdge& e, int x, int ya, int yb) {
  if (ya >= yb) return;
  uint32_t p0[8], p1[8], p2[8];
  load_pairs(s, ya - 1, x, p0);
  load_pairs(s, ya, x, p1);
  for (int y = ya;; y += 3) {
    load_pairs(s, y + 1, x, p2);
    dst.put(y, x, e, f(p0, p1, p2));
    if (y + 1 >= yb) break;
    load_pairs(s, y + 2, x, p0);
    dst.put(y + 1, x, e, f(p1, p2, p0));
    if (y + 2 >= yb) break;
    load_pairs(s, y + 3, x, p1);
    dst.put(y + 2, x, e, f(p2, p0, p1));
    if (y + 3 >= yb) break;
  }
}

// A 2-D thread map over (rows, units of a row): `cols` threads a row,
// `rows` rows at a time; threads past cols * rows stay idle.
struct Map {
  int tx;
  int ty;
  int cols;
  int rows;
  bool active;

  __device__ __forceinline__ explicit Map(int units) {
    cols = min(units, kThreads);
    rows = kThreads / cols;
    ty = static_cast<int>(threadIdx.x) / cols;
    tx = static_cast<int>(threadIdx.x) - ty * cols;
    active = ty < rows;
  }
};

// One block's tile: both buffers, its rows, and the launch's geometry.
struct Tile {
  uint8_t* buf0;  // column 0 of buffer 0's row 0; buffer 1 follows it
  int buf_bytes;  // nrows * pitch
  int pitch;
  int nrows;
  int plane;
  int g0;
  int g1;
  int base;
  int h;
  int w;
  int ho;
  int out_off;
  Map runs;

  __device__ __forceinline__ Tile(uint8_t* smem, int h_, int w_, int ho_, int out_off_,
                                  int total_r, int rows_per_block, int tiles)
      : runs((w_ + kRun - 1) / kRun) {
    h = h_;
    w = w_;
    ho = ho_;
    out_off = out_off_;
    pitch = static_cast<int>(lane_pitch(w));
    nrows = rows_per_block + 2 * total_r;
    buf_bytes = nrows * pitch;
    buf0 = smem + kLead;
    plane = static_cast<int>(blockIdx.x) / tiles;
    g0 = (static_cast<int>(blockIdx.x) - plane * tiles) * rows_per_block + out_off;
    g1 = min(g0 + rows_per_block, ho + out_off);
    base = g0 - total_r;
  }

  // Plane rows [lo, hi) of the input, each clamped into the plane, into
  // buffer 0 with their pads: the first stage's input, clamped at every
  // edge. 16-byte loads and stores when `vec` (the plane's base and w are
  // multiples of 16), else bytes.
  __device__ __forceinline__ void stage_input(const uint8_t* __restrict__ in, int lo, int hi,
                                              bool vec) const {
    const uint8_t* plane_in = in + static_cast<size_t>(plane) * h * w;
    const int n = hi - lo;
    uint8_t* dst0 = buf0 + (lo - base) * pitch;
    if (vec) {
      const Map m(w / 16);
      if (m.active) {
        for (int i = m.ty; i < n; i += m.rows) {
          const int y = min(max(lo + i, 0), h - 1);
          const uint4* src = reinterpret_cast<const uint4*>(plane_in + static_cast<size_t>(y) * w);
          uint4* dst = reinterpret_cast<uint4*>(dst0 + i * pitch);
          for (int c = m.tx; c < w / 16; c += m.cols) dst[c] = src[c];
        }
      }
    } else {
      const Map m(w);
      if (m.active) {
        for (int i = m.ty; i < n; i += m.rows) {
          const int y = min(max(lo + i, 0), h - 1);
          const uint8_t* src = plane_in + static_cast<size_t>(y) * w;
          uint8_t* dst = dst0 + i * pitch;
          for (int c = m.tx; c < w; c += m.cols) dst[c] = src[c];
        }
      }
    }
    const int pad_end = (w + kRun - 1) / kRun * kRun + 4;
    for (int i = static_cast<int>(threadIdx.x); i < n; i += kThreads) {
      const int y = min(max(lo + i, 0), h - 1);
      const uint8_t* src = plane_in + static_cast<size_t>(y) * w;
      uint8_t* dst = dst0 + i * pitch;
      reinterpret_cast<uint32_t*>(dst)[-1] = splat(src[0]);
      const uint8_t e = src[w - 1];
      for (int c = w; c < pad_end; ++c) dst[c] = e;
    }
  }

  // The shared memory after both buffers.
  __device__ __forceinline__ uint8_t* tail() const { return buf0 - kLead + 2 * buf_bytes; }

  // One stage over rows [r0, r1): each thread's runs, each down its rows. A
  // stage that walks takes a band of consecutive rows a thread row, the
  // bands split evenly; any other steps by the thread rows.
  template <class Stage, class Sink>
  __device__ __forceinline__ void run(const Stage& stage, const Win& src, const Sink& dst,
                                      int r0, int r1) const {
    if (!runs.active) return;
    if constexpr (Walks<Stage>::value) {
      const int ya = r0 + (r1 - r0) * runs.ty / runs.rows;
      const int yb = r0 + (r1 - r0) * (runs.ty + 1) / runs.rows;
      for (int x = runs.tx * kRun; x < w; x += runs.cols * kRun) {
        walk(stage, src, dst, RunEdge(x, w), x, ya, yb);
      }
    } else {
      for (int x = runs.tx * kRun; x < w; x += runs.cols * kRun) {
        const RunEdge e(x, w);
        for (int y = r0 + runs.ty; y < r1; y += runs.rows) dst.put(y, x, e, stage(src, y, x));
      }
    }
  }

  // Stage k of the program, reading buffer k & 1 over rows [r0, r1): into
  // the other buffer with the pads for a next stage of radius rn, or, for
  // the last stage, into the plane's output rows (a store a run if vec).
  template <class Stage>
  __device__ __forceinline__ void stage(const Stage& f, int k, int rn, bool last, int r0, int r1,
                                        uint8_t* __restrict__ out, bool vec) const {
    const int b = k & 1;
    const Win src{buf0 + b * buf_bytes, pitch, base};
    if (last) {
      run(f, src, GlobalSink{out + static_cast<size_t>(plane) * ho * w, out_off, w, vec}, r0, r1);
    } else {
      run(f, src,
          SharedSink{buf0 + (b ^ 1) * buf_bytes, pitch, base, h, max(min(rn, -base), 0),
                     max(min(rn, base + nrows - h), 0)},
          r0, r1);
    }
  }
};

// --- Stages, a run of kRun outputs at a time -------------------------------

// gaussian r (r = 2..4; gaussian3 is Gaussian3Pairs): a column sum per
// column, then a row sum, >> 4r (the sums are at most 255 * 2^(4r), exact
// in int32).
template <int R>
struct Gaussian {
  static_assert(R >= 2 && R <= 4, "gaussian3 goes in 16-bit lanes: Gaussian3Pairs");
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    constexpr int kCols = kRun + 2 * R;
    int v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = 0;
#pragma unroll
    for (int dy = 0; dy <= 2 * R; ++dy) {
      uint32_t wd[kWords + 2];
      s.load(y + dy - R, x, wd);
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] += kTaps[R - 1][dy] * px(wd, j - R);
    }
    int o[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      int acc = 0;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) acc += kTaps[R - 1][dx] * v[i + dx];
      o[i] = acc >> (4 * R);
    }
    return pack(o);
  }
};

// sharpen in pairs, a run at a time (K5's form, tiled_lanes.cuh): the
// rows above and below load only the run's own columns.
struct Sharpen {
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    uint32_t wd[kWords + 2], m[8], u[4], d[4];
    s.load(y, x, wd);
    col_pairs(wd, m);
    own_pairs(s.load_run(y - 1, x), u);
    own_pairs(s.load_run(y + 1, x), d);
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k + (k & 2);
      o[k] = sharpen_pair(m[j], m[j + 1], m[j + 2], u[k], d[k]);
    }
    return pack_pairs(o);
  }
};

// Erode (min) and dilate (max): per column, then across three columns.
template <bool kMax>
struct Extreme3 {
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    uint32_t t[kWords + 2], m[kWords + 2], b[kWords + 2];
    s.load(y - 1, x, t);
    s.load(y, x, m);
    s.load(y + 1, x, b);
    int e[kRun + 2];
#pragma unroll
    for (int j = 0; j < kRun + 2; ++j) {
      e[j] = kMax ? max3(px(t, j - 1), px(m, j - 1), px(b, j - 1))
                  : min3(px(t, j - 1), px(m, j - 1), px(b, j - 1));
    }
    int o[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      o[i] = kMax ? max3(e[i], e[i + 1], e[i + 2]) : min3(e[i], e[i + 1], e[i + 2]);
    }
    return pack(o);
  }
};

// Point stages: four bytes a word.
struct Invert {
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    Run r = s.load_run(y, x);
#pragma unroll
    for (int j = 0; j < kWords; ++j) r.w[j] = ~r.w[j];
    return r;
  }
};

struct Solarize {  // x >= 128 ? 255 - x : x, i.e. x ^ 0xFF where bit 7 is set
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    Run r = s.load_run(y, x);
#pragma unroll
    for (int j = 0; j < kWords; ++j) r.w[j] ^= ((r.w[j] >> 7) & 0x01010101u) * 0xFFu;
    return r;
  }
};

struct Posterize {
  int mask;
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    Run r = s.load_run(y, x);
#pragma unroll
    for (int j = 0; j < kWords; ++j) r.w[j] &= splat(static_cast<uint32_t>(mask));
    return r;
  }
};

struct Lut {
  const uint8_t* table;  // 256 bytes in shared memory
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    const Run v = s.load_run(y, x);
    int o[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) o[i] = table[(v.w[i >> 2] >> (8 * (i & 3))) & 0xFFu];
    return pack(o);
  }
};

// A per-pixel functor of rank_stages.cuh (rank, registered kernel), one
// output at a time over the padded buffer.
// The loop stays rolled: a size-9 window's code appears once.
template <class F>
struct PerPixel {
  F f;
  __device__ __forceinline__ Run operator()(const Win& s, int y, int x) const {
    Run r{};
#pragma unroll 1
    for (int i = 0; i < kRun; ++i) {
      const uint32_t v = static_cast<uint32_t>(f(s, y, x + i, 0)) << (8 * (i & 3));
      if (i < 4) {
        r.w[0] |= v;
      } else {
        r.w[1] |= v;
      }
    }
    return r;
  }
};

}  // namespace lanes
}  // namespace
