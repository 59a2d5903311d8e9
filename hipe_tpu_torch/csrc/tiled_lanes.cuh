// The padded 2-D window that K4 (tiled_blur_planar.cu) and K5
// (tiled_stage_planar.cu) share: chain_lanes.cuh's run and walking forms
// over a tile of a large plane, and a per-pixel loop for rank_stages.cuh's
// functors.
//
// A block owns `rows` output rows and `cols` output columns of one plane: a
// launch's tile of TH x TW, TW rounded up to a run of kRun = 8 so that every
// run starts at a plane column that is a multiple of 8, cut at the plane's
// last row and column. Its window in shared memory holds the plane rows
// [y0 - R, y0 + rows + R), each clamped into the plane, so the rows above 0
// and below h - 1 are copies of those rows; and in each row the plane
// columns [c0, c0 + pitch), c0 the tile's first column less 4 rounded down
// to 16, so that a 16-byte chunk of the window is a 16-byte chunk of the
// plane's row. Columns a neighbour tile owns are its real bytes; columns
// before 0 and past w - 1 are copies of columns 0 and w - 1, written once,
// as the window is staged. Every tap is then a plain offset through Win,
// with no clamp: the window's pads are the clamp of the plane.
//
// A stage's run at column x reads columns x - 4 .. x + 11 (Win::load), so a
// window row needs (x0 - 4) rounded down to 16 .. x0 + TW + 4 rounded up to
// 16; window_pitch is the most that takes over the tiles of a launch.
// hipe_tpu_torch/ops/planar.py:tiled_shared_bytes computes the same.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"

namespace {
namespace tiled {

using lanes::kRun;
using lanes::kWords;

// Output columns of a tile TW wide: TW rounded up to a run.
__host__ __device__ constexpr long long tile_cols(long long tw) {
  return (tw + kRun - 1) / kRun * kRun;
}

// Bytes of a window row for tiles TW wide (a multiple of 16): the tile's
// columns and 4 on each side, each end rounded out to 16. A tile starts at
// a multiple of 8, so that is tile_cols + 32 where tile_cols is a multiple
// of 16 and tile_cols + 24 where it is not.
__host__ __device__ constexpr long long window_pitch(long long tw) {
  return (tile_cols(tw) + 8 + 15) / 16 * 16 + 16;
}

// Shared memory of one block: TH + 2R window rows.
__host__ __device__ constexpr long long window_bytes(int r, long long th, long long tw) {
  return (th + 2 * r) * window_pitch(tw);
}

// One block's tile of one plane, and its window.
struct Window {
  uint8_t* buf;  // window row 0 (plane row base), plane column c0
  int pitch;
  int c0;
  int base;   // y0 - R
  int nrows;  // rows + 2R
  int plane;
  int y0;     // first plane row of the tile's output
  int rows;
  int x0;     // first plane column of the tile
  int cols;
  int h;
  int w;
  int ho;
  int out_off;

  // Block blockIdx.x of tiles_y x tiles_x tiles a plane, the tile column
  // fastest; output row o of a plane is plane row o + out_off.
  __device__ __forceinline__ Window(uint8_t* smem, int r, int h_, int w_, int ho_, int out_off_,
                                    int th, int tw, int tiles_y, int tiles_x) {
    h = h_;
    w = w_;
    ho = ho_;
    out_off = out_off_;
    const int twr = static_cast<int>(tile_cols(tw));
    const int tx = static_cast<int>(blockIdx.x) % tiles_x;
    const int rest = static_cast<int>(blockIdx.x) / tiles_x;
    const int ty = rest % tiles_y;
    plane = rest / tiles_y;
    y0 = ty * th + out_off;
    rows = min(th, ho + out_off - y0);
    x0 = tx * twr;
    cols = min(twr, w - x0);
    buf = smem;
    pitch = static_cast<int>(window_pitch(tw));
    c0 = (x0 - 4) & ~15;  // rounded down, below 0 too
    base = y0 - r;
    nrows = rows + 2 * r;
  }

  // Stage the window from the input planes: 16-byte chunks when `vec` (the
  // plane's base and w are multiples of 16, so a chunk lies wholly inside
  // the row or wholly in a pad), else bytes. Every window row is a plane
  // row clamped into the plane, every pad a copy of the row's edge byte.
  __device__ __forceinline__ void stage_input(const uint8_t* __restrict__ in, bool vec) const {
    const uint8_t* plane_in = in + static_cast<size_t>(plane) * h * w;
    if (vec) {
      const int chunks = pitch / 16;
      const lanes::Map m(chunks);
      if (!m.active) return;
#pragma unroll 2
      for (int i = m.ty; i < nrows; i += m.rows) {
        const uint8_t* src = plane_in + static_cast<size_t>(min(max(base + i, 0), h - 1)) * w;
        uint4* dst = reinterpret_cast<uint4*>(buf + i * pitch);
        for (int k = m.tx; k < chunks; k += m.cols) {
          const int c = c0 + 16 * k;
          uint4 v;
          if (c >= 0 && c < w) {
            v = *reinterpret_cast<const uint4*>(src + c);
          } else {
            const uint32_t e = lanes::splat(src[c < 0 ? 0 : w - 1]);
            v = make_uint4(e, e, e, e);
          }
          dst[k] = v;
        }
      }
    } else {
      const lanes::Map m(pitch);
      if (!m.active) return;
      for (int i = m.ty; i < nrows; i += m.rows) {
        const uint8_t* src = plane_in + static_cast<size_t>(min(max(base + i, 0), h - 1)) * w;
        uint8_t* dst = buf + i * pitch;
        for (int k = m.tx; k < pitch; k += m.cols) dst[k] = src[min(max(c0 + k, 0), w - 1)];
      }
    }
  }

  // The stage over the tile, from the window into the output planes (a
  // 64-bit store a run when `vec`). Threads are laid out as (band of rows,
  // run of columns): each takes its runs, and for each walks down a band of
  // consecutive output rows.
  template <class Stage>
  __device__ __forceinline__ void run(const Stage& f, uint8_t* __restrict__ out, bool vec) const {
    const lanes::Win src{buf - c0, pitch, base};
    const lanes::GlobalSink dst{out + static_cast<size_t>(plane) * ho * w, out_off, w, vec};
    const lanes::Map m((cols + kRun - 1) / kRun);
    if (!m.active) return;
    const int band = (rows + m.rows - 1) / m.rows;
    const int ya = y0 + m.ty * band;
    const int yb = min(ya + band, y0 + rows);
    for (int x = x0 + m.tx * kRun; x < x0 + cols; x += m.cols * kRun) {
      const lanes::RunEdge e(x, w);
      if constexpr (lanes::Walks<Stage>::value) {
        lanes::walk(f, src, dst, e, x, ya, yb);
      } else {
        for (int y = ya; y < yb; ++y) dst.put(y, x, e, f(src, y, x));
      }
    }
  }

  // A per-pixel functor (rank_stages.cuh's Rank or Conv) over the tile, one
  // output byte a thread at a time, the threads of a row on consecutive
  // columns: a warp's window loads fall on consecutive bytes, so on distinct
  // shared-memory banks or the same word (a run a thread, as PerPixel goes,
  // puts threads 8 bytes apart: two to a bank). These stages are bound by
  // instruction issue, and a byte store a thread still fills whole
  // segments.
  template <class F>
  __device__ __forceinline__ void run_pixels(const F& f, uint8_t* __restrict__ out) const {
    const lanes::Win src{buf - c0, pitch, base};
    uint8_t* plane_out = out + static_cast<size_t>(plane) * ho * w;
    const lanes::Map m(cols);
    if (!m.active) return;
    for (int y = y0 + m.ty; y < y0 + rows; y += m.rows) {
      uint8_t* line = plane_out + (y - out_off) * w;
      for (int x = x0 + m.tx; x < x0 + cols; x += m.cols) {
        line[x] = static_cast<uint8_t>(f(src, y, x, 0));
      }
    }
  }
};

}  // namespace tiled
}  // namespace
