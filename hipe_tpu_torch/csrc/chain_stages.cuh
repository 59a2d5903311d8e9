// What K2 (chain_planar.cu), K3 (rank_chain_planar.cu), K4 and K5
// (tiled_*_planar.cu) share: the block size, the stage op codes and the
// binomial taps; and the first design's stages, which K2's rows entry runs,
// with the loop that runs one over a tile of whole rows. Each stage is a
// functor: (input buffer, plane row y, pixel column x, channel ch) -> the
// stage's value there, clamping every row and column it reads into the
// plane. They compute what hipe_tpu/ops/blur.py computes, to the bit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Stage op codes. K2 takes 0-6, K3 every one, K5 every one but gaussian;
// hipe_tpu_torch/ops/chain_program.py encodes the same values.
enum Op : int {
  kGaussian = 0,   // arg: radius 1..4
  kSharpen = 1,
  kEdge = 2,
  kInvert = 3,
  kSolarize = 4,
  kPosterize = 5,  // arg: mask
  kLut = 6,        // arg: LUT index
  kMedian = 7,     // 3x3
  kErode = 8,      // 3x3 minimum
  kDilate = 9,     // 3x3 maximum
  kRank = 10,      // arg: rank; size: window edge 3/5/7/9
  kKernel = 11,    // arg: offset of its spec in the tap table; size: 3/5/7/9
};

// Binomial taps C(2r, k) for r = 1..4, row r-1.
__constant__ int kTaps[4][9] = {
    {1, 2, 1},
    {1, 4, 6, 4, 1},
    {1, 6, 15, 20, 15, 6, 1},
    {1, 8, 28, 56, 70, 56, 28, 8, 1},
};

// A stage's input: a shared-memory buffer whose row i, `pitch` bytes long,
// holds plane row base + i from pixel column x0 on. The plane has h rows of
// w pixels, each pixel kC interleaved channel bytes (1: planar; 0: `c`
// bytes, known only at run time). row(y) clamps y into the plane and gives
// the offset to add to col(x) + ch; col(x) clamps x.
template <int kC>
struct Src {
  const uint8_t* buf;
  int pitch;
  int h;
  int base;
  int w;
  int x0;
  int c;

  __device__ __forceinline__ int stride() const { return kC > 0 ? kC : c; }
  __device__ __forceinline__ int row(int y) const {
    return (min(max(y, 0), h - 1) - base) * pitch - x0 * stride();
  }
  __device__ __forceinline__ int col(int x) const {
    return min(max(x, 0), w - 1) * stride();
  }
  // The pixel at clamped column x of a row() line, channel ch.
  __device__ __forceinline__ int get(int line, int x, int ch) const {
    return buf[line + col(x) + ch];
  }
  // The pixel (y, x, ch) itself, for a point stage: no clamp needed.
  __device__ __forceinline__ int at(int y, int x, int ch) const {
    return buf[(y - base) * pitch + (x - x0) * stride() + ch];
  }
};

template <int R>
struct Gaussian {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy <= 2 * R; ++dy) {
      const int line = s.row(y + dy - R);
      int sum = 0;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        sum += kTaps[R - 1][dx] * s.get(line, x + dx - R, ch);
      }
      acc += kTaps[R - 1][dy] * sum;
    }
    return acc >> (4 * R);
  }
};

// The 3x3 neighbourhood v[dy][dx] of (y, x, ch), clamped, as signed ints.
template <class S>
__device__ __forceinline__ void load3x3(const S& s, int y, int x, int ch, int v[3][3]) {
  const int xl = s.col(x - 1) + ch;
  const int xm = s.col(x) + ch;
  const int xr = s.col(x + 1) + ch;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int line = s.row(y + dy - 1);
    v[dy][0] = s.buf[line + xl];
    v[dy][1] = s.buf[line + xm];
    v[dy][2] = s.buf[line + xr];
  }
}

struct Sharpen {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    int v[3][3];
    load3x3(s, y, x, ch, v);
    const int out = 5 * v[1][1] - v[0][1] - v[2][1] - v[1][0] - v[1][2];
    return min(max(out, 0), 255);
  }
};

struct Edge {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    int v[3][3];
    load3x3(s, y, x, ch, v);
    const int gx = (v[0][2] + 2 * v[1][2] + v[2][2]) - (v[0][0] + 2 * v[1][0] + v[2][0]);
    const int gy = (v[2][0] + 2 * v[2][1] + v[2][2]) - (v[0][0] + 2 * v[0][1] + v[0][2]);
    return min(abs(gx) + abs(gy), 255);
  }
};

struct Invert {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    return 255 - s.at(y, x, ch);
  }
};

struct Solarize {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    const int v = s.at(y, x, ch);
    return v >= 128 ? 255 - v : v;
  }
};

struct Posterize {
  int mask;
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    return s.at(y, x, ch) & mask;
  }
};

struct Lut {
  const uint8_t* table;
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    return __ldg(table + s.at(y, x, ch));
  }
};

// Rows [r0, r1) of one stage over whole buffered rows (x0 = 0, pitch =
// w * stride), written to dst row (y - dst_base) of the same pitch.
template <typename Stage, int kC>
__device__ __forceinline__ void run_stage(const Stage& stage, const Src<kC>& s,
                                          uint8_t* dst, int dst_base, int r0,
                                          int r1) {
  const int c = s.stride();
  const int lanes = s.pitch;
  const int count = (r1 - r0) * lanes;
  uint8_t* out = dst + (r0 - dst_base) * lanes;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int dy = i / lanes;
    const int lane = i - dy * lanes;
    const int x = lane / c;
    out[i] = static_cast<uint8_t>(stage(s, r0 + dy, x, lane - x * c));
  }
}

}  // namespace
