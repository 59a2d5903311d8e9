// The exact integer stages that K2 (chain_planar.cu) and K3
// (rank_chain_planar.cu) share, and the loop that runs one over a tile.
// Each stage is a functor: (input buffer, plane row y, column x) -> the
// stage's value at (y, x), clamping every row and column it reads into the
// plane. They compute what hipe_tpu/ops/blur.py computes, to the bit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Stage op codes. K2 takes 0-6, K3 every one; hipe_tpu_torch/ops/cuda_chain.py
// and cuda_rank_chain.py encode the same values.
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

// A stage's input: a shared-memory buffer whose row i holds plane row
// base + i, full width w; the plane has h rows.
struct Src {
  const uint8_t* buf;
  int w;
  int h;
  int base;

  __device__ __forceinline__ const uint8_t* row(int y) const {
    return buf + (min(max(y, 0), h - 1) - base) * w;
  }
  __device__ __forceinline__ int at(int y, int x) const {
    return buf[(y - base) * w + x];
  }
};

template <int R>
struct Gaussian {
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy <= 2 * R; ++dy) {
      const uint8_t* line = s.row(y + dy - R);
      int sum = 0;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        sum += kTaps[R - 1][dx] * line[min(max(x + dx - R, 0), s.w - 1)];
      }
      acc += kTaps[R - 1][dy] * sum;
    }
    return acc >> (4 * R);
  }
};

// The 3x3 neighbourhood v[dy][dx] of (y, x), clamped, as signed ints.
__device__ __forceinline__ void load3x3(const Src& s, int y, int x, int v[3][3]) {
  const int xl = max(x - 1, 0);
  const int xr = min(x + 1, s.w - 1);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint8_t* line = s.row(y + dy - 1);
    v[dy][0] = line[xl];
    v[dy][1] = line[x];
    v[dy][2] = line[xr];
  }
}

struct Sharpen {
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    int v[3][3];
    load3x3(s, y, x, v);
    const int out = 5 * v[1][1] - v[0][1] - v[2][1] - v[1][0] - v[1][2];
    return min(max(out, 0), 255);
  }
};

struct Edge {
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    int v[3][3];
    load3x3(s, y, x, v);
    const int gx = (v[0][2] + 2 * v[1][2] + v[2][2]) - (v[0][0] + 2 * v[1][0] + v[2][0]);
    const int gy = (v[2][0] + 2 * v[2][1] + v[2][2]) - (v[0][0] + 2 * v[0][1] + v[0][2]);
    return min(abs(gx) + abs(gy), 255);
  }
};

struct Invert {
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    return 255 - s.at(y, x);
  }
};

struct Solarize {
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    const int v = s.at(y, x);
    return v >= 128 ? 255 - v : v;
  }
};

struct Posterize {
  int mask;
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    return s.at(y, x) & mask;
  }
};

struct Lut {
  const uint8_t* table;
  __device__ __forceinline__ int operator()(const Src& s, int y, int x) const {
    return __ldg(table + s.at(y, x));
  }
};

// Rows [r0, r1) of one stage, written to dst row (y - dst_base), width w.
template <typename Stage>
__device__ __forceinline__ void run_stage(const Stage& stage, const Src& s,
                                          uint8_t* dst, int dst_base, int r0,
                                          int r1) {
  const int w = s.w;
  const int count = (r1 - r0) * w;
  uint8_t* out = dst + (r0 - dst_base) * w;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int dy = i / w;
    const int x = i - dy * w;
    out[i] = static_cast<uint8_t>(stage(s, r0 + dy, x));
  }
}

}  // namespace
