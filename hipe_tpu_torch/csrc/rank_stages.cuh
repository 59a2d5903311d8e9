// The rank and registered-kernel stages that K3 (rank_chain_planar.cu) and
// K5 (tiled_stage_planar.cu) share: the rank-th smallest of a size x size
// window, and a registered convolution kernel. Per-pixel functors over
// chain_lanes.cuh's padded window (Win), which K3 runs through
// lanes::PerPixel and K5 through tiled_lanes.cuh's run_pixels; they compute
// what hipe_tpu/ops/blur.py computes, to the bit. (The 3x3 median, erode
// and dilate are chain_lanes.cuh's run forms.)
//
// A size-9 window takes some 90 registers a thread, so a kernel that runs
// these is instantiated for the widest window it holds (K3 per program, K5
// per stage): a 3x3 stage never pays a size-9 selection's registers.

#pragma once

#include "chain_stages.cuh"

namespace {

// The rank-th smallest of the window, by bit-serial counting: the rank-th
// smallest is >= c iff |{v < c}| <= rank, so 8 rounds fix the 8 bits, most
// significant first, over the window held in registers.
template <int S>
struct Rank {
  int rank;
  template <class Src_>
  __device__ __forceinline__ int operator()(const Src_& s, int y, int x, int ch) const {
    constexpr int R = S / 2;
    int v[S * S];
#pragma unroll
    for (int dy = 0; dy < S; ++dy) {
      const int line = s.row(y + dy - R);
#pragma unroll
      for (int dx = 0; dx < S; ++dx) v[dy * S + dx] = s.get(line, x + dx - R, ch);
    }
    int acc = 0;
#pragma unroll
    for (int bit = 7; bit >= 0; --bit) {
      const int cand = acc | (1 << bit);  // acc holds only the bits above
      int below = 0;
#pragma unroll
      for (int i = 0; i < S * S; ++i) below += v[i] < cand;
      if (below <= rank) acc = cand;
    }
    return acc;
  }
};

// A registered kernel stage; spec = {scale, off2, taps[S*S]}, the tap rows
// already flipped, row-major. Divides exactly: C++ truncates toward zero,
// so the quotient steps down once for a negative numerator with a
// remainder, which is a floor.
template <int S>
struct Conv {
  int tap[S * S];
  int den;
  int cnum;

  __device__ __forceinline__ explicit Conv(const int* __restrict__ spec) {
    const int scale = __ldg(spec);
    den = 2 * scale;
    cnum = scale * (__ldg(spec + 1) + 1);
#pragma unroll
    for (int i = 0; i < S * S; ++i) tap[i] = __ldg(spec + 2 + i);
  }

  template <class Src_>
  __device__ __forceinline__ int operator()(const Src_& s, int y, int x, int ch) const {
    constexpr int R = S / 2;
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy < S; ++dy) {
      const int line = s.row(y + dy - R);
#pragma unroll
      for (int dx = 0; dx < S; ++dx) acc += tap[dy * S + dx] * s.get(line, x + dx - R, ch);
    }
    const int num = 2 * acc + cnum;
    int q = num / den;
    if (q * den > num) --q;  // floor, for a negative numerator
    return min(max(q, 0), 255);
  }
};

__host__ __device__ inline bool window_ok(int size) {
  return size == 3 || size == 5 || size == 7 || size == 9;
}

}  // namespace
