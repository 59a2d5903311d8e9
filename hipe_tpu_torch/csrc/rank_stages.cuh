// The rank-family and registered-kernel stages that K3
// (rank_chain_planar.cu) and K5 (tiled_stage_planar.cu) share: the 3x3
// median, erode and dilate, the rank-th smallest of a size x size window,
// and a registered convolution kernel. Functors over a Src, as in
// chain_stages.cuh; they compute what hipe_tpu/ops/blur.py computes, to the
// bit.
//
// A size-9 window takes some 90 registers a thread, so a kernel that runs
// these is instantiated for the widest window it holds (K3 per program, K5
// per stage): a 3x3 stage never pays a size-9 selection's registers.

#pragma once

#include "chain_stages.cuh"

namespace {

__device__ __forceinline__ int med3(int a, int b, int c) {
  return max(min(a, b), min(max(a, b), c));
}

// Paeth's 19-op network: sort each row triple to (lo, me, hi); the median
// of all nine is med3(max of the los, med3 of the mes, min of the his).
struct Median3 {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    int v[3][3];
    load3x3(s, y, x, ch, v);
    int lo[3], me[3], hi[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int tl = min(v[r][0], v[r][1]);
      const int th = max(v[r][0], v[r][1]);
      lo[r] = min(tl, v[r][2]);
      me[r] = max(tl, min(th, v[r][2]));
      hi[r] = max(th, v[r][2]);
    }
    return med3(max(max(lo[0], lo[1]), lo[2]), med3(me[0], me[1], me[2]),
                min(min(hi[0], hi[1]), hi[2]));
  }
};

template <bool kMax>
struct Extreme3 {
  template <class S>
  __device__ __forceinline__ int operator()(const S& s, int y, int x, int ch) const {
    int v[3][3];
    load3x3(s, y, x, ch, v);
    int m = v[0][0];
#pragma unroll
    for (int i = 1; i < 9; ++i) m = kMax ? max(m, v[i / 3][i % 3]) : min(m, v[i / 3][i % 3]);
    return m;
  }
};

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
