// K1: exact integer separable binomial blur over planar uint8 planes.
//
// Replaces these Pallas TPU kernels of hipe_tpu/ops/pallas_blur.py:
//   a. _blur_mxu_kernel (gaussian_blur_planar_pallas, path="mxu"),
//   b. _blur_kernel (gaussian_blur_planar_pallas, path="vpu"),
//   c. _chain_mxu_kernel on a one-stage gaussian chain (_mxu_stage /
//      _mxu_stage_i8, reached through filter_chain_planar_pallas). Every
//      other chain runs K2, chain_planar.cu.
//   a'. _blur_mxu_kernel's rows entry, gaussian_blur_rows_pallas (:566):
//      the same blur over interleaved rows (B, H, W*C) uint8, where the TPU
//      kernel's band takes pixel stride C: a tap steps a whole pixel, C
//      bytes, and the edge clamps a whole pixel.
// The TPU kernels fold the clamp and the 1/16^r into a bf16 or int8 band
// matrix for the matrix unit. Here the same integers are summed directly:
// out = (sum_ky t[ky] * sum_kx t[kx] * x[clamp(y+ky-r)][clamp(x+kx-r)]) >> 4r,
// t = C(2r, k). No band matrix, no float, exact by construction.
//
// What bounds it on an H100: device memory. One pass over the 5000-image
// 256x256 RGB stream reads 983 MB and writes 983 MB, ~0.59 ms at the data
// sheet's 3.35 TB/s; the stream is 20x the 50 MB L2, so every pass is cold.
// The first design (a byte a thread, 2r+1 clamped byte loads an output
// byte, uint16 row sums written to shared memory and read back 2r+1 times,
// ~20 instructions a byte) was bound by instruction issue instead, at 4.8x
// that bound.
//
// What the design does about it: the stream's runs of 8 bytes are taken in
// (plane, run) order, and a warp owns 32 consecutive ones, one a lane, and a
// band of rows_per_block output rows, which it walks down. A warp may so
// hold the end of one plane's row and the start of the next plane's: every
// plane has the same rows, so its lanes still walk in lock-step. A warp
// issues the same instructions whatever its live lanes move, and a row taken
// 32 runs a warp would leave 24 of every second warp's lanes idle at
// 320-byte rows (40 runs); taken in (plane, run) order, only the stream's
// last warp has idle lanes. No shared memory and no __syncthreads: a block
// is eight independent warps. Each input row of the band and its 2r halo
// rows is loaded once, one 64-bit load a lane, 2r+1 rows ahead of use in
// registers. The bytes left and right of a run come from the neighbouring
// lanes' runs by warp shuffles; only a warp's outer lanes load the words
// beside it, and a lane whose run is its row's first or last makes them from
// the run's own edge pixel, wherever it sits in the warp: that is the clamp,
// so no tap carries one, and no shuffle across a plane's edge is ever used.
// Each row is summed across once, in 16-bit lanes, two outputs to a 32-bit
// word (a row sum is at most 255 * 4^r = 65280); the last 2r+1 row sums stay
// in registers and take turns as the rows above, at and below, with no
// moves. gaussian3 and gaussian5 sum down in 16-bit lanes too (at most
// 65280), gaussian7 and gaussian9 in 32-bit lanes. Each run goes out with
// one 64-bit store. The taps are constants of the code, so a tap of 1 costs
// no multiply.
//
// This is the pairs form. It takes rows whose input and output bases and
// length are multiples of 8, with C = 1-4 bytes a pixel (known at compile
// time) and r*C <= 8, so that the taps C bytes apart reach no further than
// one neighbour run: the taps are byte pairs of the window at offsets k*C.
// Every other row (unaligned, r*C > 8, or C known only at run time) takes
// the run form over the same walk: each byte's 2r+1 taps are loaded as
// bytes (L1 hits), each clamped a whole pixel, and stored as bytes. The two
// forms are kernels of their own, so each gets the registers it needs.
// Output goes to a separate buffer: a band's halo rows belong to its
// neighbour's band, so writing in place would race.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"

namespace {

using lanes::kRun;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kAll = 0xFFFFFFFFu;

// Binomial tap C(n, k).
__host__ __device__ constexpr int binom(int n, int k) {
  return k == 0 ? 1 : binom(n, k - 1) * (n - k + 1) / k;
}

// f(Int<I>{}), ..., f(Int<N - 1>{}): a loop whose index is a constant
// expression, so each tap binom(2R, j) is one (a tap of 1 costs no
// multiply); an unrolled loop over a constexpr call left the taps in
// registers.
template <int V>
struct Int {
  static constexpr int value = V;
};
template <int I, int N, class F>
__device__ __forceinline__ void for_each(const F& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    for_each<I + 1, N>(f);
  }
}

// A row sum of a run: output columns (0, 2), (1, 3), (4, 6), (5, 7) of the
// run, two to a word in 16-bit lanes (lanes::pack_pairs's order).
struct RowSum {
  uint32_t p[4];
};

__device__ __forceinline__ uint2 load_run(const uint8_t* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

// One warp's band and one lane's run in it.
struct Band {
  const uint8_t* src;  // the lane's plane's input row 0
  uint8_t* dst;        // its output row 0
  int h;
  int len;      // bytes a row: w * C
  int cs;       // C
  int first;    // input row of the band's first window row: y0 + row_off
  int y0;       // first output row
  int rows;     // output rows of the band
  int x;        // first byte of the lane's run
  int keep;     // bytes of the run inside the row (>= 1)
  bool active;  // the lane holds a run: it is not past the stream's last
  bool left;    // lane 0 or the row's first run: no lane holds the run left of it
  bool right;   // lane 31 or the row's last run: nor the one right of it

  // Input row of window row i (0 .. rows + 2R), clamped into the plane; a
  // plane's offsets fit an int.
  __device__ __forceinline__ const uint8_t* line(int i) const {
    return src + min(max(first + i, 0), h - 1) * len;
  }

  // Output row i of the band: one 64-bit store with kVec, else the bytes
  // inside the row.
  template <bool kVec>
  __device__ __forceinline__ void put(int i, const lanes::Run& r) const {
    if (!active) return;
    uint8_t* q = dst + ((y0 + i) * len + x);
    if constexpr (kVec) {
      *reinterpret_cast<lanes::Run*>(q) = r;
      return;
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < keep) q[k] = static_cast<uint8_t>(r.w[k >> 2] >> (8 * (k & 3)));
    }
  }
};

// The pairs form, for rows whose input and output bases and length are
// multiples of 8: a row's run and its neighbour runs, r*C <= 8 bytes a side
// read through kSide words of each neighbour. Every load is one aligned
// load: a run, and at a warp's ends the neighbour words, which at a row's
// first and last run are made from the run's own edge pixel instead; and
// every store is one.
template <int R, int kC>
struct PairsForm {
  static constexpr bool kVec = true;
  static constexpr int kSide = (R * kC + 3) / 4;  // 1 or 2
  static_assert(kC > 0 && kC <= 4 && R * kC <= kRun, "the taps reach past one neighbour run");

  struct Raw {
    uint2 own;
    uint32_t lft[kSide];  // the left neighbour run's last kSide words
    uint32_t rgt[kSide];  // the right neighbour run's first kSide words
  };

  const Band& b;
  bool load_left;   // a left neighbour to load: lane 0, not at the row's start
  bool load_right;  // a right one: lane 31, not at the row's end

  __device__ __forceinline__ explicit PairsForm(const Band& band)
      : b(band),
        load_left(band.left && band.x > 0),
        load_right(band.right && band.x + kRun < band.len) {}

  __device__ __forceinline__ void load(int i, Raw& r) const {
    const uint8_t* line = b.line(i);
    r.own = load_run(line + b.x);
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
      if (load_left) r.lft[k] = __ldg(reinterpret_cast<const uint32_t*>(line + b.x) - kSide + k);
      if (load_right) r.rgt[k] = __ldg(reinterpret_cast<const uint32_t*>(line + b.x + kRun) + k);
    }
  }

  // Word k of the kSide words before the row's first run (bytes q = 4 (k -
  // kSide) .. + 3): byte q is the first pixel's channel q mod C, a byte of
  // the run's first word.
  __device__ __forceinline__ static uint32_t before_row(uint32_t first, int k) {
    uint32_t sel = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = 4 * (k - kSide) + m;
      sel |= static_cast<uint32_t>((q % kC + kC) % kC) << (4 * m);
    }
    return __byte_perm(first, 0, sel);
  }

  // Word k of those after the row's last run (bytes 8 + 4k .. + 3): the last
  // pixel's channel (q - 8) mod C, a byte of the run's second word.
  __device__ __forceinline__ static uint32_t after_row(uint32_t second, int k) {
    uint32_t sel = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      sel |= static_cast<uint32_t>(4 - kC + (4 * k + m) % kC) << (4 * m);
    }
    return __byte_perm(second, 0, sel);
  }

  // Window byte q (-4 kSide .. 8 + 4 kSide) and q + 2, as a pair of 16-bit
  // lanes; q is a constant once the loops are unrolled.
  __device__ __forceinline__ static uint32_t pair(const uint32_t wd[], int q) {
    const int a = (q + 4 * kSide) >> 2;
    switch ((q + 4 * kSide) & 3) {
      case 0: return __byte_perm(wd[a], 0, 0x4240);
      case 1: return __byte_perm(wd[a], 0, 0x4341);
      case 2: return __byte_perm(__byte_perm(wd[a], 0, 0x4240), __byte_perm(wd[a + 1], 0, 0x4240),
                                 0x5432);
      default: return __byte_perm(__byte_perm(wd[a], 0, 0x4341),
                                  __byte_perm(wd[a + 1], 0, 0x4341), 0x5432);
    }
  }

  // The row sum across: the neighbours' edge words by shuffle, or at a
  // warp's or a row's ends from the lane's own loads or its edge pixel;
  // output pair k (columns o, o + 2) sums the pairs at o + j*C, j = -R .. R.
  __device__ __forceinline__ RowSum sum(const Raw& r) const {
    const uint32_t own[2] = {r.own.x, r.own.y};
    uint32_t wd[2 * kSide + 2];
    wd[kSide] = own[0];
    wd[kSide + 1] = own[1];
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
      const uint32_t up = __shfl_up_sync(kAll, own[2 - kSide + k], 1);
      const uint32_t down = __shfl_down_sync(kAll, own[k], 1);
      wd[k] = load_left ? r.lft[k] : b.left ? before_row(own[0], k) : up;
      wd[kSide + 2 + k] = load_right ? r.rgt[k] : b.right ? after_row(own[1], k) : down;
    }
    RowSum s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = (k & 1) + 4 * (k >> 1);
      uint32_t acc = 0;
      for_each<0, 2 * R + 1>([&](auto j) {
        constexpr int kJ = decltype(j)::value;
        acc += binom(2 * R, kJ) * pair(wd, o + (kJ - R) * kC);
      });
      s.p[k] = acc;
    }
    return s;
  }
};

// The run form, for every other row: each output byte's 2r+1 taps loaded
// as bytes, each pixel clamped into the row; C at compile time (kC > 0) or
// at run time. The taps' loop stays rolled, so a row's loads do not all
// take registers.
template <int R, int kC>
struct RunForm {
  static constexpr bool kVec = false;
  struct Raw {
    int i;  // the window row
  };

  const Band& b;
  int px[kRun];  // pixel column of each byte of the run
  int ch[kRun];  // its channel
  int w;

  __device__ __forceinline__ explicit RunForm(const Band& band) : b(band) {
    w = b.len / b.cs;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      px[k] = (b.x + k) / b.cs;
      ch[k] = b.x + k - px[k] * b.cs;
    }
  }

  __device__ __forceinline__ void load(int i, Raw& r) const { r.i = i; }

  __device__ __forceinline__ RowSum sum(const Raw& r) const {
    const uint8_t* line = b.line(r.i);
    uint32_t v[kRun] = {};
#pragma unroll 1
    for (int j = 0; j <= 2 * R; ++j) {
      const uint32_t t = kTaps[R - 1][j];
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        v[k] += t * __ldg(line + min(max(px[k] + j - R, 0), w - 1) * b.cs + ch[k]);
      }
    }
    RowSum s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = (k & 1) + 4 * (k >> 1);
      s.p[k] = v[o] | v[o + 2] << 16;
    }
    return s;
  }
};

// The sum down over row sums s[(q + j) % N], j = 0 .. 2R, then >> 4R: in
// 16-bit lanes up to R = 2 (at most 255 * 4^2R = 65280), else in 32-bit
// lanes. A lane's low byte after the shift takes no bit of the other lane.
template <int R>
__device__ __forceinline__ lanes::Run sum_down(const RowSum s[], int q) {
  constexpr int N = 2 * R + 1;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (R <= 2) {
      uint32_t acc = 0;
      for_each<0, N>([&](auto j) {
        constexpr int kJ = decltype(j)::value;
        acc += binom(2 * R, kJ) * s[(q + kJ) % N].p[k];
      });
      o[k] = acc >> (4 * R);
    } else {
      uint32_t lo = 0, hi = 0;
      for_each<0, N>([&](auto j) {
        constexpr int kJ = decltype(j)::value;
        lo += binom(2 * R, kJ) * (s[(q + kJ) % N].p[k] & 0xFFFFu);
        hi += binom(2 * R, kJ) * (s[(q + kJ) % N].p[k] >> 16);
      });
      o[k] = lo >> (4 * R) | (hi >> (4 * R)) << 16;
    }
  }
  return lanes::pack_pairs(o);
}

// Walk the band: window row i is loaded into slot i % N, N = 2R + 1, N rows
// before its row sum is taken into slot i % N of the row sums; output row
// p reads the row sums of window rows p .. p + 2R. The loop is unrolled N
// times, so every slot is a constant: no register moves, no local memory.
template <int R, class Form>
__device__ __forceinline__ void walk(const Form& f, const Band& b) {
  constexpr int N = 2 * R + 1;
  const int nin = b.rows + 2 * R;
  typename Form::Raw raw[N] = {};
  RowSum s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < nin) f.load(i, raw[i]);
  }
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) {
    s[i] = f.sum(raw[i]);
    if (i + N < nin) f.load(i + N, raw[i]);
  }
  for (int p0 = 0;; p0 += N) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int p = p0 + q;
      if (p >= b.rows) return;
      const int slot = (q + 2 * R) % N;  // of window row p + 2R
      s[slot] = f.sum(raw[slot]);
      if (p + 2 * R + N < nin) f.load(p + 2 * R + N, raw[slot]);
      b.template put<Form::kVec>(p, sum_down<R>(s, q));
    }
  }
}

// Whether the pairs form takes rows of kC bytes a pixel at radius R.
template <int R, int kC>
constexpr bool kHasPairs = kC > 0 && kC <= 4 && R * kC <= kRun;

// Group g holds runs 32g .. 32g + 31 of the n planes' runs in (plane, run)
// order, a run a lane; lanes past the stream's last run hold none. Warp unit
// = blockIdx.x * 8 + warp of the block over (chunk of segs groups, band of
// rows_per_block output rows, group of the chunk), the group fastest, segs =
// ceil(runs a row / 32): the warps of a band take about a plane's row side
// by side, and the next band's follow. Where a row's runs are a multiple of
// 32, a chunk is a plane and a group a segment of its row. Units past the
// stream's last group (the last chunk's padding) return. Output row o of a
// plane reads input rows o + row_off .. o + row_off + 2R, each clamped into
// the plane: row_off is -R in clamp mode and 0 in valid mode, where the
// clamp never bites. A row is w pixels of kC interleaved bytes (1: planar;
// 0: the runtime c, any). The pairs form (kPairs) and the run form are
// kernels of their own, so each gets the registers it needs.
template <int R, int kC, bool kPairs>
__global__ void __launch_bounds__(kThreads, 1)
    blur_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                   int c, int ho, int row_off, int rows_per_block, int tiles, int segs,
                   int n, int units) {
  const int unit = static_cast<int>(blockIdx.x) * kWarpsPerBlock +
                   static_cast<int>(threadIdx.x) / kWarp;
  if (unit >= units) return;  // the whole warp
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int band = unit / segs % tiles;
  const int group = unit / segs / tiles * segs + unit % segs;  // <= unit
  Band b;
  b.cs = kC > 0 ? kC : c;
  b.len = w * b.cs;
  b.h = h;
  b.y0 = band * rows_per_block;
  b.rows = min(rows_per_block, ho - b.y0);
  b.first = b.y0 + row_off;
  // The lane's run of the stream; a lane past its end takes the last run's
  // place (valid loads, no store). The division is 32-bit where the runs'
  // count allows.
  const int runs = (b.len + kRun - 1) / kRun;
  const long long total = static_cast<long long>(n) * runs;
  const long long first = static_cast<long long>(group) * kWarp;
  if (first >= total) return;  // the whole warp
  const long long f = first + lane;
  b.active = f < total;
  const long long g = min(f, total - 1);
  const int plane = total <= INT_MAX ? static_cast<int>(g) / runs : static_cast<int>(g / runs);
  const int run = static_cast<int>(g - static_cast<long long>(plane) * runs);
  b.src = in + static_cast<size_t>(plane) * h * b.len;
  b.dst = out + static_cast<size_t>(plane) * ho * b.len;
  b.x = kRun * run;
  b.keep = b.len - b.x;
  b.left = lane == 0 || run == 0;
  b.right = lane == kWarp - 1 || run == runs - 1;
  if constexpr (kPairs) {
    walk<R>(PairsForm<R, kC>(b), b);
  } else {
    walk<R>(RunForm<R, kC>(b), b);
  }
}

template <int R, int kC>
int launch_kc(const uint8_t* in, uint8_t* out, int n, int h, int w, int c, int h_pad,
              int rows_per_block, cudaStream_t stream) {
  const int ho = h_pad ? h : h - 2 * R;
  if (n < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || rows_per_block < 1 ||
      static_cast<long long>(h) * w * c > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long len = static_cast<long long>(w) * c;
  const int rpb = rows_per_block < ho ? rows_per_block : ho;
  const int tiles = (ho + rpb - 1) / rpb;
  const long long runs = (len + kRun - 1) / kRun;
  const long long segs = (runs + kWarp - 1) / kWarp;
  const long long groups = (n * runs + kWarp - 1) / kWarp;
  const long long units = (groups + segs - 1) / segs * segs * tiles;
  if (units > INT_MAX - kWarpsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((units + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % kRun == 0 &&
                       reinterpret_cast<uintptr_t>(out) % kRun == 0 && len % kRun == 0;
  const int row_off = h_pad ? -R : 0;
  if constexpr (kHasPairs<R, kC>) {
    if (aligned) {
      blur_u8_kernel<R, kC, true><<<blocks, kThreads, 0, stream>>>(
          in, out, h, w, c, ho, row_off, rpb, tiles, static_cast<int>(segs), n,
          static_cast<int>(units));
      return static_cast<int>(cudaGetLastError());
    }
  }
  blur_u8_kernel<R, kC, false><<<blocks, kThreads, 0, stream>>>(
      in, out, h, w, c, ho, row_off, rpb, tiles, static_cast<int>(segs), n,
      static_cast<int>(units));
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const uint8_t* in, uint8_t* out, int n, int h, int w, int c, int h_pad,
           int rows_per_block, cudaStream_t stream) {
  switch (c) {
    case 1: return launch_kc<R, 1>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
    case 2: return launch_kc<R, 2>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
    case 3: return launch_kc<R, 3>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
    case 4: return launch_kc<R, 4>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
    default: return launch_kc<R, 0>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
  }
}

int dispatch(const void* in, void* out, int n, int h, int w, int c, int radius,
             int h_pad, int rows_per_block, void* stream) {
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(src, dst, n, h, w, c, h_pad, rows_per_block, s);
    case 2: return launch<2>(src, dst, n, h, w, c, h_pad, rows_per_block, s);
    case 3: return launch<3>(src, dst, n, h, w, c, h_pad, rows_per_block, s);
    case 4: return launch<4>(src, dst, n, h, w, c, h_pad, rows_per_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Blur n planes of h x w uint8 from `in` into `out` ((n, h, w) with h_pad,
// (n, h - 2r, w) without), in bands of rows_per_block output rows a warp.
// Launches on `stream`, does not synchronize and allocates nothing. Returns
// the cudaError_t of the launch as an int.
extern "C" int hipe_blur_planar_u8(const void* in, void* out, int n, int h,
                                   int w, int radius, int h_pad,
                                   int rows_per_block, void* stream) {
  return dispatch(in, out, n, h, w, 1, radius, h_pad, rows_per_block, stream);
}

// The same over n images of interleaved rows, (n, h, w * c) uint8 with c
// channels a pixel ((n, h - 2r, w * c) without h_pad).
extern "C" int hipe_blur_rows_u8(const void* in, void* out, int n, int h, int w,
                                 int c, int radius, int h_pad, int rows_per_block,
                                 void* stream) {
  return dispatch(in, out, n, h, w, c, radius, h_pad, rows_per_block, stream);
}

// The CUDA runtime's message for a code returned above.
extern "C" const char* hipe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
