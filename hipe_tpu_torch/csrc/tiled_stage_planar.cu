// K5: one exact integer stage of any kind but gaussian over 2-D tiles of
// large planes.
//
// Replaces the Pallas TPU kernel _tiled_point_kernel
// (hipe_tpu/ops/pallas_blur.py:319), launched through _tiled_call (:439) by
// filter_chain_planar_tiled_pallas for every non-gaussian stage of a chain
// over planes too large for the fused kernels: sharpen, edge, median,
// erode, dilate, rank stages of size 3-9, registered kernel stages of size
// 3-9, and the point stages (invert, solarize, posterize, LUTs). Gaussian
// stages run K4 (tiled_blur_planar.cu). hipe_tpu sends a size-9 rank stage
// to XLA on this path, because Mosaic's compile of its 81 live window views
// stalls (_tiled_vmem, :412-424); on the card it is one more instantiation.
//
// A block owns a TH x TW tile of output pixels, TW rounded up to a run of 8
// (tiled_lanes.cuh): it stages the tile's padded window, the rows and
// columns the stage reads, clamped into the plane once as it is staged,
// then computes the tile. Valid mode is clamp-then-trim: output row o is
// plane row o + out_off.
//
// What bounds it on an H100: device memory for the point and 3x3 stages in
// principle (one stage over 100 RGB frames of 4000x2250 reads and writes
// 2.7 GB each, 1.61 ms at 3.35 TB/s), instruction issue in fact: the first
// design (one byte a thread, two clamps a tap, a 3x3 neighbourhood
// reloaded for every output byte) ran the chain's sharpen and edge at ~3x
// that. Integer instruction issue bounds the wide ranks (a size-9 rank is
// ~1.4k instructions a pixel, K3's count).
//
// What the design does about it: the window's pads are the clamp, so every
// tap is a plain offset; staging moves 16 bytes a thread where the plane
// allows; each thread computes runs of 8 outputs and stores each with one
// 64-bit store; sharpen, edge and the 3x3 median go two pixels a 32-bit
// word in 16-bit lanes with Hopper's DPX min/max, and for edge and the
// median a thread walks down its column of runs, so each window row is
// loaded and unpacked once, not three times (sharpen, which reads only its
// own columns above and below, goes a run at a time: walking cost it 5%);
// erode and dilate go by column extrema, the point stages and LUTs a word
// at a time (chain_lanes.cuh's forms); the rank and registered-kernel
// stages are rank_stages.cuh's per-pixel functors over the window, as in
// K3, one byte a thread with the threads of a warp on consecutive columns
// (a run a thread put two threads on a bank and cost the 5x5 kernels 35%).
// The kernel is instantiated per stage kind and
// window size, so a 3x3 stage never carries a size-9 window's registers.
// The tile shape is the launch knob the stream's autotune sweeps. Output
// goes to a separate buffer: a tile's halo belongs to its neighbours.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"
#include "rank_stages.cuh"
#include "tiled_lanes.cuh"

namespace {

constexpr long long kDefaultSharedBytes = 48 * 1024;

// One block per (plane, tile row, tile column), the tile column fastest;
// R is the stage's radius. A kernel stage loads its taps from device memory
// once a thread; a LUT is read where it lies, in device memory.
template <int kOp, int kSize, int R>
__device__ __forceinline__ void tiled_stage(const uint8_t* __restrict__ in,
                                            uint8_t* __restrict__ out,
                                            const uint8_t* __restrict__ luts,
                                            const int* __restrict__ taps, int arg, int h, int w,
                                            int ho, int out_off, int th, int tw, int tiles_y,
                                            int tiles_x, int vec_in, int vec_out) {
  extern __shared__ __align__(16) uint8_t smem16[];
  const tiled::Window t(smem16, R, h, w, ho, out_off, th, tw, tiles_y, tiles_x);
  t.stage_input(in, vec_in != 0);
  __syncthreads();
  const bool vec = vec_out != 0;
  if constexpr (kOp == kSharpen) t.run(lanes::Sharpen{}, out, vec);
  if constexpr (kOp == kEdge) t.run(lanes::EdgePairs{}, out, vec);
  if constexpr (kOp == kMedian) t.run(lanes::Median3Pairs{}, out, vec);
  if constexpr (kOp == kErode) t.run(lanes::Extreme3<false>{}, out, vec);
  if constexpr (kOp == kDilate) t.run(lanes::Extreme3<true>{}, out, vec);
  if constexpr (kOp == kInvert) t.run(lanes::Invert{}, out, vec);
  if constexpr (kOp == kSolarize) t.run(lanes::Solarize{}, out, vec);
  if constexpr (kOp == kPosterize) t.run(lanes::Posterize{arg}, out, vec);
  if constexpr (kOp == kLut) t.run(lanes::Lut{luts + 256 * arg}, out, vec);
  if constexpr (kOp == kRank) t.run_pixels(Rank<kSize>{arg}, out);
  if constexpr (kOp == kKernel) t.run_pixels(Conv<kSize>(taps + arg), out);
}

// The 3x3, point and size-3 stages, at the registers ptxas picks for
// 256-thread blocks.
template <int kOp, int kSize, int R>
__global__ void __launch_bounds__(kThreads)
    tiled_stage_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                          const uint8_t* __restrict__ luts, const int* __restrict__ taps,
                          int arg, int h, int w, int ho, int out_off, int th, int tw,
                          int tiles_y, int tiles_x, int vec_in, int vec_out) {
  tiled_stage<kOp, kSize, R>(in, out, luts, taps, arg, h, w, ho, out_off, th, tw, tiles_y,
                             tiles_x, vec_in, vec_out);
}

// The rank and kernel stages of size 5-9, bound by instruction issue: two
// blocks an SM are enough, so ptxas may take up to 128 registers a thread
// for the window and the taps rather than spill to fit a third or fourth.
template <int kOp, int kSize, int R>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_window_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                           const uint8_t* __restrict__ luts, const int* __restrict__ taps,
                           int arg, int h, int w, int ho, int out_off, int th, int tw,
                           int tiles_y, int tiles_x, int vec_in, int vec_out) {
  tiled_stage<kOp, kSize, R>(in, out, luts, taps, arg, h, w, ho, out_off, th, tw, tiles_y,
                             tiles_x, vec_in, vec_out);
}

using KernelFn = void (*)(const uint8_t*, uint8_t*, const uint8_t*, const int*, int, int,
                          int, int, int, int, int, int, int, int, int);

// The instantiation for a stage, and its radius; null for what K5 does not
// take.
KernelFn select(int op, int size, int* radius) {
  *radius = 1;
  switch (op) {
    case kSharpen: return tiled_stage_u8_kernel<kSharpen, 3, 1>;
    case kEdge: return tiled_stage_u8_kernel<kEdge, 3, 1>;
    case kMedian: return tiled_stage_u8_kernel<kMedian, 3, 1>;
    case kErode: return tiled_stage_u8_kernel<kErode, 3, 1>;
    case kDilate: return tiled_stage_u8_kernel<kDilate, 3, 1>;
    default: break;
  }
  *radius = 0;
  switch (op) {
    case kInvert: return tiled_stage_u8_kernel<kInvert, 1, 0>;
    case kSolarize: return tiled_stage_u8_kernel<kSolarize, 1, 0>;
    case kPosterize: return tiled_stage_u8_kernel<kPosterize, 1, 0>;
    case kLut: return tiled_stage_u8_kernel<kLut, 1, 0>;
    default: break;
  }
  *radius = size / 2;
  if (op == kRank) {
    switch (size) {
      case 3: return tiled_stage_u8_kernel<kRank, 3, 1>;
      case 5: return tiled_window_u8_kernel<kRank, 5, 2>;
      case 7: return tiled_window_u8_kernel<kRank, 7, 3>;
      case 9: return tiled_window_u8_kernel<kRank, 9, 4>;
      default: return nullptr;
    }
  }
  if (op == kKernel) {
    switch (size) {
      case 3: return tiled_stage_u8_kernel<kKernel, 3, 1>;
      case 5: return tiled_window_u8_kernel<kKernel, 5, 2>;
      case 7: return tiled_window_u8_kernel<kKernel, 7, 3>;
      case 9: return tiled_window_u8_kernel<kKernel, 9, 4>;
      default: return nullptr;
    }
  }
  return nullptr;
}

bool arg_ok(int op, int arg, int size, int n_luts, int n_taps) {
  switch (op) {
    case kPosterize: return arg >= 0 && arg <= 255;
    case kLut: return arg >= 0 && arg < n_luts;
    case kRank: return arg >= 0 && arg < size * size;
    case kKernel: return arg >= 0 && arg <= n_taps - 2 - size * size;
    default: return true;
  }
}

}  // namespace

// Run one stage (op, arg, size: K3's encoding, chain_stages.cuh's Op; not
// gaussian) over n planes of h x w uint8 from `in` into `out`, (n, ho, w):
// output row o is the clamp-mode stage's plane row o + out_off. `luts`
// holds n_luts tables of 256 bytes and `taps` n_taps int32 kernel-stage
// specs in device memory (either may be null when its count is 0). Tiles
// of th x tw output pixels, tw rounded up to a multiple of 8, one block
// each. Launches on `stream`, does not synchronize and allocates nothing.
// Returns the cudaError_t of the launch as an int; what it does not take
// (an unknown stage, rows out of range, a tile beyond shared memory) is
// refused and leaves no error behind.
extern "C" int hipe_tiled_stage_planar_u8(const void* in, void* out, int n, int h,
                                          int w, int op, int arg, int size,
                                          const void* luts, int n_luts,
                                          const void* taps, int n_taps, int out_off,
                                          int ho, int th, int tw, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  int r = 0;
  const KernelFn kernel = select(op, size, &r);
  if (kernel == nullptr || !arg_ok(op, arg, size, n_luts, n_taps) || n_luts < 0 ||
      (n_luts > 0 && luts == nullptr) || n_taps < 0 || (n_taps > 0 && taps == nullptr) ||
      n < 1 || h < 1 || w < 1 || ho < 1 || out_off < 0 || out_off + ho > h ||
      th < 1 || tw < 1 || static_cast<long long>(h) * w > INT_MAX) {
    return invalid;
  }
  const long long tiles_y = (ho + static_cast<long long>(th) - 1) / th;
  const long long tiles_x = (w + tiled::tile_cols(tw) - 1) / tiled::tile_cols(tw);
  const long long blocks = n * tiles_y * tiles_x;
  const long long smem = tiled::window_bytes(r, th, tw);
  if (blocks > INT_MAX || smem > INT_MAX) return invalid;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  const int vec_in = reinterpret_cast<uintptr_t>(in) % 16 == 0 && w % 16 == 0;
  const int vec_out =
      reinterpret_cast<uintptr_t>(out) % lanes::kRun == 0 && w % lanes::kRun == 0;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), static_cast<const int*>(taps), arg, h, w, ho,
      out_off, th, tw, static_cast<int>(tiles_y), static_cast<int>(tiles_x), vec_in,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}
