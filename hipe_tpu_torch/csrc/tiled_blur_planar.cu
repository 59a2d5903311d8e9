// K4: one exact integer binomial blur stage over 2-D tiles of large planes.
//
// Replaces the Pallas TPU kernel _tiled_blur_kernel
// (hipe_tpu/ops/pallas_blur.py:295), launched through _tiled_call (:439) by
// gaussian_blur_planar_tiled_pallas and by filter_chain_planar_tiled_pallas
// for every gaussian stage of a chain over planes too large for the fused
// kernels (the reference's own 4000x2250 asset). The TPU kernel tiles only
// H, because VMEM holds whole rows: it takes 8-row neighbour blocks as its
// halo and replaces them with edge rows at the true top and bottom. Here a
// block owns a TH x TW tile of output pixels, TW rounded up to a run of 8,
// and stages its padded window (tiled_lanes.cuh): the rows and columns the
// blur reads, clamped into the plane once as they are staged, so the halo
// clamps at the true edges in both axes and shared memory stays bounded
// whatever the width. Then it computes the separable integer sum, column
// sums then row sums, >> 4r: exact by construction.
//
// Valid mode is clamp-then-trim: output row o is plane row o + out_off
// (0 in clamp mode), so a chain's last stage writes rows [R, H - R) of its
// clamp-mode result, R the chain's total radius, which is what hipe_tpu's
// per-stage valid chain computes.
//
// What bounds it on an H100: device memory in principle. One stage over 100
// RGB frames of 4000x2250 reads 2.7 GB and writes 2.7 GB, 1.61 ms at the
// data sheet's 3.35 TB/s, and the frames are 54x the 50 MB L2. In fact
// instruction issue: the first design (a clamp on every staged byte, one
// byte a thread, a uint16 row-sum buffer written to shared memory and read
// back) ran at 3x that.
//
// What the design does about it: the window's pads are the clamp; staging
// moves 16 bytes a thread where the plane allows; each thread computes runs
// of 8 outputs (chain_lanes.cuh's Gaussian<R>: column sums in registers,
// then row sums) and stores each with one 64-bit store; gaussian3 goes two
// pixels a 32-bit word in 16-bit lanes, and its thread walks down its
// column of runs, so each window row is loaded and unpacked once. The tile
// shape (TH, TW) is the launch knob that the stream's autotune sweeps.
// Output goes to a separate buffer: a tile's halo belongs to its
// neighbours, so writing in place would race.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_lanes.cuh"
#include "tiled_lanes.cuh"

namespace {

constexpr long long kDefaultSharedBytes = 48 * 1024;

// One block per (plane, tile row, tile column), the tile column fastest.
// Output row o of a plane is plane row o + out_off; the plane has h rows of
// w pixels and the output ho rows.
template <int R>
__global__ void __launch_bounds__(kThreads)
    tiled_blur_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h,
                         int w, int ho, int out_off, int th, int tw, int tiles_y,
                         int tiles_x, int vec_in, int vec_out) {
  extern __shared__ __align__(16) uint8_t smem16[];
  const tiled::Window t(smem16, R, h, w, ho, out_off, th, tw, tiles_y, tiles_x);
  t.stage_input(in, vec_in != 0);
  __syncthreads();
  if constexpr (R == 1) {
    t.run(lanes::Gaussian3Pairs{}, out, vec_out != 0);
  } else {
    t.run(lanes::Gaussian<R>{}, out, vec_out != 0);
  }
}

template <int R>
int launch(const uint8_t* in, uint8_t* out, int n, int h, int w, int out_off,
           int ho, int th, int tw, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || h < 1 || w < 1 || ho < 1 || out_off < 0 || out_off + ho > h ||
      th < 1 || tw < 1 || static_cast<long long>(h) * w > INT_MAX) {
    return invalid;
  }
  const long long tiles_y = (ho + static_cast<long long>(th) - 1) / th;
  const long long tiles_x = (w + tiled::tile_cols(tw) - 1) / tiled::tile_cols(tw);
  const long long blocks = n * tiles_y * tiles_x;
  const long long smem = tiled::window_bytes(R, th, tw);
  if (blocks > INT_MAX || smem > INT_MAX) return invalid;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        tiled_blur_u8_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  const int vec_in = reinterpret_cast<uintptr_t>(in) % 16 == 0 && w % 16 == 0;
  const int vec_out =
      reinterpret_cast<uintptr_t>(out) % lanes::kRun == 0 && w % lanes::kRun == 0;
  tiled_blur_u8_kernel<R><<<static_cast<unsigned>(blocks), kThreads,
                            static_cast<size_t>(smem), stream>>>(
      in, out, h, w, ho, out_off, th, tw, static_cast<int>(tiles_y),
      static_cast<int>(tiles_x), vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blur n planes of h x w uint8 from `in` into `out`, (n, ho, w): output row
// o is the clamp-mode blur's plane row o + out_off (out_off = 0, ho = h for
// clamp mode; out_off = R, ho = h - 2R to trim a chain of total radius R).
// Tiles of th x tw output pixels, tw rounded up to a multiple of 8, one
// block each. Launches on `stream`, does not synchronize and allocates
// nothing. Returns the cudaError_t of the launch as an int; what it does
// not take (a radius outside 1-4, rows out of range, a tile beyond shared
// memory) is refused and leaves no error behind.
extern "C" int hipe_tiled_blur_planar_u8(const void* in, void* out, int n, int h,
                                         int w, int radius, int out_off, int ho,
                                         int th, int tw, void* stream) {
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(src, dst, n, h, w, out_off, ho, th, tw, s);
    case 2: return launch<2>(src, dst, n, h, w, out_off, ho, th, tw, s);
    case 3: return launch<3>(src, dst, n, h, w, out_off, ho, th, tw, s);
    case 4: return launch<4>(src, dst, n, h, w, out_off, ho, th, tw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
