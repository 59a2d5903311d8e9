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
// The stages are the functors K2 and K3 run (chain_stages.cuh,
// rank_stages.cuh). A block owns a TH x TW tile of output pixels; it stages
// the input rows and columns the tile needs that lie in the plane, r more
// on each side (none for a point stage), and the functors clamp every row
// and column they read against the true plane edges, so the halo clamps in
// both axes as the TPU kernel's edge rows do in H. Valid mode is
// clamp-then-trim: output row o is plane row o + out_off.
//
// What bounds it on an H100: device memory for the point and 3x3 stages
// (one stage over 100 RGB frames of 4000x2250 reads and writes 2.7 GB each,
// 1.61 ms at 3.35 TB/s), integer instruction issue for the wide ranks (a
// size-9 rank is ~1.4k instructions a pixel, K3's count).
//
// What the design does about it: each input byte is read once plus the
// halo, each output byte written once, a warp on consecutive bytes of a
// row; the kernel is instantiated per stage kind and window size, so a 3x3
// stage never carries a size-9 window's registers (the TPU kernel's size^2
// live views have no counterpart). The tile shape is the launch knob the
// stream's autotune sweeps. Output goes to a separate buffer.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "chain_stages.cuh"
#include "rank_stages.cuh"

namespace {

constexpr int kThreadsX = 32;  // one warp across a tile row
constexpr int kThreadsY = kThreads / kThreadsX;
constexpr long long kDefaultSharedBytes = 48 * 1024;

// The stage's functor, built in the kernel: a kernel stage loads its taps
// from device memory once a thread.
template <int kOp, int kSize>
__device__ __forceinline__ int apply(int arg, const uint8_t* luts, const int* taps,
                                     const Src<1>& s, int y, int x) {
  if constexpr (kOp == kSharpen) return Sharpen{}(s, y, x, 0);
  if constexpr (kOp == kEdge) return Edge{}(s, y, x, 0);
  if constexpr (kOp == kInvert) return Invert{}(s, y, x, 0);
  if constexpr (kOp == kSolarize) return Solarize{}(s, y, x, 0);
  if constexpr (kOp == kPosterize) return Posterize{arg}(s, y, x, 0);
  if constexpr (kOp == kLut) return Lut{luts + 256 * arg}(s, y, x, 0);
  if constexpr (kOp == kMedian) return Median3{}(s, y, x, 0);
  if constexpr (kOp == kErode) return Extreme3<false>{}(s, y, x, 0);
  if constexpr (kOp == kDilate) return Extreme3<true>{}(s, y, x, 0);
  if constexpr (kOp == kRank) return Rank<kSize>{arg}(s, y, x, 0);
  return 0;
}

// One block per (plane, tile row, tile column), the tile column fastest;
// R is the stage's radius.
template <int kOp, int kSize, int R>
__global__ void __launch_bounds__(kThreads)
    tiled_stage_u8_kernel(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out,
                          const uint8_t* __restrict__ luts,
                          const int* __restrict__ taps, int arg, int h, int w,
                          int ho, int out_off, int th, int tw, int tiles_y,
                          int tiles_x) {
  extern __shared__ uint8_t smem[];
  const int tx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y;
  const int plane = rest / tiles_y;
  const int y0 = ty * th + out_off;  // first plane row of the tile
  const int x0 = tx * tw;
  const int rows = min(th, ho + out_off - y0);
  const int cols = min(tw, w - x0);
  const uint8_t* src = in + static_cast<size_t>(plane) * h * w;
  uint8_t* dst = out + static_cast<size_t>(plane) * ho * w;

  // Stage the plane rows [a0, a1) and columns [b0, b1) that the tile reads.
  const int a0 = max(y0 - R, 0);
  const int a1 = min(y0 + rows + R, h);
  const int b0 = max(x0 - R, 0);
  const int b1 = min(x0 + cols + R, w);
  const int pitch = b1 - b0;
  for (int i = threadIdx.y; i < a1 - a0; i += kThreadsY) {
    const uint8_t* line = src + (a0 + i) * w + b0;
    for (int j = threadIdx.x; j < pitch; j += kThreadsX) smem[i * pitch + j] = line[j];
  }
  __syncthreads();

  const Src<1> s{smem, pitch, h, a0, w, b0, 1};
  if constexpr (kOp == kKernel) {
    const Conv<kSize> conv(taps + arg);
    for (int i = threadIdx.y; i < rows; i += kThreadsY) {
      uint8_t* line = dst + (y0 - out_off + i) * w + x0;
      for (int j = threadIdx.x; j < cols; j += kThreadsX) {
        line[j] = static_cast<uint8_t>(conv(s, y0 + i, x0 + j, 0));
      }
    }
  } else {
    for (int i = threadIdx.y; i < rows; i += kThreadsY) {
      uint8_t* line = dst + (y0 - out_off + i) * w + x0;
      for (int j = threadIdx.x; j < cols; j += kThreadsX) {
        line[j] = static_cast<uint8_t>(
            apply<kOp, kSize>(arg, luts, taps, s, y0 + i, x0 + j));
      }
    }
  }
}

using KernelFn = void (*)(const uint8_t*, uint8_t*, const uint8_t*, const int*, int,
                          int, int, int, int, int, int, int, int);

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
      case 5: return tiled_stage_u8_kernel<kRank, 5, 2>;
      case 7: return tiled_stage_u8_kernel<kRank, 7, 3>;
      case 9: return tiled_stage_u8_kernel<kRank, 9, 4>;
      default: return nullptr;
    }
  }
  if (op == kKernel) {
    switch (size) {
      case 3: return tiled_stage_u8_kernel<kKernel, 3, 1>;
      case 5: return tiled_stage_u8_kernel<kKernel, 5, 2>;
      case 7: return tiled_stage_u8_kernel<kKernel, 7, 3>;
      case 9: return tiled_stage_u8_kernel<kKernel, 9, 4>;
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
// of th x tw output pixels, one block each. Launches on `stream`, does not
// synchronize and allocates nothing. Returns the cudaError_t of the launch
// as an int; what it does not take is refused and leaves no error behind.
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
  const int tiles_y = (ho + th - 1) / th;
  const int tiles_x = (w + tw - 1) / tw;
  const long long blocks = static_cast<long long>(n) * tiles_y * tiles_x;
  const long long smem = static_cast<long long>(th + 2 * r) * (tw + 2 * r);
  if (blocks > INT_MAX || smem > INT_MAX) return invalid;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(kThreadsX, kThreadsY),
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(luts), static_cast<const int*>(taps), arg, h, w, ho,
      out_off, th, tw, tiles_y, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
