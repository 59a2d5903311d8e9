// K4: one exact integer binomial blur stage over 2-D tiles of large planes.
//
// Replaces the Pallas TPU kernel _tiled_blur_kernel
// (hipe_tpu/ops/pallas_blur.py:295), launched through _tiled_call (:439) by
// gaussian_blur_planar_tiled_pallas and by filter_chain_planar_tiled_pallas
// for every gaussian stage of a chain over planes too large for the fused
// kernels (the reference's own 4000x2250 asset). The TPU kernel tiles only
// H, because VMEM holds whole rows: it takes 8-row neighbour blocks as its
// halo and replaces them with edge rows at the true top and bottom. Here a
// block owns a TH x TW tile of output pixels and stages the (TH + 2r) x
// (TW + 2r) input bytes around it, each row and column clamped into the
// plane, so the halo clamps at the true edges in both axes and shared
// memory stays bounded whatever the width. Then it runs K1's separable
// integer sum (blur_planar.cu): the W pass into uint16 row sums (at most
// 255 * 2^2r = 65280), the H pass, >> 4r. Exact by construction.
//
// Valid mode is clamp-then-trim: output row o is plane row o + out_off
// (0 in clamp mode), so a chain's last stage writes rows [R, H - R) of its
// clamp-mode result, R the chain's total radius, which is what hipe_tpu's
// per-stage valid chain computes.
//
// What bounds it on an H100: device memory. One stage over 100 RGB frames
// of 4000x2250 reads 2.7 GB and writes 2.7 GB, 1.61 ms at the data sheet's
// 3.35 TB/s; the 2(2r+1) integer multiply-adds a pixel are far below the
// card's integer rate, and the frames are 54x the 50 MB L2.
//
// What the design does about it: each input byte is read from device memory
// once, plus the halo (2r/TH + 2r/TW of it), and each output byte written
// once; the threads of a warp take consecutive bytes of a row, so every
// load and store is coalesced. The tile shape (TH, TW) is the launch knob
// that the stream's autotune sweeps. Output goes to a separate buffer: a
// tile's halo belongs to its neighbours, so writing in place would race.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreadsX = 32;  // one warp across a tile row
constexpr int kThreadsY = 8;
constexpr long long kDefaultSharedBytes = 48 * 1024;

// Binomial taps C(2r, k) for r = 1..4, row r-1.
__constant__ int kTaps[4][9] = {
    {1, 2, 1},
    {1, 4, 6, 4, 1},
    {1, 6, 15, 20, 15, 6, 1},
    {1, 8, 28, 56, 70, 56, 28, 8, 1},
};

// Shared bytes of one block: the staged input, then the row sums (2-byte
// aligned).
long long shared_bytes(int r, int th, int tw) {
  const long long staged = static_cast<long long>(th + 2 * r) * (tw + 2 * r);
  return (staged + 1) / 2 * 2 + 2LL * (th + 2 * r) * tw;
}

// One block per (plane, tile row, tile column), the tile column fastest.
// Output row o of a plane is plane row o + out_off; the plane has h rows of
// w pixels and the output ho rows.
template <int R>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    tiled_blur_u8_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int h, int w, int ho,
                         int out_off, int th, int tw, int tiles_y, int tiles_x) {
  extern __shared__ uint8_t smem[];
  const int sw = tw + 2 * R;  // staged row length
  uint8_t* tile = smem;
  uint16_t* rowsum = reinterpret_cast<uint16_t*>(
      smem + (static_cast<long long>(th + 2 * R) * sw + 1) / 2 * 2);
  const int tx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y;
  const int plane = rest / tiles_y;
  const int oy0 = ty * th;
  const int x0 = tx * tw;
  const int rows = min(th, ho - oy0);
  const int cols = min(tw, w - x0);
  const uint8_t* src = in + static_cast<size_t>(plane) * h * w;
  uint8_t* dst = out + static_cast<size_t>(plane) * ho * w;
  const int y_first = oy0 + out_off - R;  // plane row of staged row 0

  // Stage the tile and its halo, every row and column clamped into the plane.
  for (int i = threadIdx.y; i < rows + 2 * R; i += kThreadsY) {
    const uint8_t* line = src + min(max(y_first + i, 0), h - 1) * w;
    for (int j = threadIdx.x; j < cols + 2 * R; j += kThreadsX) {
      tile[i * sw + j] = line[min(max(x0 - R + j, 0), w - 1)];
    }
  }
  __syncthreads();

  // W pass into uint16 row sums.
  for (int i = threadIdx.y; i < rows + 2 * R; i += kThreadsY) {
    const uint8_t* line = tile + i * sw;
    for (int j = threadIdx.x; j < cols; j += kThreadsX) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k) acc += kTaps[R - 1][k] * line[j + k];
      rowsum[i * tw + j] = static_cast<uint16_t>(acc);
    }
  }
  __syncthreads();

  // H pass, then the 2-D normalization >> 4R.
  for (int i = threadIdx.y; i < rows; i += kThreadsY) {
    uint8_t* line = dst + (oy0 + i) * w + x0;
    for (int j = threadIdx.x; j < cols; j += kThreadsX) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k) acc += kTaps[R - 1][k] * rowsum[(i + k) * tw + j];
      line[j] = static_cast<uint8_t>(acc >> (4 * R));
    }
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
  const int tiles_y = (ho + th - 1) / th;
  const int tiles_x = (w + tw - 1) / tw;
  const long long blocks = static_cast<long long>(n) * tiles_y * tiles_x;
  const long long smem = shared_bytes(R, th, tw);
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
  tiled_blur_u8_kernel<R><<<static_cast<unsigned>(blocks), dim3(kThreadsX, kThreadsY),
                            static_cast<size_t>(smem), stream>>>(
      in, out, h, w, ho, out_off, th, tw, tiles_y, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blur n planes of h x w uint8 from `in` into `out`, (n, ho, w): output row
// o is the clamp-mode blur's plane row o + out_off (out_off = 0, ho = h for
// clamp mode; out_off = R, ho = h - 2R to trim a chain of total radius R).
// Tiles of th x tw output pixels, one block each. Launches on `stream`, does
// not synchronize and allocates nothing. Returns the cudaError_t of the
// launch as an int; what it does not take (a radius outside 1-4, rows out of
// range, a tile beyond shared memory) is refused and leaves no error behind.
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
