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
//      kernel's band takes pixel stride C. Here the W pass sums taps at
//      clamp(x + k - r) * C + ch, so the edge clamps a whole pixel; the row
//      sums still fit uint16, and the H pass is unchanged.
// The TPU kernels fold the clamp and the 1/16^r into a bf16 or int8 band
// matrix for the matrix unit. Here the same integers are summed directly:
// out = (sum_ky t[ky] * sum_kx t[kx] * x[clamp(y+ky-r)][clamp(x+kx-r)]) >> 4r,
// t = C(2r, k). No band matrix, no float, exact by construction.
//
// What bounds it on an H100: device memory. One pass over the 5000-image
// 256x256 RGB stream reads 983 MB and writes 983 MB; at the data sheet's
// 3.35 TB/s that is ~0.59 ms a pass. The arithmetic, 2(2r+1) integer
// multiply-adds a pixel, is far below the card's integer rate, and the
// stream is 20x the 50 MB L2, so every pass is cold.
//
// What the design does about it: every input byte comes from device memory
// once (plus 2r halo rows per tile of rows_per_block rows) and every output
// byte goes back once, with consecutive threads on consecutive bytes. The
// W pass reads its 2r+1 taps of a row through L1 and keeps the row sums in
// shared memory as uint16 (at most 255 * 2^2r = 65280 for r <= 4), so the
// H pass takes its taps from shared memory, not device memory. Taller tiles
// cut the halo re-reads (2r / rows_per_block); the runner sweeps
// rows_per_block. Output goes to a separate buffer: a tile's halo rows
// belong to its neighbour's tile, so writing in place would race.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// Binomial taps C(2r, k) for r = 1..4, row r-1. Read at indices fixed at
// compile time by the unrolled tap loops, so each is a constant operand.
__constant__ int kTaps[4][9] = {
    {1, 2, 1},
    {1, 4, 6, 4, 1},
    {1, 6, 15, 20, 15, 6, 1},
    {1, 8, 28, 56, 70, 56, 28, 8, 1},
};

// One block per (plane, tile of rows_per_block output rows). Staged row i
// of the tile is input row clamp(y0 + row_off + i, 0, h - 1): row_off is -R
// in clamp mode and 0 in valid mode, where the clamp never bites. A row is
// w pixels of kC interleaved bytes (1: planar; 0: the runtime c, any).
template <int R, int kC>
__global__ void __launch_bounds__(kThreads)
    blur_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int h, int w, int c, int ho, int row_off,
                   int rows_per_block, int tiles) {
  extern __shared__ uint16_t rowsum[];  // (rows + 2R) x lanes
  const int cs = kC > 0 ? kC : c;
  const int lanes = w * cs;  // bytes a row
  const int plane = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - plane * tiles) * rows_per_block;
  const int rows = min(rows_per_block, ho - y0);
  const uint8_t* src = in + static_cast<size_t>(plane) * h * lanes;
  uint8_t* dst = out + (static_cast<size_t>(plane) * ho + y0) * lanes;

  // W pass: clamp-to-edge along the row, a whole pixel at a time, into
  // uint16 row sums. Row by row, the block's threads across the row: a
  // thread's lane steps by kThreads, so its pixel x and channel ch step by
  // kThreads / cs and kThreads % cs, two divisions a block, none a byte.
  const int dx = kThreads / cs;
  const int dch = kThreads - dx * cs;
  const int x0 = static_cast<int>(threadIdx.x) / cs;
  const int ch0 = static_cast<int>(threadIdx.x) - x0 * cs;
  for (int i = 0; i < rows + 2 * R; ++i) {
    const int y = min(max(y0 + row_off + i, 0), h - 1);
    const uint8_t* line = src + static_cast<size_t>(y) * lanes;
    uint16_t* sums = rowsum + i * lanes;
    int x = x0, ch = ch0;
    for (int lane = threadIdx.x; lane < lanes; lane += kThreads) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k) {
        acc += kTaps[R - 1][k] * line[min(max(x + k - R, 0), w - 1) * cs + ch];
      }
      sums[lane] = static_cast<uint16_t>(acc);
      x += dx;
      ch += dch;
      if (ch >= cs) {
        ch -= cs;
        ++x;
      }
    }
  }
  __syncthreads();

  // H pass over the staged rows, then the 2-D normalization >> 4R.
  const int count = rows * lanes;
  for (int idx = threadIdx.x; idx < count; idx += kThreads) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) acc += kTaps[R - 1][k] * rowsum[idx + k * lanes];
    dst[idx] = static_cast<uint8_t>(acc >> (4 * R));
  }
}

template <int R, int kC>
int launch_kc(const uint8_t* in, uint8_t* out, int n, int h, int w, int c,
              int h_pad, int rows_per_block, cudaStream_t stream) {
  const int ho = h_pad ? h : h - 2 * R;
  if (n < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || rows_per_block < 1 ||
      static_cast<long long>(h) * w * c > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rpb = rows_per_block < ho ? rows_per_block : ho;
  const int tiles = (ho + rpb - 1) / rpb;
  const long long blocks = static_cast<long long>(n) * tiles;
  const long long smem = static_cast<long long>(rpb + 2 * R) * w * c * sizeof(uint16_t);
  if (blocks > INT_MAX || smem > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > static_cast<long long>(kDefaultSharedBytes)) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_u8_kernel<R, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch does not report it
      return static_cast<int>(e);
    }
  }
  blur_u8_kernel<R, kC><<<static_cast<unsigned>(blocks), kThreads,
                          static_cast<size_t>(smem), stream>>>(
      in, out, h, w, c, ho, h_pad ? -R : 0, rpb, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const uint8_t* in, uint8_t* out, int n, int h, int w, int c,
           int h_pad, int rows_per_block, cudaStream_t stream) {
  return c == 1 ? launch_kc<R, 1>(in, out, n, h, w, c, h_pad, rows_per_block, stream)
                : launch_kc<R, 0>(in, out, n, h, w, c, h_pad, rows_per_block, stream);
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
// (n, h - 2r, w) without). Launches on `stream`, does not synchronize and
// allocates nothing. Returns the cudaError_t of the launch as an int.
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
