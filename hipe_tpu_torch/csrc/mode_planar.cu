// K12: PIL ImageFilter.ModeFilter(3 | 5) over planar (N, H, W) uint8 planes,
// one launch a call.
//
// Replaces no pallas_call: hipe_tpu's mode filter (hipe_tpu/ops/equalize.py)
// is XLA ops, and so was the port's until this kernel (ops/equalize.py's
// _mode_core: a pairwise equality sum over an int16 padded copy of the
// planes, 40 offset equalities and 600 uint8 count adds for size 5, in
// chunks of whole images; some 22,700 elementwise launches a pass of the
// 5000-image 320x240 stream). That form stays the plain version for CPU
// tensors, and what this kernel is held against.
//
// The filter (Pillow's ModeFilter.c): for each pixel, the histogram of its
// (2r+1)x(2r+1) window, truncated at the plane's bounds (positions outside
// are not counted); the most frequent value, the lowest on a tie, if it is
// seen more than twice, else the pixel itself.
//
// What bounds it on an H100: its bytes are 2 a pixel, each read once and
// written once (0.69 ms over the 1.152 GB stream at 3.35 TB/s; see
// torch_bench/work/mode5.py), but the counting costs more. A sliding
// histogram updates 2(2r+1) bins a pixel (the values entering and leaving
// the window), and the choice reads the counts of the (2r+1)^2 window
// values: at r = 2 about 180 instructions a pixel, 41 of them through the
// load/store pipe that shared memory and L1 share (5 row reads, 10 count
// updates, 25 count reads, a write). That pipe and issue set the time,
// ~10.5 ms a pass of the stream, not the bytes.
//
// What the design does about it:
// - A thread owns one output column of a strip of rows and walks down it,
//   keeping the histogram of its window in shared memory: 257 uint8 counts
//   (a count is at most 25), bin b in byte b & 3 of word (b >> 2) * 128 +
//   tid. Each lane's bins stay in its own bank, so every access of a warp
//   is conflict-free whatever the values; no thread touches another's
//   bins, so there are no barriers. Bin 256 takes the positions outside
//   the plane, so the updates need no branch; its key is never above 0, so
//   it never wins, and what it counts does not matter.
// - A step removes the 2r+1 values of the row leaving the window and adds
//   those of the row entering it, each one shared atomic on the count's
//   word (a byte load and store would take two trips through the pipe).
//   The window's values stay in registers as they rotate: the walk is
//   unrolled by 2r+1 rows, so a row's slot is a constant. A value is kept
//   as its bin's byte offset and its low key 255 - v, which its add, its
//   remove and its 2r+1 lookups reuse. 5 blocks an SM (96 registers a
//   thread) hold the 2 x 25 of r = 2 without spilling.
// - The choice reads only the counts of the window's values (every other
//   bin is 0) and keeps the max of count * 256 + (255 - v), the key of
//   _mode_core and of torch_bench/reference/mode5.py: the most frequent
//   value, the lowest on a tie. A count above 2 writes its value, else the
//   centre pixel.
// - Threads map over flat (plane, strip, column), so every lane of a warp
//   is live whatever the width. Rows are read coalesced (neighbouring
//   lanes, neighbouring columns; a row's 2r+1 shifted reads hit L1) and
//   written a byte a lane.
// - The strip height comes from the shape: whole planes where the columns
//   of all planes fill the card twice over (15,000 planes of 320x240 give
//   4.8 M threads; a strip starts with a 2r-row warm-up), else the fewest
//   rows, at least kMinStripRows, that do (one 4000x2250 frame: 43 strips
//   of 53 rows).
// - r is a template parameter: 1 for ModeFilter(3), 2 for ModeFilter(5).
//
// Tried and not kept (H100, the benchmark's 15000x240x320 stream, mode5):
// byte loads and stores for the updates, 12.47 ms (14.23 at 6 blocks an
// SM, where registers spill); the entering row's counts from the adds'
// returned words in place of 5 lookups, 10.73; each row's 5 bytes from two
// aligned 32-bit loads, 12.60; the choice kept from the last row unless
// the mode's count fell, 12.0 (a warp diverges as soon as one lane falls).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
// Bins 0-255 and the bin of positions outside the plane (256), 4 a word.
constexpr int kBinWords = 65;
constexpr int kOutsideBin = 256;
// The low key of a position outside the plane: count * 256 + it <= 0 for
// any count a byte holds, and every value in the window keys above 255.
constexpr int kOutsideKey = -65536;
// Blocks an SM holds: 5 of the 6 that its 228 KB of shared memory takes
// at a block's 33,280 B and 1 KB reserved, so a thread has 96 registers
// and holds the window's 2 x 25 values without spilling.
constexpr int kBlocksPerSm = 5;
// The threads the grid aims at, as waves of kBlocksPerSm blocks an SM,
// before it cuts planes into strips; and the least rows of a strip, so a
// strip's 2r-row warm-up stays small beside it.
constexpr long long kWaves = 2;
constexpr long long kMinStripRows = 32;

// The byte offset of bin b in a thread's column of the histogram.
__device__ __forceinline__ int bin_offset(int b) { return (b & ~3) * kThreads + (b & 3); }

// Add `d` (1 or -1) to the count at byte offset `off` of `bins`: one shared
// atomic on its word, in place of a byte load and store (-1 shifted to a
// byte is that byte's -1 modulo 2^32). A count stays in 0-25, so the add
// never carries out of its byte; bin 256's byte may wrap, into bytes that
// hold no bin.
__device__ __forceinline__ void count(uint32_t* bins, int off, int d) {
  atomicAdd(bins + (off >> 2), static_cast<uint32_t>(d) << ((off & 3) * 8));
}

template <int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mode_planar_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   long long columns, int h, int w, int strips, int strip_rows) {
  constexpr int D = 2 * R + 1;
  __shared__ uint32_t bins[kBinWords * kThreads];
  const int t = threadIdx.x;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + t;
  if (g >= columns) return;  // no barrier below: a thread's bins are its own
  const int x = static_cast<int>(g % w);
  const long long unit = g / w;
  const long long plane_off = unit / strips * static_cast<long long>(h) * w;
  const int y0 = static_cast<int>(unit % strips) * strip_rows;
  const int y1 = min(h, y0 + strip_rows);
  const uint8_t* src = in + plane_off;
  uint8_t* dst = out + plane_off + x;

#pragma unroll 5
  for (int k = 0; k < kBinWords; ++k) bins[k * kThreads + t] = 0;
  const uint8_t* counts = reinterpret_cast<const uint8_t*>(bins);
  const int mine = 4 * t;

  // The window's values, a slot of 2r+1 columns a row: the byte offsets of
  // their bins in `bins` and their low keys. At the start every slot holds
  // positions outside.
  int off[D][D], low[D][D];
  bool col_in[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    col_in[s] = x + s - R >= 0 && x + s - R < w;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      off[s][c] = mine + bin_offset(kOutsideBin);
      low[s][c] = kOutsideKey;
    }
  }

  // Row e enters the window of output row e - R and leaves that of e + R + 1,
  // where row e + D enters in its slot.
  for (int base = y0 - R; base < y1 + R; base += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int e = base + s;
      if (e >= y1 + R) break;
      const bool row_in = e >= 0 && e < h;
      const uint8_t* row = src + static_cast<long long>(e) * w + x - R;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        count(bins, off[s][c], -1);  // the value leaving
        if (row_in && col_in[c]) {
          const int v = __ldg(row + c);
          off[s][c] = mine + bin_offset(v);
          low[s][c] = 255 - v;
        } else {
          off[s][c] = mine + bin_offset(kOutsideBin);
          low[s][c] = kOutsideKey;
        }
        count(bins, off[s][c], 1);  // the value entering
      }
      const int y = e - R;
      if (y < y0) continue;
      int best = kOutsideKey;
#pragma unroll
      for (int q = 0; q < D; ++q) {
#pragma unroll
        for (int c = 0; c < D; ++c) best = max(best, counts[off[q][c]] * 256 + low[q][c]);
      }
      // The centre pixel: row y's slot, its middle column.
      const int centre = 255 - low[(s + D - R) % D][R];
      dst[static_cast<long long>(y) * w] =
          static_cast<uint8_t>(best >= 3 * 256 ? 255 - (best & 255) : centre);
    }
  }
}

template <int R>
int launch(const uint8_t* in, uint8_t* out, long long n, int h, int w, cudaStream_t s) {
  // Shared memory for kBlocksPerSm blocks an SM, whatever L1 would take (a
  // host call of microseconds, made a launch: no state to share between the
  // threads that launch).
  const cudaError_t e = cudaFuncSetAttribute(
      mode_planar_kernel<R>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    sms = 1;
  }
  const long long want = kWaves * sms * kBlocksPerSm * kThreads;
  const long long planes_cols = n * w;
  long long strips = 1;
  if (planes_cols < want) {
    const long long most = (h + kMinStripRows - 1) / kMinStripRows;
    strips = (want + planes_cols - 1) / planes_cols;
    if (strips > most) strips = most;
    if (strips < 1) strips = 1;
  }
  const long long strip_rows = (h + strips - 1) / strips;
  strips = (h + strip_rows - 1) / strip_rows;
  const long long columns = planes_cols * strips;
  const long long blocks = (columns + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  mode_planar_kernel<R><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      in, out, columns, h, w, static_cast<int>(strips), static_cast<int>(strip_rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// PIL ModeFilter(size) (size 3 or 5) of each of n planes of h x w uint8 at
// `in`, into `out`, which must not overlap `in`. Launches on `stream`, does
// not synchronize and allocates nothing. Returns the cudaError_t of the
// launch as an int.
extern "C" int hipe_mode_planar_u8(const void* in, void* out, long long n, long long h,
                                   long long w, int size, void* stream) {
  if (n < 1 || h < 1 || w < 1 || h > INT_MAX || w > INT_MAX || (size != 3 && size != 5)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto src = static_cast<const uint8_t*>(in);
  const auto dst = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return size == 3 ? launch<1>(src, dst, n, static_cast<int>(h), static_cast<int>(w), s)
                   : launch<2>(src, dst, n, static_cast<int>(h), static_cast<int>(w), s);
}
