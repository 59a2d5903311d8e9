// K11: the device JPEG decode's upsample + colour convert, from the three
// uint8 sample grids K6 writes straight to interleaved RGB rows.
//
// Replaces no Pallas TPU kernel: hipe_tpu does this step in XLA ops
// (hipe_tpu/ops/jpeg_decode.py: fancy_upsample_h2v2, ycc_to_rgb and
// _decode_rgb_rows_from_planes, over phase grids that suit the TPU's
// lanes). It was added because the port's torch version of the step (many
// passes over int16 and int32 temporaries, in chunks) took 61% of the
// codec's transcode pass. It computes, bit for bit:
//   - jdsample.c's h2v2_fancy_upsample of each chroma plane, cropped to its
//     downsampled dims (dh, dw): the column sum 3 * near + far over chroma
//     rows clamped to 0..dh-1, then (3 * cs + left + 8) >> 4 for an even
//     output column and (3 * cs + right + 7) >> 4 for an odd one, columns
//     clamped to 0..dw-1; or, where the chroma is at the output's
//     resolution, the plane as it is;
//   - jdcolor.c's ycc_rgb_convert: the int32 products, the arithmetic >> 16
//     and the range limit, which is a clamp to 0..255 here;
//   - the crop to (out_h, out_w), every grid read through its padded pitch.
// The wrapper (ops/cuda_dct.py:ycc_rows_cuda) is called only where both
// chroma planes have ratio (2, 2) with jdsample.c's narrow-plane guard not
// in force, or (1, 1); every other geometry keeps the torch path.
//
// What bounds it on an H100: device memory. An image of 320x240 4:2:0 reads
// 76,800 B of luma and 2 x 19,200 B of chroma and writes 230,400 B of rows:
// the codec cell's 5000 images move 1,728,000,000 B, 0.516 ms at the data
// sheet's 3.35 TB/s. Its 22 int32 operations a pixel take about half that
// at the CUDA cores' rate, so the issue of instructions must stay lean too.
//
// What the design does about it (the aligned form). A unit is a run of 16
// output pixels in a pair of output rows 2i, 2i+1, which share chroma row i;
// the units are taken in (image, row pair, run) order, one a lane, so at
// 320-pixel rows (20 runs) a warp spans row pairs and images and only the
// last warp has idle lanes. A unit reads its 2 x 16 luma bytes with two
// 16-byte loads and each chroma plane's 8 bytes of rows i-1, i, i+1 with
// 8-byte loads; the column beside the run on each side is a byte load, an
// L1 hit, as the neighbouring lanes loaded it. Every sample is read from
// device memory once; the three chroma rows a unit reads are the L2's. The
// 96 output bytes of a unit go through the warp's shared memory, so that
// each store instruction writes 512 contiguous bytes of rows (32 lanes, 16
// bytes each), not 16 bytes 48 bytes apart; the lane that stores a chunk
// takes the owning unit's row offset by a warp shuffle. The clamp is
// Hopper's DPX max(min(v, 255), 0) in one instruction.
//
// The aligned form takes out_w a multiple of 16 and grids whose pitches
// and bases allow its loads (luma 16 bytes; chroma 8 bytes upsampled, 16
// at the output's resolution). Anything else (odd sizes such as 33x41, the
// scaled decodes' narrow grids) takes the any form: a warp an output row,
// a pixel a lane, each sample a byte load, each output byte a byte store.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kRun = 16;  // output pixels a unit's row

// jdcolor.c (SCALEBITS = 16): FIX(1.40200), FIX(1.77200), FIX(0.71414),
// FIX(0.34414), with the -128 of each chroma sample folded into the bias.
constexpr int kScaleBits = 16;
constexpr int kOneHalf = 1 << (kScaleBits - 1);
constexpr int kFixCrR = 91881;
constexpr int kFixCbB = 116130;
constexpr int kFixCrG = 46802;
constexpr int kFixCbG = 22554;
constexpr int kBiasR = kOneHalf - 128 * kFixCrR;
constexpr int kBiasB = kOneHalf - 128 * kFixCbB;
constexpr int kBiasG = kOneHalf + 128 * kFixCbG + 128 * kFixCrG;

struct Plane {
  const uint8_t* data;
  long long image;  // bytes an image: the grid's rows times its pitch
  int pitch;        // bytes a row of the padded grid
};

struct Planes {
  Plane y, cb, cr;
};

__device__ __forceinline__ uint32_t clamp255(int v) {
  return static_cast<uint32_t>(__vimin_s32_relu(v, 255));  // max(min(v, 255), 0)
}

// ycc_rgb_convert of one pixel: (R, G, B) into px[0..2].
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, uint32_t* px) {
  px[0] = clamp255(y + ((kFixCrR * cr + kBiasR) >> kScaleBits));
  px[1] = clamp255(y + ((kBiasG - kFixCbG * cb - kFixCrG * cr) >> kScaleBits));
  px[2] = clamp255(y + ((kFixCbB * cb + kBiasB) >> kScaleBits));
}

// Byte n of a 16-byte vector, as an int (n known at compile time).
__device__ __forceinline__ int byte_of(const uint4& v, int n) {
  const uint32_t w = n < 4 ? v.x : n < 8 ? v.y : n < 12 ? v.z : v.w;
  return static_cast<int>(__byte_perm(w, 0u, 0x4440u | (n & 3)));
}

__device__ __forceinline__ int byte_of(const uint2& v, int n) {
  return static_cast<int>(__byte_perm(n < 4 ? v.x : v.y, 0u, 0x4440u | (n & 3)));
}

// A run of 16 pixels of one output row -> its 48 RGB bytes as 3 vectors.
__device__ __forceinline__ void rgb_run(const uint4& y, const int* cb, const int* cr,
                                        uint4* out) {
  uint32_t px[3 * kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) ycc_rgb(byte_of(y, p), cb[p], cr[p], px + 3 * p);
  uint32_t w[3 * kRun / 4];
#pragma unroll
  for (int k = 0; k < 3 * kRun / 4; ++k) {
    w[k] = __byte_perm(__byte_perm(px[4 * k], px[4 * k + 1], 0x0040u),
                       __byte_perm(px[4 * k + 2], px[4 * k + 3], 0x0040u), 0x5410u);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// h2v2_fancy_upsample of chroma columns j0 .. j0+7 (all below dw) of row i
// of image b: the 16 output samples of rows 2i (top) and 2i+1 (bottom).
__device__ __forceinline__ void fancy_run(const Plane& p, long long b, int i, int j0, int dh,
                                          int dw, int* top, int* bot) {
  const uint8_t* img = p.data + b * p.image;
  const uint8_t* near = img + static_cast<long long>(i) * p.pitch;
  const uint8_t* up = img + static_cast<long long>(i > 0 ? i - 1 : 0) * p.pitch;
  const uint8_t* down = img + static_cast<long long>(i + 1 < dh ? i + 1 : dh - 1) * p.pitch;
  const uint2 n = __ldg(reinterpret_cast<const uint2*>(near + j0));
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(up + j0));
  const uint2 d = __ldg(reinterpret_cast<const uint2*>(down + j0));
  const int jl = j0 > 0 ? j0 - 1 : 0;
  const int jr = j0 + 8 < dw ? j0 + 8 : dw - 1;
  // Column sums 3 * near + far of columns j0-1 .. j0+8 (clamped), rows
  // 2i (far = the row above) and 2i+1 (far = the row below).
  int ct[10], cb[10];
  ct[0] = 3 * __ldg(near + jl) + __ldg(up + jl);
  cb[0] = 3 * __ldg(near + jl) + __ldg(down + jl);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int x = byte_of(n, m);
    ct[m + 1] = 3 * x + byte_of(u, m);
    cb[m + 1] = 3 * x + byte_of(d, m);
  }
  ct[9] = 3 * __ldg(near + jr) + __ldg(up + jr);
  cb[9] = 3 * __ldg(near + jr) + __ldg(down + jr);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    top[2 * t] = (3 * ct[t + 1] + ct[t] + 8) >> 4;
    top[2 * t + 1] = (3 * ct[t + 1] + ct[t + 2] + 7) >> 4;
    bot[2 * t] = (3 * cb[t + 1] + cb[t] + 8) >> 4;
    bot[2 * t + 1] = (3 * cb[t + 1] + cb[t + 2] + 7) >> 4;
  }
}

// Output row r's 16 samples from column c0 of a plane at the output's
// resolution.
__device__ __forceinline__ void plain_run(const Plane& p, long long b, int r, int c0, int* s) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(
      p.data + b * p.image + static_cast<long long>(r) * p.pitch + c0));
#pragma unroll
  for (int k = 0; k < kRun; ++k) s[k] = byte_of(v, k);
}

// The aligned form. Unit u = (b * pairs + i) * runs + k: output rows 2i and
// 2i+1 (if below out_h) of image b, pixels 16k .. 16k+15.
template <bool kFancy>
__global__ void __launch_bounds__(kThreads)
    ycc_rows_vec_kernel(const Planes pl, uint8_t* __restrict__ out, int units, int runs,
                        int pairs, int out_h, int dh, int dw, int out_pitch) {
  // Each warp's two rows of 32 units, 48 bytes a unit, staged for the stores.
  __shared__ uint4 stage[kWarpsPerBlock][2][3 * kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  uint4(*st)[3 * kWarp] = stage[threadIdx.x / kWarp];
  const int u = blockIdx.x * kThreads + threadIdx.x;
  // The unit's top-row offset in `out` (a multiple of 16), plus 1 if it has
  // a bottom row; -1 for a lane past the last unit.
  long long dst = -1;
  if (u < units) {
    const int k = u % runs;
    const int pair = u / runs;
    const long long b = pair / pairs;
    const int i = pair - static_cast<int>(b) * pairs;
    const int r0 = 2 * i;
    const bool two = r0 + 1 < out_h;
    const int r1 = two ? r0 + 1 : r0;
    const uint8_t* y = pl.y.data + b * pl.y.image + kRun * k;
    const uint4 y0 = __ldg(reinterpret_cast<const uint4*>(y + static_cast<long long>(r0) * pl.y.pitch));
    const uint4 y1 = __ldg(reinterpret_cast<const uint4*>(y + static_cast<long long>(r1) * pl.y.pitch));
    int cb0[kRun], cb1[kRun], cr0[kRun], cr1[kRun];
    if (kFancy) {
      fancy_run(pl.cb, b, i, kRun / 2 * k, dh, dw, cb0, cb1);
      fancy_run(pl.cr, b, i, kRun / 2 * k, dh, dw, cr0, cr1);
    } else {
      plain_run(pl.cb, b, r0, kRun * k, cb0);
      plain_run(pl.cb, b, r1, kRun * k, cb1);
      plain_run(pl.cr, b, r0, kRun * k, cr0);
      plain_run(pl.cr, b, r1, kRun * k, cr1);
    }
    rgb_run(y0, cb0, cr0, &st[0][3 * lane]);
    rgb_run(y1, cb1, cr1, &st[1][3 * lane]);
    dst = ((b * out_h + r0) * out_pitch + 3LL * kRun * k) | (two ? 1 : 0);
  }
  __syncwarp();
  // Chunk q of the warp's 96: byte 16 * (q % 3) of unit q / 3's run.
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int q = s * kWarp + lane;
    const int from = q / 3;
    const long long d = __shfl_sync(kAll, dst, from);
    if (d >= 0) {
      uint8_t* o = out + (d & ~15LL) + 16 * (q - 3 * from);
      *reinterpret_cast<uint4*>(o) = st[0][q];
      if (d & 1) *reinterpret_cast<uint4*>(o + out_pitch) = st[1][q];
    }
  }
}

// One upsampled chroma sample at output (r, c) of image b.
template <bool kFancy>
__device__ __forceinline__ int chroma_at(const Plane& p, long long b, int r, int c, int dh,
                                         int dw) {
  const uint8_t* img = p.data + b * p.image;
  if (!kFancy) return __ldg(img + static_cast<long long>(r) * p.pitch + c);
  const int i = r >> 1, j = c >> 1;
  const int fi = (r & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
  const int nj = (c & 1) ? (j + 1 < dw ? j + 1 : dw - 1) : (j > 0 ? j - 1 : 0);
  const uint8_t* near = img + static_cast<long long>(i) * p.pitch;
  const uint8_t* far = img + static_cast<long long>(fi) * p.pitch;
  const int cs = 3 * __ldg(near + j) + __ldg(far + j);
  const int ns = 3 * __ldg(near + nj) + __ldg(far + nj);
  return (3 * cs + ns + 8 - (c & 1)) >> 4;
}

// The any form: warp w takes output row w of the b * out_h, a pixel a lane.
template <bool kFancy>
__global__ void __launch_bounds__(kThreads)
    ycc_rows_any_kernel(const Planes pl, uint8_t* __restrict__ out, int rows, int out_h,
                        int out_w, int dh, int dw) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const long long b = row / out_h;
  const int r = row - static_cast<int>(b) * out_h;
  const uint8_t* y = pl.y.data + b * pl.y.image + static_cast<long long>(r) * pl.y.pitch;
  uint8_t* o = out + static_cast<long long>(row) * out_w * 3;
  for (int c = threadIdx.x & (kWarp - 1); c < out_w; c += kWarp) {
    uint32_t px[3];
    ycc_rgb(__ldg(y + c), chroma_at<kFancy>(pl.cb, b, r, c, dh, dw),
            chroma_at<kFancy>(pl.cr, b, r, c, dh, dw), px);
    o[3 * c] = static_cast<uint8_t>(px[0]);
    o[3 * c + 1] = static_cast<uint8_t>(px[1]);
    o[3 * c + 2] = static_cast<uint8_t>(px[2]);
  }
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <bool kFancy>
int launch(const Planes& pl, uint8_t* out, int b, int out_h, int out_w, int dh, int dw,
           cudaStream_t stream) {
  const int pairs = (out_h + 1) / 2;
  const int runs = out_w / kRun;
  const long long units = static_cast<long long>(b) * pairs * runs;
  const int cn = kFancy ? 8 : 16;  // a chroma load's bytes
  const bool vec = out_w % kRun == 0 && units <= INT_MAX && pl.y.pitch % 16 == 0 &&
                   pl.cb.pitch % cn == 0 && pl.cr.pitch % cn == 0 && aligned(pl.y.data, 16) &&
                   aligned(pl.cb.data, cn) && aligned(pl.cr.data, cn) && aligned(out, 16);
  if (vec) {
    const int blocks = static_cast<int>((units + kThreads - 1) / kThreads);
    ycc_rows_vec_kernel<kFancy><<<blocks, kThreads, 0, stream>>>(
        pl, out, static_cast<int>(units), runs, pairs, out_h, dh, dw, out_w * 3);
  } else {
    const int rows = b * out_h;
    ycc_rows_any_kernel<kFancy><<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock, kThreads, 0,
                                  stream>>>(pl, out, rows, out_h, out_w, dh, dw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: grids y (b, y_rows, y_pitch), cb (b, cb_rows, cb_pitch) and cr (b,
// cr_rows, cr_pitch) uint8 -> out (b, out_h, out_w * 3) uint8 interleaved
// RGB rows. fancy: each chroma plane, cropped to (dh, dw), takes the h2v2
// fancy upsample (2 * dh >= out_h, 2 * dw >= out_w); else the chroma planes
// are at the output's resolution (dh >= out_h, dw >= out_w). Launches on
// `stream`, does not synchronize and allocates nothing. Returns the
// cudaError_t as an int.
extern "C" int hipe_ycc_rows_u8(const void* y, const void* cb, const void* cr, void* out, int b,
                                int y_rows, int y_pitch, int cb_rows, int cb_pitch, int cr_rows,
                                int cr_pitch, int dh, int dw, int out_h, int out_w, int fancy,
                                void* stream) {
  const int f = fancy ? 2 : 1;
  const bool ok = b >= 1 && out_h >= 1 && out_w >= 1 && dh >= 1 && dw >= 1 &&
                  y_rows >= out_h && y_pitch >= out_w && cb_rows >= dh && cr_rows >= dh &&
                  cb_pitch >= dw && cr_pitch >= dw && f * dh >= out_h && f * dw >= out_w &&
                  static_cast<long long>(b) * out_h <= INT_MAX &&
                  static_cast<long long>(out_w) * 3 <= INT_MAX;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl{
      {static_cast<const uint8_t*>(y), static_cast<long long>(y_rows) * y_pitch, y_pitch},
      {static_cast<const uint8_t*>(cb), static_cast<long long>(cb_rows) * cb_pitch, cb_pitch},
      {static_cast<const uint8_t*>(cr), static_cast<long long>(cr_rows) * cr_pitch, cr_pitch}};
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint8_t*>(out);
  return fancy ? launch<true>(pl, o, b, out_h, out_w, dh, dw, s)
               : launch<false>(pl, o, b, out_h, out_w, dh, dw, s);
}
