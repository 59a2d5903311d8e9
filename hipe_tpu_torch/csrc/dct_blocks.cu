// K6 and K7: the islow DCT pair of the device JPEG codec, libjpeg's exact
// integer arithmetic over 8x8 blocks.
//
// Replaces these Pallas TPU kernels of hipe_tpu/ops/pallas_dct.py:
//   g. _idct_kernel (:72, dequant_idct_planes_pallas): dequantize by the
//      component's quant table, the 2-pass islow IDCT of jidctint.c (column
//      pass, then row pass, int32 with its wrap-around) and the range-limit
//      table of jdmaster.c, giving uint8 samples.
//   h. _fdct_kernel (:155, fdct_quantize_planes_pallas): level shift by -128,
//      the 2-pass islow fDCT of jcfdctint.c (row pass, then column pass) and
//      jcdct.c's round-half-away quantizer by q << 3, giving int16
//      coefficients in natural order.
// The TPU kernels work on 64 block-position planes with the block grid in
// the 128-lane axis. Here the layout is the card's: K6 reads (B, Hb, Wb, 64)
// int16 coefficients (the entropy decoder's own layout) and writes the
// component's sample grid (B, Hb*8, Wb*8) uint8 directly, fusing the TPU
// path's _grid_from_planes; K7 reads that grid and writes (B, Hb, Wb, 64).
//
// Integer semantics. The reference runs the IDCT in int32 and wraps there:
// coefficients of a corrupt or synthetic stream (+-32767, 16-bit tables up to
// 65535) overflow the products. Signed overflow and left shifts of negative
// values are undefined in C++, so every product, sum and << is done in
// uint32_t, which wraps modulo 2^32 exactly as int32 two's complement does,
// and only DESCALE's >> is an arithmetic shift of the signed value. The range
// limit is the wrap table's index arithmetic (val & 1023), not a clamp.
//
// What bounds them on an H100: device memory, with integer work close
// behind. One transcode pass over the 5000-image 256x256 4:2:0 stream moves
// 983 MB of int16 and 492 MB of uint8 through each kernel (0.44 ms at the
// data sheet's 3.35 TB/s). The two 1-D passes, the dequantize or quantize
// and the range limit cost 25.5 (K6) and 21.75 (K7) int32 operations a
// sample (counted in chip_smoke.py), 0.37 and 0.32 ms at the CUDA cores'
// peak (64 lanes x 132 SMs x 1.98 GHz, two operations an instruction at
// most), and more in instructions issued: the int8 tensor cores do not
// apply, as the products exceed 24 bits.
//
// What the design does about it (a first, simple design): 8 threads an 8x8
// block, 32 blocks a thread block. The first 1-D pass runs in registers on
// a column (K6) or a row (K7) a thread, one transpose goes through shared
// memory, and the second pass runs on a row or a column. K6 reads its
// column's 8 coefficients (neighbouring groups read neighbouring blocks, so
// the 128-byte blocks are read once through L1) and stores each output row
// as 8 bytes; K7 loads each input row as 8 bytes and stores each
// coefficient row as 16. The quant table travels by value as a kernel
// parameter and is staged in shared memory, once a thread block; nothing is
// copied a launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

// jidctint.c / jcfdctint.c fixed-point constants (CONST_BITS = 13).
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr uint32_t kF0298631336 = 2446;
constexpr uint32_t kF0390180644 = 3196;
constexpr uint32_t kF0541196100 = 4433;
constexpr uint32_t kF0765366865 = 6270;
constexpr uint32_t kF0899976223 = 7373;
constexpr uint32_t kF1175875602 = 9633;
constexpr uint32_t kF1501321110 = 12299;
constexpr uint32_t kF1847759065 = 15137;
constexpr uint32_t kF1961570560 = 16069;
constexpr uint32_t kF2053119869 = 16819;
constexpr uint32_t kF2562915447 = 20995;
constexpr uint32_t kF3072711026 = 25172;

struct QTable {
  uint32_t q[64];  // natural order, 1..65535
};

// DESCALE(x, n) of jpegint.h: round half up, then an arithmetic shift.
template <int N>
__device__ __forceinline__ int32_t descale(uint32_t x) {
  return static_cast<int32_t>(x + (1u << (N - 1))) >> N;
}

// One 8-point islow IDCT pass (jidctint.c), as hipe_tpu's _idct_1d.
template <int kShift>
__device__ __forceinline__ void idct_1d(const uint32_t d[8], int32_t out[8]) {
  uint32_t z2 = d[2], z3 = d[6];
  uint32_t z1 = (z2 + z3) * kF0541196100;
  const uint32_t t2 = z1 - z3 * kF1847759065;
  const uint32_t t3 = z1 + z2 * kF0765366865;
  z2 = d[0];
  z3 = d[4];
  const uint32_t t0 = (z2 + z3) << kConstBits;
  const uint32_t t1 = (z2 - z3) << kConstBits;
  const uint32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  uint32_t o0 = d[7], o1 = d[5], o2 = d[3], o3 = d[1];
  z1 = o0 + o3;
  z2 = o1 + o2;
  z3 = o0 + o2;
  uint32_t z4 = o1 + o3;
  const uint32_t z5 = (z3 + z4) * kF1175875602;
  o0 *= kF0298631336;
  o1 *= kF2053119869;
  o2 *= kF3072711026;
  o3 *= kF1501321110;
  z1 *= 0u - kF0899976223;
  z2 *= 0u - kF2562915447;
  z3 = z3 * (0u - kF1961570560) + z5;
  z4 = z4 * (0u - kF0390180644) + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;
  out[0] = descale<kShift>(t10 + o3);
  out[1] = descale<kShift>(t11 + o2);
  out[2] = descale<kShift>(t12 + o1);
  out[3] = descale<kShift>(t13 + o0);
  out[4] = descale<kShift>(t13 - o0);
  out[5] = descale<kShift>(t12 - o1);
  out[6] = descale<kShift>(t11 - o2);
  out[7] = descale<kShift>(t10 - o3);
}

// One 8-point islow forward-DCT pass (jcfdctint.c), as hipe_tpu's _fdct_1d.
template <bool kFinal>
__device__ __forceinline__ void fdct_1d(const uint32_t d[8], int32_t out[8]) {
  constexpr int kShift = kFinal ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
  const uint32_t t0 = d[0] + d[7], t7 = d[0] - d[7];
  const uint32_t t1 = d[1] + d[6], t6 = d[1] - d[6];
  const uint32_t t2 = d[2] + d[5], t5 = d[2] - d[5];
  const uint32_t t3 = d[3] + d[4], t4 = d[3] - d[4];
  const uint32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  if (kFinal) {
    out[0] = descale<kPass1Bits>(t10 + t11);
    out[4] = descale<kPass1Bits>(t10 - t11);
  } else {
    out[0] = static_cast<int32_t>((t10 + t11) << kPass1Bits);
    out[4] = static_cast<int32_t>((t10 - t11) << kPass1Bits);
  }
  uint32_t z1 = (t12 + t13) * kF0541196100;
  out[2] = descale<kShift>(z1 + t13 * kF0765366865);
  out[6] = descale<kShift>(z1 - t12 * kF1847759065);
  z1 = t4 + t7;
  uint32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  const uint32_t z5 = (z3 + z4) * kF1175875602;
  const uint32_t u4 = t4 * kF0298631336, u5 = t5 * kF2053119869;
  const uint32_t u6 = t6 * kF3072711026, u7 = t7 * kF1501321110;
  z1 *= 0u - kF0899976223;
  z2 *= 0u - kF2562915447;
  z3 = z3 * (0u - kF1961570560) + z5;
  z4 = z4 * (0u - kF0390180644) + z5;
  out[7] = descale<kShift>(u4 + z1 + z3);
  out[5] = descale<kShift>(u5 + z2 + z4);
  out[3] = descale<kShift>(u6 + z2 + z3);
  out[1] = descale<kShift>(u7 + z1 + z4);
}

// jdmaster.c's range-limit table, indexed by val & 1023.
__device__ __forceinline__ uint32_t range_limit(int32_t v) {
  const uint32_t m = static_cast<uint32_t>(v) & 1023u;
  return m < 128u ? m + 128u : m < 512u ? 255u : m < 896u ? 0u : m - 896u;
}

// K6. Block k of the (B, Hb, Wb) grid is k = (b * Hb + by) * Wb + bx; its
// output row r is grid row (b * Hb + by) * 8 + r, columns bx * 8 .. + 7.
__global__ void __launch_bounds__(kThreads)
    dequant_idct_kernel(const int16_t* __restrict__ coefs, uint8_t* __restrict__ out,
                        const QTable qt, int nblocks, int wb) {
  __shared__ uint32_t sq[64];
  __shared__ int32_t ws[kBlocksPerCta][8][9];  // +1 column: no bank conflicts
  if (threadIdx.x < 64) sq[threadIdx.x] = qt.q[threadIdx.x];
  __syncthreads();
  const int g = threadIdx.x >> 3;
  const int t = threadIdx.x & 7;
  const int blk = blockIdx.x * kBlocksPerCta + g;
  const bool live = blk < nblocks;
  if (live) {
    // Column pass on column t: dequantize, IDCT, descale by 11 bits.
    const int16_t* src = coefs + static_cast<size_t>(blk) * 64 + t;
    uint32_t d[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      d[r] = static_cast<uint32_t>(static_cast<int32_t>(__ldg(src + 8 * r))) * sq[8 * r + t];
    }
    int32_t col[8];
    idct_1d<kConstBits - kPass1Bits>(d, col);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[g][r][t] = col[r];
  }
  __syncthreads();
  if (!live) return;
  // Row pass on row t, descale by 18 bits, range limit, one 8-byte store.
  uint32_t d[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) d[c] = static_cast<uint32_t>(ws[g][t][c]);
  int32_t row[8];
  idct_1d<kConstBits + kPass1Bits + 3>(d, row);
  const uint32_t lo = range_limit(row[0]) | range_limit(row[1]) << 8 |
                      range_limit(row[2]) << 16 | range_limit(row[3]) << 24;
  const uint32_t hi = range_limit(row[4]) | range_limit(row[5]) << 8 |
                      range_limit(row[6]) << 16 | range_limit(row[7]) << 24;
  const int bx = blk % wb;
  const int band = blk / wb;  // b * Hb + by
  uint8_t* dst = out + (static_cast<size_t>(band) * 8 + t) * (static_cast<size_t>(wb) * 8) +
                 static_cast<size_t>(bx) * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// K7. The block layout of K6, the other way round.
__global__ void __launch_bounds__(kThreads)
    fdct_quantize_kernel(const uint8_t* __restrict__ grid, int16_t* __restrict__ coefs,
                         const QTable qt, int nblocks, int wb) {
  __shared__ uint32_t sqd[64];
  __shared__ int32_t ws[kBlocksPerCta][8][9];
  if (threadIdx.x < 64) sqd[threadIdx.x] = qt.q[threadIdx.x] << 3;  // jcdct.c divisors
  const int g = threadIdx.x >> 3;
  const int t = threadIdx.x & 7;
  const int blk = blockIdx.x * kBlocksPerCta + g;
  const bool live = blk < nblocks;
  if (live) {
    // Row pass on row t: one 8-byte load, level shift, fDCT.
    const int bx = blk % wb;
    const int band = blk / wb;
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
        grid + (static_cast<size_t>(band) * 8 + t) * (static_cast<size_t>(wb) * 8) +
        static_cast<size_t>(bx) * 8));
    uint32_t d[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[k] = ((v.x >> (8 * k)) & 255u) - 128u;
      d[k + 4] = ((v.y >> (8 * k)) & 255u) - 128u;
    }
    int32_t row[8];
    fdct_1d<false>(d, row);
#pragma unroll
    for (int c = 0; c < 8; ++c) ws[g][t][c] = row[c];
  }
  __syncthreads();
  if (live) {
    // Column pass on column t, then quantize: |x| + qd/2, divided by qd,
    // the sign put back. The thread rewrites the column it read.
    uint32_t d[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) d[r] = static_cast<uint32_t>(ws[g][r][t]);
    int32_t col[8];
    fdct_1d<true>(d, col);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t qd = sqd[8 * r + t];
      const uint32_t mag = static_cast<uint32_t>(col[r] < 0 ? -col[r] : col[r]);
      const int32_t v = static_cast<int32_t>((mag + (qd >> 1)) / qd);
      ws[g][r][t] = col[r] < 0 ? -v : v;
    }
  }
  __syncthreads();
  if (!live) return;
  // Row t of the block's coefficients: 8 int16, one 16-byte store.
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (static_cast<uint32_t>(ws[g][t][2 * k]) & 0xffffu) |
           static_cast<uint32_t>(ws[g][t][2 * k + 1]) << 16;
  }
  *reinterpret_cast<uint4*>(coefs + static_cast<size_t>(blk) * 64 + t * 8) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

bool make_table(const unsigned* qtable, QTable* qt) {
  for (int k = 0; k < 64; ++k) {
    if (qtable[k] < 1u || qtable[k] > 65535u) return false;
    qt->q[k] = qtable[k];
  }
  return true;
}

// Thread blocks for b * hb * wb 8x8 blocks, or 0 if the grid is out of range.
int ctas_for(int b, int hb, int wb) {
  if (b < 1 || hb < 1 || wb < 1) return 0;
  const long long n = static_cast<long long>(b) * hb * wb;
  if (n > INT_MAX || static_cast<long long>(wb) * 8 > INT_MAX) return 0;
  return static_cast<int>((n + kBlocksPerCta - 1) / kBlocksPerCta);
}

}  // namespace

// K6: coefs (b, hb, wb, 64) int16 and a (64,) quant table -> out (b, hb*8,
// wb*8) uint8. `out` 8-byte aligned. Launches on `stream`, does not
// synchronize and allocates nothing. Returns the cudaError_t as an int.
extern "C" int hipe_dequant_idct_s16(const void* coefs, void* out, const unsigned* qtable,
                                     int b, int hb, int wb, void* stream) {
  QTable qt;
  const int ctas = ctas_for(b, hb, wb);
  if (ctas == 0 || !make_table(qtable, &qt)) return static_cast<int>(cudaErrorInvalidValue);
  dequant_idct_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coefs), static_cast<uint8_t*>(out), qt, b * hb * wb, wb);
  return static_cast<int>(cudaGetLastError());
}

// K7: grid (b, hb*8, wb*8) uint8, 8-byte aligned, and a (64,) quant table ->
// coefs (b, hb, wb, 64) int16, 16-byte aligned. As K6 otherwise.
extern "C" int hipe_fdct_quantize_u8(const void* grid, void* coefs, const unsigned* qtable,
                                     int b, int hb, int wb, void* stream) {
  QTable qt;
  const int ctas = ctas_for(b, hb, wb);
  if (ctas == 0 || !make_table(qtable, &qt)) return static_cast<int>(cudaErrorInvalidValue);
  fdct_quantize_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<int16_t*>(coefs), qt, b * hb * wb, wb);
  return static_cast<int>(cudaGetLastError());
}
